"""Model: config -> forward / prefill / decode_step entry points.

Every architecture exposes the same callables, which is what lets the
serving layer (predictors, routing) treat heterogeneous experts uniformly.
Outputs always include the **risk score head** (sigmoid scalar per
sequence): the raw expert score that MUSE's T^C -> A -> T^Q pipeline
consumes.

``Model(cfg)`` is an ``nn.Module`` whose weights are drawn on ``device``
(the card unless the caller asks for the CPU) from a ``torch.Generator``
seeded with ``seed``; ``seed=None`` leaves them uninitialised for a caller
that loads weights (``convert.model_from_numpy``).

Sharded by ``models/parallel.py::parallelize``, the same entry points run
one rank's share over its mesh: the lm head is column parallel, so the
logits come out vocab-sharded (``launch/dryrun.py::_logits_pspec``; a
vocabulary that does not divide is replicated), the score head runs on
the replicated pooled hidden state, ``prefill`` returns the rank's
block of the cache in ``launch/shardings.py::cache_pspec``'s layout, and
``decode_step`` takes that block back: flash-decoding over the rank's
slots (``models/attention.py``), its logits vocab-sharded as the
prefill's.  Each entry point takes the rank's rows of its batch over the
data axes; ``global_batch`` equal to the rows says they are the whole
batch, on every rank (``parallel.data_rows``, read by the MoE).

``act_pspec`` takes the reference's residual layouts
(``parallel.act_layout``).  The sequence-parallel one (train and
prefill) cuts a placed model's residual into the ranks' blocks of T: the
embedding is reduce-scattered over T (embeds in are cut to the block),
the blocks run on it (``transformer.stack_forward``), and the heads
gather T back, the whole of it for logits of every token, each rank's
last row for the last token's; ``ModelOutput.hidden`` is then the rank's
block.  The weight-stationary one (a decode step) keeps every row of
the batch at the rank's block of d over the data axes and contracts
each weight on its block in place (``_ws_decode_step``), so no weight
is gathered but the recurrent mixers' that never touch the residual
(``models/mamba.py``, ``models/xlstm.py``).  On a whole model either
changes nothing.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.launch import collectives as coll
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import MODEL_AXIS
from repro_torch.models import layers, parallel, transformer
from repro_torch.models.config import ModelConfig


class ModelOutput(NamedTuple):
    logits: torch.Tensor      # (B, T, vocab) — LM / frame-unit logits
    risk_score: torch.Tensor  # (B,) — raw expert score in [0, 1]
    moe_aux: torch.Tensor     # () — load-balance auxiliary loss
    hidden: torch.Tensor      # (B, T, d) final hidden states


class DecodeOutput(NamedTuple):
    logits: torch.Tensor      # (B, vocab) next-token logits
    risk_score: torch.Tensor  # (B,)
    cache: Any


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None,
                 dtype=torch.float32, seed: int | None = 0):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        kw = dict(device=dev, dtype=dtype)
        self.embed = layers.Embedding(cfg.vocab_size, cfg.d_model, **kw)
        self.stack = transformer.init_stack(cfg, **kw)
        self.final_norm = layers.RMSNorm(cfg.d_model, **kw)
        self.lm_head = None if cfg.tie_embeddings else layers.Linear(
            cfg.d_model, cfg.vocab_size, **kw)
        self.score_head = layers.Linear(cfg.d_model, 1, bias=True, **kw) \
            if cfg.score_head else None
        if seed is not None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            self.reset_parameters(gen)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """Draw every weight from ``gen`` (the reference's init scheme)."""
        for mod in (self.embed, *self.stack, self.final_norm, self.lm_head,
                    self.score_head):
            if mod is not None:
                mod.reset_parameters(gen)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    # -- shared pieces ---------------------------------------------------------
    def _embed_input(self, tokens, embeds, compute_dtype, seq=None):
        if embeds is not None:
            x = embeds.to(compute_dtype)
            return x if seq is None else coll.split(x, seq, MODEL_AXIS, 1)
        return layers.embed(self.embed, tokens, compute_dtype, seq=seq)

    def _angles(self, batch: int, seq: int, offset: int, position_ids):
        cfg = self.cfg
        if cfg.mrope:
            if position_ids is None:
                position_ids = layers.text_position_ids(batch, seq, offset,
                                                        self.device)
            return layers.mrope_angles(position_ids, cfg.head_dim,
                                       cfg.rope_theta, cfg.mrope_sections)
        pos = torch.arange(seq, device=self.device) + offset
        return layers.rope_angles(pos, cfg.head_dim, cfg.rope_theta)

    def _heads(self, h, compute_dtype, logits_mode: str = "all", seq=None):
        cfg = self.cfg
        h_norm = layers.rmsnorm(self.final_norm, h, cfg.norm_eps, seq=seq)
        lm, attr = ((self.embed, "table") if cfg.tie_embeddings
                    else (self.lm_head, "weight"))
        last = logits_mode == "last"
        if seq is None:
            h_lm = parallel.enter(h_norm[:, -1:] if last else h_norm, lm,
                                  attr)
            seen = h_norm
        else:
            # T back: whole, or each rank's last row (the last rank's is
            # the sequence's); an encoder pools over every row
            whole = not last or cfg.is_encoder_only
            seen = parallel.enter(h_norm if whole else h_norm[:, -1:], lm,
                                  attr, seq=seq)
            h_lm = seen[:, -1:] if last else seen
        if cfg.tie_embeddings:
            logits = h_lm @ parallel.weight(self.embed, "table").to(
                compute_dtype).T
        else:
            logits = layers.linear(self.lm_head, h_lm)
        if cfg.score_head:
            # decoder: last-token hidden; encoder: mean pool
            pooled = (torch.mean(seen, dim=1) if cfg.is_encoder_only
                      else seen[:, -1])
            if seq is not None and parallel.sharded_on_model(lm, attr, 0):
                # every rank pools alike beside the lm head's partial
                # cotangents, which the gather's backward sums
                pooled = coll.once(pooled, seq, MODEL_AXIS)
            raw = layers.linear(self.score_head, pooled)[..., 0]
            score = torch.sigmoid(raw.to(torch.float32))
        else:
            score = torch.zeros(h.shape[0], dtype=torch.float32,
                                device=h.device)
        return logits, score, h_norm

    # -- full-sequence forward (train / eval / encoder serve) ----------------
    def forward(self, tokens: torch.Tensor | None = None,
                embeds: torch.Tensor | None = None, *,
                position_ids: torch.Tensor | None = None,
                remat: bool = False, compute_dtype=torch.bfloat16,
                attn_impl: str = "reference", logits_mode: str = "all",
                act_pspec=None, global_batch: int | None = None
                ) -> ModelOutput:
        """The whole sequence, differentiable: it builds an autograd graph
        only where a parameter requires grad (a served model's do not; the
        trainer turns them on).  ``remat`` recomputes each group of
        ``len(cfg.layer_pattern)`` blocks in the backward."""
        seq = parallel.seq_mesh(self, act_pspec)
        b, t = (tokens if embeds is None else embeds).shape[:2]
        parallel.check_seq(t, seq)
        x = self._embed_input(tokens, embeds, compute_dtype, seq)
        angles = self._angles(b, t, 0, position_ids)
        x, _, aux = transformer.stack_forward(
            self.stack, x, self.cfg, angles=angles, mode="forward",
            remat=remat, attn_impl=attn_impl, global_batch=global_batch,
            seq=seq)
        logits, score, h = self._heads(x, compute_dtype, logits_mode, seq)
        return ModelOutput(logits=logits, risk_score=score, moe_aux=aux,
                           hidden=h)

    # -- prefill: build decode caches from a prompt --------------------------
    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor | None = None,
                embeds: torch.Tensor | None = None, *, cache_capacity: int,
                position_ids: torch.Tensor | None = None,
                compute_dtype=torch.bfloat16,
                attn_impl: str = "reference", logits_mode: str = "all",
                act_pspec=None, global_batch: int | None = None
                ) -> tuple[ModelOutput, list]:
        """Like the reference, the returned cache holds the prompt's keys and
        values in ``compute_dtype``.  The reference's ``cache_dtype`` only
        types the empty cache it builds to give the capacities; the port
        passes ``cache_capacity`` on instead, so it has no such keyword."""
        cfg = self.cfg
        if not cfg.has_decode:
            raise ValueError(f"{cfg.name} is encoder-only: no decode/prefill")
        seq = parallel.seq_mesh(self, act_pspec)
        b, t = (tokens if embeds is None else embeds).shape[:2]
        parallel.check_seq(t, seq)
        x = self._embed_input(tokens, embeds, compute_dtype, seq)
        angles = self._angles(b, t, 0, position_ids)
        x, new_cache, aux = transformer.stack_forward(
            self.stack, x, cfg, angles=angles, mode="prefill",
            attn_impl=attn_impl, capacity=cache_capacity,
            global_batch=global_batch, seq=seq)
        logits, score, h = self._heads(x, compute_dtype, logits_mode, seq)
        return ModelOutput(logits, score, aux, h), new_cache

    # -- decode: one token against an existing cache -------------------------
    @torch.no_grad()
    def decode_step(self, cache: list, tokens: torch.Tensor | None = None,
                    embeds: torch.Tensor | None = None, *, pos: int,
                    position_ids: torch.Tensor | None = None,
                    compute_dtype=torch.bfloat16,
                    attn_impl: str = "reference",
                    act_pspec=None,
                    cache_capacity: int | None = None,
                    global_batch: int | None = None) -> DecodeOutput:
        """One token at absolute position ``pos``; writes its keys and
        values into ``cache`` in place and returns that cache.  On a
        model sharded over several ranks of "model", ``cache_capacity``
        is the prefill's (the rank's block of the cache does not say
        it)."""
        cfg = self.cfg
        if not cfg.has_decode:
            raise ValueError(f"{cfg.name} is encoder-only: no decode step")
        ws = parallel.ws_mesh(self, act_pspec)
        if ws is not None:
            return self._ws_decode_step(cache, tokens, embeds, pos,
                                        position_ids, compute_dtype,
                                        cache_capacity, global_batch, ws)
        x = self._embed_input(tokens, embeds, compute_dtype)
        b = x.shape[0]
        angles = self._angles(b, 1, pos, position_ids)
        x, new_cache, _ = transformer.stack_forward(
            self.stack, x, cfg, angles=angles, mode="decode", cache=cache,
            cache_pos=pos, attn_impl=attn_impl, capacity=cache_capacity,
            global_batch=global_batch)
        logits, score, _ = self._heads(x, compute_dtype)
        return DecodeOutput(logits=logits[:, 0], risk_score=score,
                            cache=new_cache)

    def _ws_decode_step(self, cache, tokens, embeds, pos, position_ids,
                        compute_dtype, cache_capacity, global_batch, ws
                        ) -> DecodeOutput:
        """The weight-stationary decode (``parallel.ws_mesh``): the rows'
        tokens all-gathered over the data axes where the batch is cut
        there, every row embedded at the rank's block of d, the blocks
        (``transformer._ws_block``), the final norm and the heads on the
        rank's blocks of d with their partials summed over the data ranks
        (``layers.ws_in``), the rank's rows of the logits and scores
        returned.  No weight is gathered."""
        cfg = self.cfg
        rows = (tokens if embeds is None else embeds).shape[0]
        spread = parallel.data_rows(parallel.placement(self.embed), rows,
                                    global_batch)[1] > 1
        if embeds is not None:
            x = embeds.to(compute_dtype)
            if spread:
                x = parallel.gather_data(x, ws, 0)
            d = x.shape[-1] // mesh_lib.data_axis_size(ws)
            x = x.narrow(-1, parallel.data_index(ws) * d, d)
        else:
            if spread:
                tokens = parallel.gather_data(tokens, ws, 0)
            x = layers.embed_ws(self.embed, tokens, compute_dtype, ws)
        angles = self._angles(rows, 1, pos, position_ids)
        x, new_cache, _ = transformer.stack_forward(
            self.stack, x, cfg, angles=angles, mode="decode", cache=cache,
            cache_pos=pos, capacity=cache_capacity, ws=ws)
        h = layers.rmsnorm_ws(self.final_norm, x, cfg.norm_eps, ws)
        if cfg.tie_embeddings:
            w = parallel.d_block(self.embed, "table", 1).to(compute_dtype)
            logits = parallel.reduce_data(
                F.linear(h, w).to(torch.float32), ws).to(compute_dtype)
        else:
            logits, = layers.ws_in([self.lm_head], h, ws)
        j = parallel.data_index(ws) if spread else 0
        logits = logits[j * rows:(j + 1) * rows]
        if cfg.score_head:
            raw, = layers.ws_in([self.score_head], h[:, -1], ws)
            score = torch.sigmoid(raw[j * rows:(j + 1) * rows, 0].to(
                torch.float32))
        else:
            score = torch.zeros(rows, dtype=torch.float32, device=h.device)
        return DecodeOutput(logits=logits[:, 0], risk_score=score,
                            cache=new_cache)

    # -- convenience ----------------------------------------------------------
    def vocab_block(self) -> tuple[int, int] | None:
        """(first entry, entries) of the vocabulary this rank's logits
        hold, or None where they hold all of it."""
        if self.cfg.tie_embeddings:
            return parallel.vocab_block(self.embed, "table")
        return parallel.vocab_block(self.lm_head, "weight")

    def init_cache(self, batch: int, capacity: int, dtype=torch.bfloat16):
        """A zero decode cache; on a sharded model this rank's block of
        the cache of a global ``batch`` (``transformer.init_cache``)."""
        par = parallel.of(self)
        return transformer.init_cache(self.cfg, batch, capacity, dtype,
                                      device=self.device,
                                      mesh=None if par is None else par.mesh)

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())
