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
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import layers, transformer
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
            for mod in (self.embed, *self.stack, self.final_norm,
                        self.lm_head, self.score_head):
                if mod is not None:
                    mod.reset_parameters(gen)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    # -- shared pieces ---------------------------------------------------------
    def _embed_input(self, tokens, embeds, compute_dtype):
        if embeds is not None:
            return embeds.to(compute_dtype)
        return layers.embed(self.embed, tokens, compute_dtype)

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

    def _heads(self, h, compute_dtype, logits_mode: str = "all"):
        cfg = self.cfg
        h_norm = layers.rmsnorm(self.final_norm, h, cfg.norm_eps)
        h_lm = h_norm[:, -1:] if logits_mode == "last" else h_norm
        if cfg.tie_embeddings:
            logits = h_lm @ self.embed.table.to(compute_dtype).T
        else:
            logits = layers.linear(self.lm_head, h_lm)
        if cfg.score_head:
            # decoder: last-token hidden; encoder: mean pool
            pooled = (torch.mean(h_norm, dim=1) if cfg.is_encoder_only
                      else h_norm[:, -1])
            raw = layers.linear(self.score_head, pooled)[..., 0]
            score = torch.sigmoid(raw.to(torch.float32))
        else:
            score = torch.zeros(h.shape[0], dtype=torch.float32,
                                device=h.device)
        return logits, score, h_norm

    # -- full-sequence forward (eval / encoder serve) ------------------------
    @torch.no_grad()
    def forward(self, tokens: torch.Tensor | None = None,
                embeds: torch.Tensor | None = None, *,
                position_ids: torch.Tensor | None = None,
                remat: bool = False, compute_dtype=torch.bfloat16,
                attn_impl: str = "reference", logits_mode: str = "all",
                act_pspec=None) -> ModelOutput:
        x = self._embed_input(tokens, embeds, compute_dtype)
        b, t = x.shape[:2]
        angles = self._angles(b, t, 0, position_ids)
        x, _, aux = transformer.stack_forward(
            self.stack, x, self.cfg, angles=angles, mode="forward",
            remat=remat, attn_impl=attn_impl, act_pspec=act_pspec)
        logits, score, h = self._heads(x, compute_dtype, logits_mode)
        return ModelOutput(logits=logits, risk_score=score, moe_aux=aux,
                           hidden=h)

    # -- prefill: build decode caches from a prompt --------------------------
    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor | None = None,
                embeds: torch.Tensor | None = None, *, cache_capacity: int,
                position_ids: torch.Tensor | None = None,
                compute_dtype=torch.bfloat16, cache_dtype=torch.bfloat16,
                attn_impl: str = "reference", logits_mode: str = "all",
                act_pspec=None) -> tuple[ModelOutput, list]:
        """Like the reference, the returned cache holds the prompt's keys and
        values in ``compute_dtype``; ``cache_dtype`` only types the empty
        cache that gives the capacities."""
        cfg = self.cfg
        if not cfg.has_decode:
            raise ValueError(f"{cfg.name} is encoder-only: no decode/prefill")
        x = self._embed_input(tokens, embeds, compute_dtype)
        b, t = x.shape[:2]
        angles = self._angles(b, t, 0, position_ids)
        cache = self.init_cache(b, cache_capacity, cache_dtype)
        x, new_cache, aux = transformer.stack_forward(
            self.stack, x, cfg, angles=angles, mode="prefill", cache=cache,
            attn_impl=attn_impl, act_pspec=act_pspec)
        logits, score, h = self._heads(x, compute_dtype, logits_mode)
        return ModelOutput(logits, score, aux, h), new_cache

    # -- decode: one token against an existing cache -------------------------
    @torch.no_grad()
    def decode_step(self, cache: list, tokens: torch.Tensor | None = None,
                    embeds: torch.Tensor | None = None, *, pos: int,
                    position_ids: torch.Tensor | None = None,
                    compute_dtype=torch.bfloat16,
                    attn_impl: str = "reference",
                    act_pspec=None) -> DecodeOutput:
        """One token at absolute position ``pos``; writes its keys and
        values into ``cache`` in place and returns that cache."""
        cfg = self.cfg
        if not cfg.has_decode:
            raise ValueError(f"{cfg.name} is encoder-only: no decode step")
        x = self._embed_input(tokens, embeds, compute_dtype)
        b = x.shape[0]
        angles = self._angles(b, 1, pos, position_ids)
        x, new_cache, _ = transformer.stack_forward(
            self.stack, x, cfg, angles=angles, mode="decode", cache=cache,
            cache_pos=pos, attn_impl=attn_impl, act_pspec=act_pspec)
        logits, score, _ = self._heads(x, compute_dtype)
        return DecodeOutput(logits=logits[:, 0], risk_score=score,
                            cache=new_cache)

    # -- convenience ----------------------------------------------------------
    def init_cache(self, batch: int, capacity: int, dtype=torch.bfloat16):
        return transformer.init_cache(self.cfg, batch, capacity, dtype,
                                      device=self.device)

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())
