"""Attention: GQA with RoPE / M-RoPE / qk-norm, chunked prefill,
sliding-window variants, and single-token decode over KV caches.

``_gqa_scores_chunked`` is exact attention looped over query chunks, so the
score block held at once is (B, C, H, T) instead of (B, T, H, T).  It is the
reference path of the prefill (the reference's decode path too; its
``kv_valid_len`` mask is the one the port's decode keeps).  With
``attn_impl="kernel"`` and at least 128 prompt tokens the prefill goes
through ``kernels.ops.flash_attention`` instead: the hand-written CUDA kernel
for CUDA tensors, its plain PyTorch version for CPU tensors.

The full-sequence attention (train, eval, prefill) reads the placement of
its projections, as the layers do.  On a model sharded by
``models/parallel.py`` the projections run on the rank's column blocks,
which the production rules cut without regard to heads.  Per-head qk-norm
and rotate-half RoPE need whole heads, so the rank moves to the whole
heads that cover its q columns (``parallel.head_plan``): it all-gathers q
over "model" where its q columns are not whole heads, and the keys and
values where its kv columns are not exactly the heads its q heads use.  It
attends over those heads (the flash kernel on the card), keeps its own
columns of the output and runs the row-parallel wo.  A head on the
boundary of two ranks' q columns is computed by both.  Without a
placement every head is the rank's and nothing is exchanged.  The prefill
cache is built from the keys and values the attention used.

The decode (:func:`_decode`, one for whole and placed models) is
flash-decoding over the cache's sequence on "model": one
all-gather brings the new token's q, k and v columns whole, the rank
that holds the token's slot writes it, each rank attends over its own
slots in float32 under :func:`_gqa_scores_chunked`'s validity mask,
mapped onto global slot numbers, and the partials are combined over
"model" by two all-reduces: the largest logit, then the weighted values
beside the sum of exponentials, each rank's taken against that one
largest logit.  The rank keeps its own output columns for the
row-parallel wo.  A whole model runs the same math over the whole cache,
with nothing exchanged.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import NEG_INF, softmax_scale
from repro_torch.launch import collectives as coll
from repro_torch.launch.mesh import MODEL_AXIS
from repro_torch.models import layers, parallel
from repro_torch.models.config import ModelConfig

ATTN_IMPLS = ("reference", "kernel")


class KVCache(NamedTuple):
    """Per-attention-layer cache.

    ``k``/``v``: (B, S, n_kv, head_dim) where S is the capacity — the full
    sequence for dense decode, or the window size for sliding-window decode
    (ring buffer, RoPE pre-applied at absolute positions before writing).
    """

    k: torch.Tensor
    v: torch.Tensor


class Attention(nn.Module):
    """The parameters the reference's ``init_attention`` returns: q/k/v/o
    projections and, with qk-norm, the per-head q and k norm scales."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim
        kw = dict(device=device, dtype=dtype)
        self.wq = layers.Linear(d, cfg.n_heads * hd, **kw)
        self.wk = layers.Linear(d, cfg.n_kv_heads * hd, **kw)
        self.wv = layers.Linear(d, cfg.n_kv_heads * hd, **kw)
        self.wo = layers.Linear(cfg.n_heads * hd, d, **kw)
        self.q_norm = self.k_norm = None
        if cfg.qk_norm:
            self.q_norm = layers.empty_param((hd,), device, dtype)
            self.k_norm = layers.empty_param((hd,), device, dtype)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for lin in (self.wq, self.wk, self.wv, self.wo):
            lin.reset_parameters(gen)
        if self.q_norm is not None:
            self.q_norm.fill_(1.0)
            self.k_norm.fill_(1.0)


def _gqa_scores_chunked(
    q: torch.Tensor,     # (B, Tq, Hq, D)
    k: torch.Tensor,     # (B, Tk, Hkv, D)
    v: torch.Tensor,     # (B, Tk, Hkv, D)
    *,
    causal: bool,
    q_offset: int,
    sliding_window: int,
    kv_valid_len: int | None = None,
    chunk: int = 256,
) -> torch.Tensor:
    """Exact attention, looped over query chunks. Returns (B, Tq, Hq, D)."""
    b, tq, hq, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    qpk = hq // hkv
    scale = softmax_scale(d)
    chunk = min(chunk, tq)
    n_chunks = -(-tq // chunk)
    kpos = torch.arange(tk, device=q.device)
    k32, v32 = k.to(torch.float32), v.to(torch.float32)
    outs = []
    for ci in range(n_chunks):
        q_blk = q[:, ci * chunk:(ci + 1) * chunk]
        c = q_blk.shape[1]
        q_blk = q_blk.reshape(b, c, hkv, qpk, d)
        logits = torch.einsum("bchgd,bthd->bchgt", q_blk.to(torch.float32),
                              k32) * scale
        qpos = q_offset + ci * chunk + torch.arange(c, device=q.device)
        mask = torch.ones((c, tk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= qpos[:, None] >= kpos[None, :]
        if sliding_window > 0:
            mask &= kpos[None, :] > qpos[:, None] - sliding_window
        if kv_valid_len is not None:
            mask &= kpos[None, :] < kv_valid_len
        logits = logits.masked_fill(~mask[None, :, None, None, :], NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bchgt,bthd->bchgd", probs, v32)
        outs.append(out.to(q.dtype).reshape(b, c, hq, d))
    return torch.cat(outs, dim=1)


def attention_forward(
    params: Attention,
    x: torch.Tensor,              # (B, T, d_model)
    cfg: ModelConfig,
    *,
    angles: torch.Tensor | None,  # (B, T, head_dim/2) or (T, head_dim/2)
    cache: KVCache | None = None,
    cache_pos: int = 0,           # absolute position of x[:, 0]
    chunk: int = 256,
    attn_impl: str = "reference",
    capacity: int | None = None,
    seq=None,
    ws=None,
) -> tuple[torch.Tensor, KVCache | None]:
    """Unified attention entry point.  ``seq``: the mesh of a
    sequence-parallel residual, x the rank's block of T (train and
    prefill only; ``parallel.act_layout``).

    * train / prefill: ``cache is None`` -> self-attention over x
      (:func:`_self_attention`); with ``capacity``, the prefill cache of
      that capacity is built from the same keys and values.
    * decode: ``cache`` given, T == 1 -> write k/v at ``cache_pos`` (modulo
      the window for sliding-window layers) and attend over the cache.  The
      write goes into ``cache``'s tensors in place (the reference returns
      updated copies); the returned cache holds the same tensors.  On a
      placed model the cache is the rank's block (:func:`_decode`) and
      ``capacity`` the capacity the cache was built with, which a mesh of
      several ranks of "model" needs (the block does not say).
    """
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, "
                         f"not {attn_impl!r}")
    if cache is None:
        return _self_attention(params, x, cfg, angles=angles, chunk=chunk,
                               attn_impl=attn_impl, capacity=capacity,
                               seq=seq)
    return _decode(params, x, cfg, angles=angles, cache=cache,
                   cache_pos=cache_pos, capacity=capacity, ws=ws)


def _self_attention(params: Attention, x: torch.Tensor, cfg: ModelConfig,
                    *, angles, chunk: int, attn_impl: str,
                    capacity: int | None, seq=None
                    ) -> tuple[torch.Tensor, KVCache | None]:
    """Attention over the whole sequence, on the rank's heads of a sharded
    model (``parallel.head_plan``; without a placement every head is the
    rank's and nothing is exchanged): the output (B, T, d) after wo (the
    row-parallel wo's all-reduce on a sharded model) and, with
    ``capacity``, the prefill cache (:func:`_prefill_cache`).  With
    ``seq`` x is the rank's block of T: all-gathered over "model" at
    entry, wo's output reduce-scattered back to the block."""
    pl = parallel.placement(params.wq)
    m, r = (1, 0) if pl is None else (pl.model_size, pl.model_rank)
    # the rules put every projection's columns on "model" wherever they
    # divide, which head_plan requires
    plan = parallel.head_plan(cfg, m, r)
    x = parallel.enter(x, params.wq, seq=seq)
    b, t, _ = x.shape
    hd = cfg.head_dim
    (q_lo, nq), (kv_lo, nk) = plan.q_heads, plan.kv_heads
    q = layers.linear(params.wq, x)
    k = layers.linear(params.wk, x)
    v = layers.linear(params.wv, x)
    if plan.gather_q:
        q = coll.all_gather(q, pl.mesh, MODEL_AXIS, 2)[
            ..., q_lo * hd:(q_lo + nq) * hd]
    if plan.gather_kv:
        k = coll.all_gather(k, pl.mesh, MODEL_AXIS, 2)
        v = coll.all_gather(v, pl.mesh, MODEL_AXIS, 2)
    q = q.reshape(b, t, nq, hd)
    k = k.reshape(b, t, -1, hd)
    v = v.reshape(b, t, -1, hd)
    if cfg.qk_norm:
        q_scale, k_scale = params.q_norm, params.k_norm
        if pl is not None:
            # the scales are replicated and each rank uses them on its
            # heads: their gradient is the sum over the ranks ("f")
            q_scale = coll.copy_to(q_scale, pl.mesh, MODEL_AXIS)
            k_scale = coll.copy_to(k_scale, pl.mesh, MODEL_AXIS)
        q = layers.rmsnorm_headwise(q_scale, q, cfg.norm_eps)
        k = layers.rmsnorm_headwise(k_scale, k, cfg.norm_eps)
    if angles is not None:
        q = layers.apply_rope(q, angles)
        k = layers.apply_rope(k, angles)
    new_cache = None
    if capacity is not None:
        new_cache = KVCache(_prefill_cache(k, cfg, capacity, plan, pl),
                            _prefill_cache(v, cfg, capacity, plan, pl))
    if plan.gather_kv:
        k, v = k[:, :, kv_lo:kv_lo + nk], v[:, :, kv_lo:kv_lo + nk]
    if attn_impl == "kernel" and t >= 128:
        out = kops.flash_attention(q, k, v, causal=cfg.causal,
                                   sliding_window=cfg.sliding_window)
    else:
        out = _gqa_scores_chunked(q, k, v, causal=cfg.causal, q_offset=0,
                                  sliding_window=cfg.sliding_window,
                                  chunk=chunk)
    start, cols = plan.q_cols
    out = out.reshape(b, t, nq * hd)[..., start - q_lo * hd:
                                     start - q_lo * hd + cols]
    return layers.linear(params.wo, out, seq=seq), new_cache


def _prefill_cache(kv: torch.Tensor, cfg: ModelConfig, capacity: int,
                   plan: parallel.HeadPlan, pl) -> torch.Tensor:
    """(B, T, heads, D) keys or values -> the rank's block of the
    (B, capacity, Hkv, D) decode cache.

    A sliding-window layer keeps the last w = min(window, capacity)
    tokens in a ring aligned so that absolute position p sits at slot
    p % w.  Over more than one rank of "model" the block is
    ``launch/shardings.py::cache_pspec``'s: the sequence on "model" where
    it divides.  ``kv`` holds every head (gathered) or the rank's own
    whole heads; the latter are exchanged by an all-to-all over "model"
    (all-gathered where the capacity does not divide)."""
    b, t, h, d = kv.shape
    if cfg.sliding_window > 0:
        capacity = min(cfg.sliding_window, capacity)
        if t >= capacity:
            # token t-w+i lands at slot (t-w+i) % w = (i + t % w) % w
            kv = torch.roll(kv[:, t - capacity:], shifts=t % capacity,
                            dims=1)
    if capacity > kv.shape[1]:
        kv = torch.nn.functional.pad(
            kv, (0, 0, 0, 0, 0, capacity - kv.shape[1]))
    m = 1 if pl is None else pl.model_size
    if m == 1:
        return kv.contiguous()
    r, mesh = pl.model_rank, pl.mesh
    split = capacity % m == 0
    if plan.gather_kv:
        if not split:
            return kv.contiguous()
        s = capacity // m
        return kv[:, r * s:(r + 1) * s].contiguous()
    if not split:
        return coll.all_gather_raw(kv, mesh, MODEL_AXIS, 2)
    s = capacity // m
    # (m, B, S/m, h, D): chunk j of the sequence to rank j; back come the
    # ranks' heads of this rank's chunk, in rank order
    out = coll.all_to_all_raw(
        kv.reshape(b, m, s, h, d).movedim(1, 0).contiguous(), mesh,
        MODEL_AXIS)
    return out.movedim(0, 2).reshape(b, s, m * h, d)


def _decode(params: Attention, x: torch.Tensor, cfg: ModelConfig, *,
            angles, cache: KVCache, cache_pos: int, capacity: int | None,
            ws=None) -> tuple[torch.Tensor, KVCache]:
    """The new token's attention over the cache, written at ``cache_pos``
    (modulo the window on the ring, clamped as ``dynamic_update_slice``
    clamps), in float32 as flash-decoding: the max, the sum of
    exponentials and the weighted values over the slots, then their
    quotient.  On a placed model the cache is the rank's block
    (``parallel.cache_plan``): see the module's docstring.  A whole model
    is one rank with nothing exchanged, so at one rank of "model" (every
    collective a copy) the placed decode is the whole model's to the
    last bit.  Against the reference's softmax-then-values the order
    differs by float32 rounding.  Under the weight-stationary layout
    (``ws``) x is every row of the batch at the rank's block of d: q, k
    and v come from the weights' blocks of d (``layers.ws_in``), the
    rank keeps its rows (the cache's) for the attention, and the output
    rows are all-gathered over the data axes for wo (``layers.ws_out``):
    rows move, no weight does."""
    pl = parallel.placement(params.wq)
    m, r = (1, 0) if pl is None else (pl.model_size, pl.model_rank)
    hd, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    plan = parallel.head_plan(cfg, m, r)
    if capacity is None:
        if m > 1:
            raise ValueError("the decode of a model sharded over several "
                             "ranks of 'model' needs the cache's capacity")
        capacity = cache.k.shape[1]
    elif cfg.sliding_window > 0:
        capacity = min(capacity, cfg.sliding_window)
    slots = parallel.cache_plan(capacity, m, r)
    if cache.k.shape[1] != slots.held[1]:
        raise ValueError(f"the rank holds {cache.k.shape[1]} slots of a "
                         f"capacity of {capacity}, its plan {slots.held[1]}")
    if ws is None:
        q = layers.linear(params.wq, x)
        k = layers.linear(params.wk, x)
        v = layers.linear(params.wv, x)
    else:
        q, k, v = (parallel.ws_rows(a, cache.k.shape[0], ws)
                   for a in layers.ws_in([params.wq, params.wk, params.wv],
                                         x, ws))
    b, t, _ = q.shape
    if pl is not None:
        # the token's q, k and v columns of every rank, in one gather
        full = coll.all_gather_raw(torch.cat([q, k, v], dim=-1)[None],
                                   pl.mesh, MODEL_AXIS, 0)
        cq, ck = hq * hd // m, hkv * hd // m
        q, k, v = (full[..., lo:lo + cols].movedim(0, -2).reshape(b, t, -1)
                   for lo, cols in ((0, cq), (cq, ck), (cq + ck, ck)))
    q = q.reshape(b, t, hq, hd)
    k = k.reshape(b, t, hkv, hd)
    v = v.reshape(b, t, hkv, hd)
    if cfg.qk_norm:
        q = layers.rmsnorm_headwise(params.q_norm, q, cfg.norm_eps)
        k = layers.rmsnorm_headwise(params.k_norm, k, cfg.norm_eps)
    if angles is not None:
        q = layers.apply_rope(q, angles)
        k = layers.apply_rope(k, angles)
    ring = cfg.sliding_window > 0 and capacity == cfg.sliding_window
    write = cache_pos % capacity if ring else cache_pos
    write = min(max(write, 0), capacity - t)
    (h_lo, h_n), (a_lo, a_n) = slots.held, slots.attended
    lo, hi = max(write, h_lo), min(write + t, h_lo + h_n)
    if lo < hi:                      # only the rank that holds the slots
        cache.k[:, lo - h_lo:hi - h_lo] = k[:, lo - write:hi - write].to(
            cache.k.dtype)
        cache.v[:, lo - h_lo:hi - h_lo] = v[:, lo - write:hi - write].to(
            cache.v.dtype)
    # ring buffer: every slot valid once pos >= capacity; positions are
    # implicit (RoPE pre-applied), so validity is the only mask
    valid = min(cache_pos + 1, capacity) if ring else cache_pos + 1
    kk = cache.k[:, a_lo - h_lo:a_lo - h_lo + a_n].to(torch.float32)
    vv = cache.v[:, a_lo - h_lo:a_lo - h_lo + a_n].to(torch.float32)
    qg = q.reshape(b, t, hkv, hq // hkv, hd).to(torch.float32)
    logits = torch.einsum("bchgd,bthd->bchgt", qg, kk) * softmax_scale(hd)
    mask = torch.arange(a_lo, a_lo + a_n, device=q.device) < valid
    logits = logits.masked_fill(~mask, float("-inf"))
    mx = torch.amax(logits, dim=-1, keepdim=True)
    if pl is not None:
        # the largest logit over every rank's slots, finite as slot 0 is
        # valid: a rank with no valid slot adds exp(-inf) = 0 below
        mx = coll.all_reduce_raw(mx, pl.mesh, MODEL_AXIS, "max")
    p = torch.exp(logits - mx)
    acc = torch.cat([torch.einsum("bchgt,bthd->bchgd", p, vv),
                     p.sum(dim=-1, keepdim=True)], dim=-1)
    if pl is not None:
        acc = coll.all_reduce_raw(acc, pl.mesh, MODEL_AXIS)
    out = acc[..., :hd] / acc[..., hd:]
    out = out.to(q.dtype).reshape(b, t, hq * hd)
    start, cols = plan.q_cols
    out = out[..., start:start + cols]
    if ws is not None:
        out = parallel.ws_all_rows(out, x.shape[0], ws)
        return layers.ws_out(params.wo, out, ws), KVCache(k=cache.k,
                                                          v=cache.v)
    return layers.linear(params.wo, out), KVCache(k=cache.k, v=cache.v)
