"""Attention: GQA with RoPE / M-RoPE / qk-norm, chunked prefill,
sliding-window variants, and single-token decode over KV caches.

``_gqa_scores_chunked`` is exact attention looped over query chunks, so the
score block held at once is (B, C, H, T) instead of (B, T, H, T).  It is the
reference path of the prefill and the decode path.  With
``attn_impl="kernel"`` and at least 128 prompt tokens the prefill goes
through ``kernels.ops.flash_attention`` instead: the hand-written CUDA kernel
for CUDA tensors, its plain PyTorch version for CPU tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import NEG_INF, softmax_scale
from repro_torch.models import layers
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


def _qkv(params: Attention, x: torch.Tensor, cfg: ModelConfig, angles):
    b, t, _ = x.shape
    hd, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q = layers.linear(params.wq, x).reshape(b, t, hq, hd)
    k = layers.linear(params.wk, x).reshape(b, t, hkv, hd)
    v = layers.linear(params.wv, x).reshape(b, t, hkv, hd)
    if cfg.qk_norm:
        q = layers.rmsnorm_headwise(params.q_norm, q, cfg.norm_eps)
        k = layers.rmsnorm_headwise(params.k_norm, k, cfg.norm_eps)
    if angles is not None:
        q = layers.apply_rope(q, angles)
        k = layers.apply_rope(k, angles)
    return q, k, v


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
) -> tuple[torch.Tensor, KVCache | None]:
    """Unified attention entry point.

    * train / prefill: ``cache is None`` -> self-attention over x (the
      prefill cache is built by :func:`prefill_kv`).
    * decode: ``cache`` given, T == 1 -> write k/v at ``cache_pos`` (modulo
      the window for sliding-window layers) and attend over the cache.  The
      write goes into ``cache``'s tensors in place (the reference returns
      updated copies); the returned cache holds the same tensors.
    """
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, "
                         f"not {attn_impl!r}")
    b, t, _ = x.shape
    hd, hq = cfg.head_dim, cfg.n_heads
    q, k, v = _qkv(params, x, cfg, angles)

    if cache is None:
        if attn_impl == "kernel" and t >= 128:
            out = kops.flash_attention(
                q, k, v, causal=cfg.causal, sliding_window=cfg.sliding_window)
        else:
            out = _gqa_scores_chunked(
                q, k, v, causal=cfg.causal, q_offset=0,
                sliding_window=cfg.sliding_window, chunk=chunk)
        new_cache = None
    else:
        capacity = cache.k.shape[1]
        ring = cfg.sliding_window > 0 and capacity == cfg.sliding_window
        write_idx = cache_pos % capacity if ring else cache_pos
        # dynamic_update_slice semantics: the start is clamped so the
        # update fits inside the cache
        write_idx = min(max(write_idx, 0), capacity - t)
        cache.k[:, write_idx:write_idx + t] = k.to(cache.k.dtype)
        cache.v[:, write_idx:write_idx + t] = v.to(cache.v.dtype)
        new_cache = KVCache(k=cache.k, v=cache.v)
        # ring buffer: every slot valid once pos >= capacity; positions are
        # implicit (RoPE pre-applied), so validity is the only mask
        valid = min(cache_pos + 1, capacity) if ring else cache_pos + 1
        out = _gqa_scores_chunked(
            q, cache.k, cache.v, causal=False, q_offset=cache_pos,
            sliding_window=0, kv_valid_len=valid, chunk=chunk)

    out = out.reshape(b, t, hq * hd)
    return layers.linear(params.wo, out), new_cache


def prefill_kv(
    params: Attention,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    angles: torch.Tensor | None,
    capacity: int,
) -> KVCache:
    """Build a decode cache from a prompt (used by serve prefill)."""
    b, t, _ = x.shape
    hd, hkv = cfg.head_dim, cfg.n_kv_heads
    k = layers.linear(params.wk, x).reshape(b, t, hkv, hd)
    v = layers.linear(params.wv, x).reshape(b, t, hkv, hd)
    if cfg.qk_norm:
        k = layers.rmsnorm_headwise(params.k_norm, k, cfg.norm_eps)
    if angles is not None:
        k = layers.apply_rope(k, angles)
    if cfg.sliding_window > 0:
        w = min(cfg.sliding_window, capacity)
        orig_t = t
        k, v = k[:, -w:], v[:, -w:]
        t = k.shape[1]
        capacity = w
        if orig_t >= w:
            # Align the ring buffer so absolute position p sits at slot p % w:
            # token t-w+i must land at slot (t-w+i) % w = (i + t % w) % w.
            k = torch.roll(k, shifts=orig_t % w, dims=1)
            v = torch.roll(v, shifts=orig_t % w, dims=1)
    pad = capacity - t
    if pad > 0:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    return KVCache(k=k.contiguous(), v=v.contiguous())
