"""Plain PyTorch versions of the port's kernels (the allclose reference).

The CPU path of ``kernels/ops.py`` runs these, and the on-card checks hold
each CUDA kernel against them on the same inputs:

* :func:`quantile_map` — T^Q alone (Eq. 4), for ``csrc/quantile_map.cu``;
* :func:`score_pipeline` — Eq. 2 with one shared parameter set, for
  ``csrc/score_pipeline.cu``;
* :func:`score_pipeline_banked` — Eq. 2 with a per-tenant bank, for
  ``csrc/score_pipeline_banked.cu``;
* :func:`flash_attention` — GQA prefill attention, for
  ``csrc/flash_attention.cu``;
* :func:`decode_attention` — one query position against a KV cache, for
  ``csrc/decode_attention.cu``;
* :func:`selective_scan` — the Mamba mixer's diagonal SSM scan, for
  ``csrc/selective_scan.cu``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import transforms
from repro_torch.core.transforms import banked_score_pipeline

NEG_INF = -1e30   # the finite mask value of the plain attention paths

# Banked Eq. 2: gathers by ``index_select``, the bucket as
# ``(a[:, None] >= qs).sum(-1)``, the four knots by ``gather``, the guard
# and clip by ``torch.where``/``clamp``.
score_pipeline_banked = banked_score_pipeline


def quantile_map(scores: torch.Tensor, src_q: torch.Tensor,
                 ref_q: torch.Tensor) -> torch.Tensor:
    """T^Q as the TPU kernel computes it: float32 math on float32 scores and
    tables, the result in the scores' dtype.  (The oracle
    ``core.transforms.quantile_map`` casts the tables to the scores' dtype
    instead, so on bfloat16 scores it maps through bfloat16 knots.)"""
    f32 = torch.float32
    out = transforms.quantile_map(scores.to(f32), src_q.to(f32), ref_q.to(f32))
    return out.to(scores.dtype)


def score_pipeline(expert_scores: torch.Tensor, betas: torch.Tensor,
                   weights: torch.Tensor, src_q: torch.Tensor,
                   ref_q: torch.Tensor) -> torch.Tensor:
    """Eq. 2 with one shared parameter set, (..., K) -> (...): float32 math,
    the result in the scores' dtype, as the TPU kernel."""
    f32 = torch.float32
    out = transforms.score_pipeline(
        expert_scores.to(f32), betas.to(f32), weights.to(f32),
        src_q.to(f32), ref_q.to(f32))
    return out.to(expert_scores.dtype)


def softmax_scale(d: int) -> float:
    """``1 / sqrt(d)`` rounded to float32 as the reference's
    ``1 / jnp.sqrt(f32(d))``; exact as a Python float, so multiplying a
    float32 tensor by it is the reference's product."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sliding_window: int = 0
                    ) -> torch.Tensor:
    """Naive exact attention. q: (B,Tq,Hq,D); k,v: (B,Tk,Hkv,D).

    float32 math; masked logits are the finite ``NEG_INF``, so a row that
    sees no key averages every value uniformly (the kernel gives 0 there).
    """
    b, tq, hq, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    qpk = hq // hkv
    qh = q.reshape(b, tq, hkv, qpk, d).to(torch.float32)
    scale = softmax_scale(d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qh,
                          k.to(torch.float32)) * scale
    qpos = torch.arange(tq, device=q.device)[:, None]
    kpos = torch.arange(tk, device=q.device)[None, :]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if sliding_window > 0:
        mask &= kpos > qpos - sliding_window
    logits = logits.masked_fill(~mask[None, None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.to(torch.float32))
    return out.reshape(b, tq, hq, d).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid_len) -> torch.Tensor:
    """q: (B, Hq, D); caches: (B, S, Hkv, D); attends to positions
    < valid_len (an int or a (B,) tensor) -> (B, Hq, D) in q's dtype.

    float32 math; masked logits are the finite ``NEG_INF``, so a row with
    no valid position averages every value uniformly (the kernel gives 0
    there).  A ``valid_len`` past S attends to all S positions.
    """
    b, hq, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    qpk = hq // hkv
    qh = q.reshape(b, hkv, qpk, d).to(torch.float32)
    logits = torch.einsum("bhgd,bshd->bhgs", qh,
                          k_cache.to(torch.float32)) * softmax_scale(d)
    valid = torch.as_tensor(valid_len, device=q.device)
    mask = torch.arange(s, device=q.device)[None, :] < valid[..., None]
    logits = logits.masked_fill(~mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", probs, v_cache.to(torch.float32))
    return out.reshape(b, hq, d).to(q.dtype)


SCAN_CHUNK = 64   # time steps whose decays the plain scan forms at once


def selective_scan(dt: torch.Tensor, x: torch.Tensor, b_mat: torch.Tensor,
                   c_mat: torch.Tensor, a: torch.Tensor,
                   h0: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The diagonal SSM recurrence, sequential in t, float32:

        h_t = exp(dt_t · A) · h_{t-1} + (dt_t · x_t) · Bm_t
        y_t = Σ_n h_t[..., n] · Cm_t[n]

    dt, x (B, T, C); b_mat, c_mat (B, T, N); a (C, N); h0 (B, C, N) or
    None for zeros -> (y (B, T, C), h_T (B, C, N)).  The decays and inputs
    of ``SCAN_CHUNK`` steps are formed at once (op for op the kernel's),
    the state then advances one step at a time as a product and a sum."""
    b, t, c = x.shape
    h = (torch.zeros((b, c, a.shape[1]), dtype=torch.float32,
                     device=x.device) if h0 is None else h0.clone())
    y = torch.empty_like(x)
    for s in range(0, t, SCAN_CHUNK):
        d = dt[:, s:s + SCAN_CHUNK]
        abar = torch.exp(d[..., None] * a)                  # (B, Q, C, N)
        bx = (d * x[:, s:s + SCAN_CHUNK])[..., None] \
            * b_mat[:, s:s + SCAN_CHUNK, None, :]
        hs = torch.empty_like(abar)
        for i in range(abar.shape[1]):
            h = torch.mul(abar[:, i], h, out=hs[:, i])
            h += bx[:, i]
        y[:, s:s + SCAN_CHUNK] = torch.sum(
            hs * c_mat[:, s:s + SCAN_CHUNK, None, :], dim=-1)
    return y, h.clone(memory_format=torch.contiguous_format)


__all__ = ["NEG_INF", "SCAN_CHUNK", "decode_attention", "flash_attention",
           "quantile_map", "score_pipeline", "score_pipeline_banked",
           "selective_scan", "softmax_scale"]
