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
  ``csrc/selective_scan.cu``;
* :func:`selective_scan_backward` — its gradients, for
  ``csrc/selective_scan_bwd.cu``.
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
SCAN_BLOCK = 128  # channels of one block of the backward kernel
SCAN_QUARTER = 32  # channels one thread of that block sums in order


def selective_scan(dt: torch.Tensor, x: torch.Tensor, b_mat: torch.Tensor,
                   c_mat: torch.Tensor, a: torch.Tensor,
                   h0: torch.Tensor | None = None, *,
                   chunk_states: bool = False):
    """The diagonal SSM recurrence, sequential in t, float32:

        h_t = exp(dt_t · A) · h_{t-1} + (dt_t · x_t) · Bm_t
        y_t = Σ_n h_t[..., n] · Cm_t[n]

    dt, x (B, T, C); b_mat, c_mat (B, T, N); a (C, N); h0 (B, C, N) or
    None for zeros -> (y (B, T, C), h_T (B, C, N)), and with
    ``chunk_states`` third the state at the start of every ``SCAN_CHUNK``
    steps, (B, ceil(T / SCAN_CHUNK), C, N), as the kernel writes it.  The
    decays and inputs of ``SCAN_CHUNK`` steps are formed at once (op for op
    the kernel's), the state then advances one step at a time as a product
    and a sum.  Torch ops only, so autograd differentiates it (a test
    holds :func:`selective_scan_backward` to that)."""
    b, t, c = x.shape
    h = (torch.zeros((b, c, a.shape[1]), dtype=x.dtype, device=x.device)
         if h0 is None else h0)
    ys, starts = [], []
    for s in range(0, t, SCAN_CHUNK):
        starts.append(h)
        d = dt[:, s:s + SCAN_CHUNK]
        abar = torch.exp(d[..., None] * a)                  # (B, Q, C, N)
        bx = (d * x[:, s:s + SCAN_CHUNK])[..., None] \
            * b_mat[:, s:s + SCAN_CHUNK, None, :]
        hs = []
        for i in range(abar.shape[1]):
            h = abar[:, i] * h
            h = h + bx[:, i]
            hs.append(h)
        ys.append(torch.sum(torch.stack(hs, dim=1)
                            * c_mat[:, s:s + SCAN_CHUNK, None, :], dim=-1))
    y = torch.cat(ys, dim=1)
    h = h.clone(memory_format=torch.contiguous_format)
    if not chunk_states:
        return y, h
    return y, h, torch.stack(starts, dim=1)


def _sum_last(v: torch.Tensor) -> torch.Tensor:
    """Σ over the last axis in index order, one add at a time."""
    acc = v[..., 0]
    for j in range(1, v.shape[-1]):
        acc = acc + v[..., j]
    return acc


def _sum_channels(v: torch.Tensor) -> torch.Tensor:
    """(B, Q, C, N) -> (B, Q, N): Σ over C in the backward kernel's order:
    each quarter of ``SCAN_QUARTER`` channels in channel order, the four
    quarters of a ``SCAN_BLOCK``-channel block in order, then the blocks in
    order (channels past C count as 0, as the kernel's idle lanes)."""
    b, q, c, n = v.shape
    blocks = -(-c // SCAN_BLOCK)
    v = torch.nn.functional.pad(v, (0, 0, 0, blocks * SCAN_BLOCK - c))
    v = v.reshape(b, q, blocks, SCAN_BLOCK // SCAN_QUARTER, SCAN_QUARTER, n)
    quarters = _sum_last(v.movedim(-2, -1))          # (B, Q, blocks, 4, N)
    per_block = _sum_last(quarters.movedim(-2, -1))  # (B, Q, blocks, N)
    return _sum_last(per_block.movedim(-2, -1))


def selective_scan_backward(dt: torch.Tensor, x: torch.Tensor,
                            b_mat: torch.Tensor, c_mat: torch.Tensor,
                            a: torch.Tensor, chunks: torch.Tensor,
                            dy: torch.Tensor,
                            dh_t: torch.Tensor | None = None, *,
                            want_dh0: bool = False):
    """Gradients (ddt, dx, dBm, dCm, dA, dh0) of :func:`selective_scan`
    from ``dy`` (B, T, C) and ``dh_t`` (B, C, N; zeros when None), given
    the forward's inputs and its ``chunks`` (``chunk_states=True``); dh0
    is None unless ``want_dh0``.  Walking t from T-1 down to 0, with g_t
    the whole gradient into h_t and h_{-1} = h0:

        g_t = dy_t · Cm_t + abar_{t+1} · g_{t+1}   (dh_T in place of the
                                                    last term at T-1)
        dCm_t = Σ_c dy_t · h_t        dBm_t = Σ_c g_t · (dt_t · x_t)
        du_t = Σ_n g_t · Bm_t         q_t = (g_t · h_{t-1}) · abar_t
        ddt_t = du_t · x_t + Σ_n q_t · A      dx_t = du_t · dt_t
        dA = Σ_b Σ_t q_t · dt_t       dh0 = abar_0 · g_0

    Op for op ``csrc/selective_scan_bwd.cu``: each tile of ``SCAN_CHUNK``
    steps recomputed from its checkpoint as the forward ran it, every sum
    in the kernel's order (n in order; dA over t downwards, then over b in
    order; the channel sums by :func:`_sum_channels`)."""
    b, t, c = x.shape
    n = a.shape[1]
    carry = (torch.zeros((b, c, n), dtype=x.dtype, device=x.device)
             if dh_t is None else dh_t)
    da = torch.zeros((b, c, n), dtype=x.dtype, device=x.device)
    ddt, dx = torch.empty_like(x), torch.empty_like(x)
    d_bm = torch.empty((b, t, n), dtype=x.dtype, device=x.device)
    d_cm = torch.empty_like(d_bm)
    for k in reversed(range(chunks.shape[1])):
        s0 = k * SCAN_CHUNK
        s1 = min(t, s0 + SCAN_CHUNK)
        d, xx, gy = dt[:, s0:s1], x[:, s0:s1], dy[:, s0:s1]
        bm, cm = b_mat[:, s0:s1, None, :], c_mat[:, s0:s1, None, :]
        abar = torch.exp(d[..., None] * a)                  # (B, Q, C, N)
        u = d * xx
        bx = u[..., None] * bm
        h = chunks[:, k]
        hs = []
        for i in range(s1 - s0):
            h = abar[:, i] * h
            h = h + bx[:, i]
            hs.append(h)
        h_prev = torch.stack([chunks[:, k]] + hs[:-1], dim=1)
        hs = torch.stack(hs, dim=1)
        gs = [None] * (s1 - s0)
        for i in reversed(range(s1 - s0)):
            gs[i] = gy[:, i, :, None] * cm[:, i] + carry
            carry = abar[:, i] * gs[i]
        g = torch.stack(gs, dim=1)
        du = _sum_last(g * bm)
        q = (g * h_prev) * abar
        ddt[:, s0:s1] = du * xx + _sum_last(q * a)
        dx[:, s0:s1] = du * d
        for i in reversed(range(s1 - s0)):
            da = da + q[:, i] * d[:, i, :, None]
        d_cm[:, s0:s1] = _sum_channels(gy[..., None] * hs)
        d_bm[:, s0:s1] = _sum_channels(g * u[..., None])
    return (ddt, dx, d_bm, d_cm, _sum_last(da.movedim(0, -1)),
            carry if want_dh0 else None)


__all__ = ["NEG_INF", "SCAN_CHUNK", "decode_attention", "flash_attention",
           "quantile_map", "score_pipeline", "score_pipeline_banked",
           "selective_scan", "selective_scan_backward", "softmax_scale"]
