"""Plain PyTorch versions of the port's kernels (the allclose reference).

The CPU path of ``kernels/ops.py`` runs these, and the on-card checks hold
each CUDA kernel against them on the same inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.transforms import banked_score_pipeline

NEG_INF = -1e30   # the finite mask value of the plain attention paths

# Banked Eq. 2: gathers by ``index_select``, the bucket as
# ``(a[:, None] >= qs).sum(-1)``, the four knots by ``gather``, the guard
# and clip by ``torch.where``/``clamp``.
score_pipeline_banked = banked_score_pipeline


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


__all__ = ["NEG_INF", "flash_attention", "score_pipeline_banked",
           "softmax_scale"]
