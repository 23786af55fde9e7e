"""Shared neural-net building blocks in PyTorch, numerically as the reference.

Parameters live in small ``nn.Module``s on an explicit device and dtype and
are drawn from a ``torch.Generator``.  ``Linear`` keeps its weight in
``nn.Linear`` order, (out, in); the functions cast each weight to the
activation's dtype on every call and normalise in float32, exactly where the
reference does, so the bfloat16 paths round at the same points.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def empty_param(shape, device, dtype) -> nn.Parameter:
    """An uninitialised, frozen parameter (the port serves; it does not
    train)."""
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


class Linear(nn.Module):
    """``y = x @ w (+ b)`` with ``weight`` stored as (out, in)."""

    def __init__(self, in_dim: int, out_dim: int, *, bias: bool = False,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.weight = empty_param((out_dim, in_dim), device, dtype)
        self.bias = empty_param((out_dim,), device, dtype) if bias else None

    def reset_parameters(self, gen: torch.Generator) -> None:
        # U(-1/sqrt(in), 1/sqrt(in)) weights, zero bias (the reference's init)
        scale = 1.0 / math.sqrt(self.weight.shape[1])
        self.weight.uniform_(-scale, scale, generator=gen)
        if self.bias is not None:
            self.bias.zero_()


class RMSNorm(nn.Module):
    def __init__(self, d: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.scale = empty_param((d,), device, dtype)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.scale.fill_(1.0)


class Embedding(nn.Module):
    def __init__(self, vocab: int, d: int, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.table = empty_param((vocab, d), device, dtype)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.table.normal_(0.0, 1.0, generator=gen).mul_(0.02)


class MLP(nn.Module):
    """SwiGLU feed-forward: ``down(silu(gate(x)) * up(x))``."""

    def __init__(self, d_model: int, d_ff: int, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.gate = Linear(d_model, d_ff, device=device, dtype=dtype)
        self.up = Linear(d_model, d_ff, device=device, dtype=dtype)
        self.down = Linear(d_ff, d_model, device=device, dtype=dtype)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for lin in (self.gate, self.up, self.down):
            lin.reset_parameters(gen)


def linear(params: Linear, x: torch.Tensor) -> torch.Tensor:
    y = F.linear(x, params.weight.to(x.dtype))
    if params.bias is not None:
        y = y + params.bias.to(x.dtype)
    return y


def _rms(scale: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(dtype)


def rmsnorm(params: RMSNorm, x: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    return _rms(params.scale, x, eps)


def rmsnorm_headwise(scale: torch.Tensor, x: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """qk-norm: RMSNorm over the head_dim axis of (..., heads, head_dim)."""
    return _rms(scale, x, eps)


def embed(params: Embedding, tokens: torch.Tensor,
          dtype=torch.bfloat16) -> torch.Tensor:
    return params.table.to(dtype)[tokens]


# ---------------------------------------------------------------------------
# Rotary position embeddings (standard + M-RoPE), rotate-half layout
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None
                     ) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                ) -> torch.Tensor:
    """positions (..., T) -> angles (..., T, head_dim/2)."""
    inv = rope_frequencies(head_dim, theta, positions.device)
    return positions[..., None].to(torch.float32) * inv


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: (B, T, H, D); angles: (B, T, D/2) or (T, D/2).  The first and
    second halves of D are rotated together (not interleaved pairs)."""
    dtype = x.dtype
    half = x.shape[-1] // 2
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    if angles.dim() == 2:  # (T, D/2) -> broadcast batch
        angles = angles[None]
    cos = torch.cos(angles)[..., None, :]  # (B, T, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2], dim=-1).to(dtype)


def mrope_angles(position_ids: torch.Tensor, head_dim: int, theta: float,
                 sections: tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE (arXiv:2409.12191).

    ``position_ids``: (3, B, T) temporal / height / width ids.  The rotary
    half-dim is cut into three contiguous sections that take their angle
    from the t/h/w id respectively; for text (t = h = w) it is plain RoPE.
    Returns angles (B, T, head_dim/2).
    """
    half = head_dim // 2
    assert sum(sections) == half, (sections, half)
    inv = rope_frequencies(head_dim, theta, position_ids.device)
    ang = position_ids[..., None].to(torch.float32) * inv  # (3, B, T, half)
    sec_idx = torch.repeat_interleave(
        torch.arange(3, device=position_ids.device),
        torch.tensor(sections, device=position_ids.device))  # (half,)
    ang = torch.movedim(ang, 0, -1)                          # (B, T, half, 3)
    idx = sec_idx.view(1, 1, half, 1).expand(*ang.shape[:3], 1)
    return torch.gather(ang, -1, idx)[..., 0]                # (B, T, half)


def text_position_ids(batch: int, seq: int, offset: int = 0,
                      device=None) -> torch.Tensor:
    """(3, B, T) position ids for text-only input (t = h = w)."""
    pos = torch.arange(seq, device=device)[None, :] + offset
    return pos.expand(batch, seq)[None].expand(3, batch, seq)


def mlp(params: MLP, x: torch.Tensor) -> torch.Tensor:
    g = F.silu(linear(params.gate, x))
    u = linear(params.up, x)
    return linear(params.down, g * u)
