"""Shared neural-net building blocks in PyTorch, numerically as the reference.

Parameters live in small ``nn.Module``s on an explicit device and dtype and
are drawn from a ``torch.Generator``.  ``Linear`` keeps its weight in
``nn.Linear`` order, (out, in); the functions cast each weight to the
activation's dtype on every call and normalise in float32, exactly where the
reference does, so the bfloat16 paths round at the same points.

On a model sharded by ``models/parallel.py`` the same functions run the
rank's blocks: :func:`linear` is column parallel (its output the rank's
columns) or row parallel (one all-reduce over "model" of its partial
output), :func:`embed` is vocab-parallel and :func:`mlp` is column,
column, row.  FSDP'd weights are
all-gathered over the data axes just before use.  With ``seq`` (the
mesh of a sequence-parallel residual, ``parallel.act_layout``) a
block's closing row-parallel all-reduce is a reduce-scatter over the
sequence, the embedding's too, and a norm's scale takes Megatron's "f"
(its gradient is the sum of the ranks' blocks of tokens).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.launch import collectives as coll
from repro_torch.launch.mesh import MODEL_AXIS
from repro_torch.models import parallel


def empty_param(shape, device, dtype) -> nn.Parameter:
    """An uninitialised parameter created frozen, so that a served model
    builds no autograd graph; a trainer turns it on
    (``model.requires_grad_(True)``, ``training/train.py``)."""
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


@contextlib.contextmanager
def parameters_as(module: nn.Module, tensors: dict[str, torch.Tensor]):
    """Run with the parameters of ``module`` named in ``tensors`` (names as
    ``module.named_parameters()`` gives them) replaced by those tensors,
    restored on exit.  The training step runs the model on bf16 casts of
    its float32 masters this way (``cast_params_bf16``), and each remat
    group swaps in the very tensors its first forward ran on when autograd
    recomputes it."""
    saved = []
    try:
        for name, tensor in tensors.items():
            owner_name, _, attr = name.rpartition(".")
            owner = module.get_submodule(owner_name)
            saved.append((owner, attr, owner._parameters[attr]))
            owner._parameters[attr] = tensor
        yield
    finally:
        for owner, attr, param in reversed(saved):
            owner._parameters[attr] = param


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


def linear(params: Linear, x: torch.Tensor, seq=None) -> torch.Tensor:
    """``x @ w (+ b)``.  Sharded, a column-parallel weight gives the
    rank's output columns (its input entered through ``parallel.enter``
    by the caller) and a row-parallel one takes the rank's input columns
    and all-reduces its partial output over "model".  The rules keep a
    bias whole: beside a column-parallel weight the rank adds its
    columns' block of it (``parallel.rank_block``), beside a row-parallel
    one it is added once, after the all-reduce.  With ``seq`` (the
    layer closes a block of a sequence-parallel residual, x of shape
    (B, T, ·)) the all-reduce is a reduce-scatter over T, and a layer
    the rules keep whole gives the rank's block of T of its output."""
    pl = parallel.placement(params)
    y = F.linear(x, parallel.weight(params, "weight").to(x.dtype))
    row = parallel.sharded_on_model(params, "weight", 1)
    if row and seq is not None:
        y = coll.reduce_scatter(y, pl.mesh, MODEL_AXIS, 1)
    elif row:
        y = coll.all_reduce(y, pl.mesh, MODEL_AXIS)
    elif seq is not None:
        y = coll.split(y, seq, MODEL_AXIS, 1)
    if params.bias is not None:
        block = None
        if parallel.sharded_on_model(params, "weight", 0):
            n = params.weight.shape[0]
            block = (pl.model_rank * n, n)
        y = y + parallel.rank_block(params, "bias", 0, block).to(x.dtype)
    return y


def ws_in(params: list[Linear], x: torch.Tensor, ws) -> list[torch.Tensor]:
    """Under the weight-stationary decode (``ws`` the mesh; x the rows'
    block of d over the data axes): each linear of ``params`` on the
    rank's block of its input d (``parallel.d_block``, no weight
    gathered), the partial outputs summed over the data ranks in one
    float32 all-reduce an axis, then cast back and the biases added as
    :func:`linear` adds them."""
    ys = [F.linear(x, parallel.d_block(lin, "weight", 1).to(x.dtype))
          for lin in params]
    sizes = [y.shape[-1] for y in ys]
    summed = parallel.reduce_data(torch.cat(ys, dim=-1).to(torch.float32),
                                  ws).to(x.dtype)
    out = []
    for lin, y in zip(params, torch.split(summed, sizes, dim=-1)):
        if lin.bias is not None:
            block = None
            if parallel.sharded_on_model(lin, "weight", 0):
                pl = parallel.placement(lin)
                n = lin.weight.shape[0]
                block = (pl.model_rank * n, n)
            y = y + parallel.rank_block(lin, "bias", 0, block).to(x.dtype)
        out.append(y)
    return out


def ws_out(params: Linear, x: torch.Tensor, ws) -> torch.Tensor:
    """Under the weight-stationary decode, a linear whose output is the
    residual's d: the rank's rows of the weight at its block of d
    (``parallel.d_block``), its row-parallel partial all-reduced over
    "model"; the bias (whole under the rules) at the block of d."""
    pl = parallel.placement(params)
    y = F.linear(x, parallel.d_block(params, "weight", 0).to(x.dtype))
    if parallel.sharded_on_model(params, "weight", 1):
        y = coll.all_reduce_raw(y, pl.mesh, MODEL_AXIS)
    if params.bias is not None:
        n = y.shape[-1]
        y = y + params.bias.narrow(0, parallel.data_index(ws) * n, n).to(
            x.dtype)
    return y


def rmsnorm_ws(params: RMSNorm, x: torch.Tensor, eps: float, ws
               ) -> torch.Tensor:
    """RMSNorm of the rows' blocks of d over the data axes: each rank's
    mean of squares over its block, scaled by its share of d, summed over
    the data ranks (at one data rank the plain norm's own bits)."""
    dtype = x.dtype
    x32 = x.to(torch.float32)
    share = x.shape[-1] / params.scale.shape[0]
    var = parallel.reduce_data(
        torch.mean(x32 * x32, dim=-1, keepdim=True) * share, ws)
    y = x32 * torch.rsqrt(var + eps)
    n = x.shape[-1]
    scale = params.scale.narrow(0, parallel.data_index(ws) * n, n)
    return (y * scale.to(torch.float32)).to(dtype)


def _rms(scale: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(dtype)


def rmsnorm(params: RMSNorm, x: torch.Tensor, eps: float = 1e-5,
            seq=None) -> torch.Tensor:
    scale = params.scale
    if seq is not None:
        scale = coll.copy_to(scale, seq, MODEL_AXIS)
    return _rms(scale, x, eps)


def rmsnorm_headwise(scale: torch.Tensor, x: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """qk-norm: RMSNorm over the head_dim axis of (..., heads, head_dim)."""
    return _rms(scale, x, eps)


def embed(params: Embedding, tokens: torch.Tensor,
          dtype=torch.bfloat16, seq=None) -> torch.Tensor:
    """The table's rows of ``tokens``.  Vocab-parallel: each rank looks up
    the ids in its rows, zeroes the others and the ranks' rows are summed
    over "model" (with ``seq``, reduce-scattered over the sequence)."""
    table = parallel.weight(params, "table").to(dtype)
    block = parallel.vocab_block(params, "table")
    if block is None:
        out = table[tokens]
        return out if seq is None else coll.split(out, seq, MODEL_AXIS, 1)
    lo, rows = block
    local = tokens - lo
    inside = (local >= 0) & (local < rows)
    out = table[torch.where(inside, local, 0)].masked_fill(
        ~inside[..., None], 0)
    if seq is not None:
        return coll.reduce_scatter(out, seq, MODEL_AXIS, 1)
    return coll.all_reduce(out, parallel.placement(params).mesh, MODEL_AXIS)


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
    # the section of each rotary half-dim, from the section sizes on the
    # host: no copy to the device, no sync, and it traces on meta
    dim = torch.arange(half, device=position_ids.device)
    sec_idx = ((dim >= sections[0]).long()
               + (dim >= sections[0] + sections[1]).long())  # (half,)
    ang = torch.movedim(ang, 0, -1)                          # (B, T, half, 3)
    idx = sec_idx.view(1, 1, half, 1).expand(*ang.shape[:3], 1)
    return torch.gather(ang, -1, idx)[..., 0]                # (B, T, half)


def text_position_ids(batch: int, seq: int, offset: int = 0,
                      device=None) -> torch.Tensor:
    """(3, B, T) position ids for text-only input (t = h = w)."""
    pos = torch.arange(seq, device=device)[None, :] + offset
    return pos.expand(batch, seq)[None].expand(3, batch, seq)


def embed_ws(params: Embedding, tokens: torch.Tensor, dtype, ws
             ) -> torch.Tensor:
    """The table's rows of ``tokens`` at the rank's block of d over the
    data axes (the weight-stationary decode): vocab-parallel as
    :func:`embed`, on the table's block of d."""
    table = parallel.d_block(params, "table", 1).to(dtype)
    block = parallel.vocab_block(params, "table")
    if block is None:
        return table[tokens]
    lo, rows = block
    local = tokens - lo
    inside = (local >= 0) & (local < rows)
    out = table[torch.where(inside, local, 0)].masked_fill(
        ~inside[..., None], 0)
    return coll.all_reduce_raw(out, parallel.placement(params).mesh,
                               MODEL_AXIS)


def mlp_ws(params: MLP, x: torch.Tensor, ws) -> torch.Tensor:
    """The SwiGLU under the weight-stationary decode (:func:`ws_in`,
    :func:`ws_out`): no weight gathered."""
    g, u = ws_in([params.gate, params.up], x, ws)
    return ws_out(params.down, F.silu(g) * u, ws)


def mlp(params: MLP, x: torch.Tensor, seq=None, entered: bool = False
        ) -> torch.Tensor:
    """The SwiGLU on x; with ``seq`` on the rank's block of a
    sequence-parallel residual (gathered at entry, reduce-scattered at the
    close), or, ``entered``, on a sequence gathered already (a MoE's
    shared expert), whose cotangent is then the ranks' partials."""
    if not entered:
        x = parallel.enter(x, params.gate, seq=seq)
    elif not parallel.sharded_on_model(params.gate, "weight", 0):
        raise ValueError("a gathered sequence takes a column-parallel MLP: "
                         "this one is whole on every rank")
    g = F.silu(linear(params.gate, x))
    u = linear(params.up, x)
    return linear(params.down, g * u, seq=seq)
