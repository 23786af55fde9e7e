"""Mixture-of-Experts feed-forward with capacity-based dispatch.

The reference's GShard/Switch routing, from the math rather than its TPU
layout:

    tokens --router--> top-k experts --scatter--> (E, cap, d) expert buffers
           --expert SwiGLU (batched over E)--> gather weighted by the gates

The reference builds a (chunk, k, E, cap) one-hot to dispatch and combine;
at olmoe's full size that is ~1.3 G elements a chunk.  Here each kept
(token, slot) pair gets its position in its expert from a cumulative count
over the chunk's pairs in token-major order, the pair's token index is
scattered into an (E·cap + 1)-entry slot table (the last entry takes every
dropped pair), the expert buffers are gathered from the tokens through that
table, and each token gathers its k expert outputs back.  Which pairs drop
is exactly the reference's; the layer makes no host sync.

The expert weights keep the reference's (E, d, f) layout, so the expert
products are ``torch.bmm`` (the reference computes them as XLA einsums
outside any Pallas kernel).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers
from repro_torch.models.config import MoEConfig

# token-chunk size of the dispatch: capacity is per chunk, as the
# reference's scan bounds skew per chunk
DISPATCH_CHUNK = 4096


def check_options(mo: MoEConfig) -> None:
    """The MoE options that need a mesh raise, naming what ports them."""
    if mo.impl == "a2a":
        raise NotImplementedError(
            "the all-to-all MoE (impl='a2a', models/moe_a2a.py) needs a "
            "'model' mesh axis over several cards: ROADMAP Queue 1 item "
            "13b's moe_a2a, with item 11b")
    if mo.impl != "einsum":
        raise ValueError(f"unknown MoE impl {mo.impl!r}")
    if mo.ep_sharding_constraint:
        raise NotImplementedError(
            "expert-parallel sharding constraints (ep_sharding_constraint) "
            "are sharded activations: ROADMAP Queue 1 item 13f")


class MoE(nn.Module):
    """The parameters the reference's ``init_moe`` returns: the router,
    the (E, d, f) gate and up and the (E, f, d) down of the experts, and
    with ``shared_expert`` an always-on SwiGLU."""

    def __init__(self, d_model: int, mo: MoEConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        check_options(mo)
        e, dff = mo.num_experts, mo.d_ff_expert
        kw = dict(device=device, dtype=dtype)
        self.router = layers.Linear(d_model, e, **kw)
        self.gate = layers.empty_param((e, d_model, dff), device, dtype)
        self.up = layers.empty_param((e, d_model, dff), device, dtype)
        self.down = layers.empty_param((e, dff, d_model), device, dtype)
        self.shared = layers.MLP(d_model, mo.d_ff_shared or dff, **kw) \
            if mo.shared_expert else None

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.router.reset_parameters(gen)
        d, dff = self.gate.shape[1], self.gate.shape[2]
        for w, fan_in in ((self.gate, d), (self.up, d), (self.down, dff)):
            scale = 1.0 / math.sqrt(fan_in)
            w.uniform_(-scale, scale, generator=gen)
        if self.shared is not None:
            self.shared.reset_parameters(gen)


def capacity(n_tokens: int, mo: MoEConfig) -> int:
    """Slots an expert a chunk: ``int(n·k/E·cf)`` floored, at least k (the
    reference's ``_capacity``; its config comment says ceil, its code
    floors)."""
    cap = int(n_tokens * mo.top_k / mo.num_experts * mo.capacity_factor)
    return max(cap, mo.top_k)


def route(moe: MoE, xf: torch.Tensor, mo: MoEConfig):
    """Router probabilities and the top-k experts of each token.

    ``xf``: (n, d) in the compute dtype.  Returns float32 ``probs`` (n, E),
    gates (n, k) renormalised over the chosen experts in float32, and int64
    expert ids (n, k) in descending probability, equal probabilities by
    the lower expert id first (``jax.lax.top_k``'s order; a stable
    descending sort gives it, ``torch.topk`` does not promise it).
    """
    logits = layers.linear(moe.router, xf).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = vals[:, :mo.top_k], idx[:, :mo.top_k]
    gate_vals = gate_vals / torch.clamp_min(
        torch.sum(gate_vals, dim=-1, keepdim=True), 1e-9)
    return probs, gate_vals, expert_idx


def dispatch_slots(expert_idx: torch.Tensor, num_experts: int, cap: int
                   ) -> torch.Tensor:
    """Buffer slot of each (token, slot) pair of one chunk: ``e·cap + pos``
    where ``pos`` counts the earlier pairs on expert ``e`` in flattened
    token-major order, and ``E·cap`` (the spare entry) where ``pos`` reaches
    ``cap`` and the pair drops.  ``expert_idx``: (c, k) -> (c, k) int64."""
    flat = expert_idx.reshape(-1)
    experts = torch.arange(num_experts, device=flat.device)
    # (E, pairs), so the count runs along the innermost axis: a scan over
    # the outer axis of a (pairs, E) tensor gives the card one thread an
    # expert (5.6 ms a 4,096-token chunk of olmoe on the H100)
    onehot = (experts[:, None] == flat[None, :]).to(torch.int32)
    count = torch.cumsum(onehot, dim=1, dtype=torch.int32)
    pos = torch.gather(count, 0, flat[None, :])[0].to(torch.int64) - 1
    slot = torch.where(pos < cap, flat * cap + pos,
                       torch.full_like(flat, num_experts * cap))
    return slot.reshape(expert_idx.shape)


def _dispatch_chunk(moe: MoE, xc: torch.Tensor, gate_vals: torch.Tensor,
                    expert_idx: torch.Tensor, mo: MoEConfig, cap: int
                    ) -> torch.Tensor:
    """One token chunk: xc (c, d), gates and ids (c, k) -> (c, d)."""
    c, d = xc.shape
    e = mo.num_experts
    slot = dispatch_slots(expert_idx, e, cap)                  # (c, k)
    # the token that fills each buffer slot; c (a zero row) where none does
    tokens = torch.arange(c, device=xc.device).repeat_interleave(mo.top_k)
    filler = torch.full((e * cap + 1,), c, dtype=torch.int64,
                        device=xc.device)
    filler.scatter_(0, slot.reshape(-1), tokens)
    xz = torch.cat([xc, xc.new_zeros(1, d)])
    expert_in = xz[filler[:-1]].view(e, cap, d)
    dtype = xc.dtype
    g = F.silu(torch.bmm(expert_in, moe.gate.to(dtype)))
    u = torch.bmm(expert_in, moe.up.to(dtype))
    expert_out = torch.bmm(g * u, moe.down.to(dtype))          # (e, cap, d)
    # each token gathers its k outputs (dropped pairs read the zero row),
    # weighted by its gates cast to the compute dtype, summed in float32
    out_z = torch.cat([expert_out.reshape(e * cap, d), xc.new_zeros(1, d)])
    picked = out_z[slot.reshape(-1)].view(c, mo.top_k, d)
    weighted = picked.to(torch.float32) \
        * gate_vals.to(dtype).to(torch.float32)[..., None]
    return torch.sum(weighted, dim=1).to(dtype)


def moe_forward(moe: MoE, x: torch.Tensor, mo: MoEConfig, *,
                dispatch_chunk: int = DISPATCH_CHUNK
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, d) -> (out, aux_loss), as the reference's ``moe_forward``.

    Tokens dispatch in chunks of ``min(dispatch_chunk, n)``; every chunk,
    the short last one too, has the capacity of a full chunk (the
    reference pads the last chunk with rows that route to expert 0 after
    every real row, so they push no real pair out).  ``aux_loss`` is the
    Switch load-balance loss ``E · Σ_e f_e · p_e``: ``f`` the share of
    tokens whose top-1 expert is e, ``p`` the mean router probability.
    """
    check_options(mo)
    b, t, d = x.shape
    n = b * t
    e = mo.num_experts
    xf = x.reshape(n, d)
    probs, gate_vals, expert_idx = route(moe, xf, mo)
    chunk = min(dispatch_chunk, n)
    cap = capacity(chunk, mo)
    out = torch.cat([
        _dispatch_chunk(moe, xf[s:s + chunk], gate_vals[s:s + chunk],
                        expert_idx[s:s + chunk], mo, cap)
        for s in range(0, n, chunk)])
    if moe.shared is not None:
        out = out + layers.mlp(moe.shared, xf)

    top1 = (expert_idx[:, :1] == torch.arange(e, device=x.device)
            ).to(torch.float32)
    f = torch.mean(top1, dim=0)
    p = torch.mean(probs, dim=0)
    aux = e * torch.sum(f * p)
    return out.reshape(b, t, d), aux
