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

On a model sharded by ``models/parallel.py`` the layer runs under the
production rules (``parallel.expert_plan``).  The router stays
replicated.  With E on "model" a rank dispatches the (replicated) tokens
only into its own experts' (E/m, cap, d) buffers; where E does not
divide, every expert runs on the rank's block of ``d_ff_expert``.  Either
way the rank's combine is a float32 partial, all-reduced over "model"
before the cast to the compute dtype; the shared expert is col, col, row.
Capacity and slots are the global batch's: a rank whose rows are a block
of the batch on the data axes (``parallel.data_rows``; a
``global_batch`` equal to the rows says they are the whole batch) takes
the capacity of the global chunk and offsets its slot counts by the
pairs of the data ranks before it in the same chunk (an all-gather of
their counts, only where a chunk spans ranks), and the aux loss
all-reduces f and p over the data axes before their product.  The expert-parallel
constraint (``ep_sharding_constraint``) pins the reference's buffers to
their experts' ranks; here they live there already, so the flag changes
no number.

Under sequence parallelism (``seq``, ``parallel.act_layout``) the layer
takes the rank's block of T: it all-gathers the sequence over "model"
(backward a reduce-scatter of the ranks' partial cotangents), routes and
dispatches as above with no "f" on the tokens or the gates, and
reduce-scatters its float32 partial (and its shared expert's) over T.
The router, which every rank runs alike on the gathered tokens, takes
"f" on its weight, and the aux loss passes its cotangent on from rank 0
of "model" only (``collectives.once``), so that the reduce-scatter's sum
counts it once.  Experts the rules keep whole run on every rank on the
gathered sequence, and the rank keeps its block of their output.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.launch import collectives as coll
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import MODEL_AXIS, data_axes
from repro_torch.models import layers, parallel
from repro_torch.models.config import MoEConfig

# token-chunk size of the dispatch: capacity is per chunk, as the
# reference's scan bounds skew per chunk
DISPATCH_CHUNK = 4096


def check_options(mo: MoEConfig) -> None:
    """``impl="a2a"`` runs ``models/moe_a2a.py`` under an active mesh;
    ``ep_sharding_constraint`` is accepted and changes nothing (see the
    module's docstring)."""
    if mo.impl not in ("einsum", "a2a"):
        raise ValueError(f"unknown MoE impl {mo.impl!r}")


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


def route(moe: MoE, xf: torch.Tensor, mo: MoEConfig, seq=None):
    """Router probabilities and the top-k experts of each token.

    ``xf``: (n, d) in the compute dtype.  Returns float32 ``probs`` (n, E),
    gates (n, k) renormalised over the chosen experts in float32, and int64
    expert ids (n, k) in descending probability, equal probabilities by
    the lower expert id first (``jax.lax.top_k``'s order; a stable
    descending sort gives it, ``torch.topk`` does not promise it).
    With ``seq`` the router's weight takes Megatron's "f" (module
    docstring).
    """
    if seq is None:
        logits = layers.linear(moe.router, xf).to(torch.float32)
    else:
        w = coll.copy_to(parallel.weight(moe.router, "weight"),
                         seq, MODEL_AXIS)
        logits = F.linear(xf, w.to(xf.dtype)).to(torch.float32)
    return _pick(logits, mo)


def _pick(logits: torch.Tensor, mo: MoEConfig):
    """:func:`route` from the router's float32 logits."""
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = vals[:, :mo.top_k], idx[:, :mo.top_k]
    gate_vals = gate_vals / torch.clamp_min(
        torch.sum(gate_vals, dim=-1, keepdim=True), 1e-9)
    return probs, gate_vals, expert_idx


def positions(expert_idx: torch.Tensor, num_experts: int,
              offset: torch.Tensor | None = None) -> torch.Tensor:
    """Each (token, slot) pair's position in its expert: the earlier pairs
    on that expert in flattened token-major order, plus ``offset`` (E,),
    the pairs the data ranks before this one hold in the same chunk.
    ``expert_idx``: (c, k) -> (c, k) int64."""
    flat = expert_idx.reshape(-1)
    experts = torch.arange(num_experts, device=flat.device)
    # (E, pairs), so the count runs along the innermost axis: a scan over
    # the outer axis of a (pairs, E) tensor gives the card one thread an
    # expert (5.6 ms a 4,096-token chunk of olmoe on the H100)
    onehot = (experts[:, None] == flat[None, :]).to(torch.int32)
    count = torch.cumsum(onehot, dim=1, dtype=torch.int32)
    pos = torch.gather(count, 0, flat[None, :])[0].to(torch.int64) - 1
    if offset is not None:
        pos = pos + offset.to(torch.int64)[flat]
    return pos.reshape(expert_idx.shape)


def dispatch_slots(expert_idx: torch.Tensor, num_experts: int, cap: int, *,
                   first: int = 0, count: int | None = None,
                   offset: torch.Tensor | None = None) -> torch.Tensor:
    """Buffer slot of each (token, slot) pair of one chunk: ``(e - first)
    ·cap + pos`` (:func:`positions`) for experts ``first`` to ``first +
    count`` (default all), and ``count·cap`` (the spare entry) where
    ``pos`` reaches ``cap`` and the pair drops, or where its expert is
    another rank's.  ``expert_idx``: (c, k) -> (c, k) int64."""
    count = num_experts if count is None else count
    flat = expert_idx.reshape(-1)
    pos = positions(expert_idx, num_experts, offset).reshape(-1)
    keep = pos < cap
    if count != num_experts:
        keep &= (flat >= first) & (flat < first + count)
    slot = torch.where(keep, (flat - first) * cap + pos,
                       torch.full_like(flat, count * cap))
    return slot.reshape(expert_idx.shape)


def dispatch(xc: torch.Tensor, expert_idx: torch.Tensor, num_experts: int,
             cap: int, *, first: int = 0, count: int | None = None,
             offset: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The (count, cap, d) buffers of experts ``first`` to ``first +
    count`` (default all E) of one chunk ``xc`` (c, d) and each pair's
    slot (:func:`dispatch_slots`); a slot no pair fills is 0."""
    count = num_experts if count is None else count
    c, d = xc.shape
    slot = dispatch_slots(expert_idx, num_experts, cap, first=first,
                          count=count, offset=offset)          # (c, k)
    # the token that fills each buffer slot; c (a zero row) where none does
    tokens = torch.arange(c, device=xc.device).repeat_interleave(
        expert_idx.shape[1])
    filler = torch.full((count * cap + 1,), c, dtype=torch.int64,
                        device=xc.device)
    filler.scatter_(0, slot.reshape(-1), tokens)
    xz = torch.cat([xc, xc.new_zeros(1, d)])
    return xz[filler[:-1]].view(count, cap, d), slot


def expert_ffn(expert_in: torch.Tensor, gate: torch.Tensor,
               up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU, batched over E: (E, C, d) -> (E, C, d)."""
    dtype = expert_in.dtype
    g = F.silu(torch.bmm(expert_in, gate.to(dtype)))
    u = torch.bmm(expert_in, up.to(dtype))
    return torch.bmm(g * u, down.to(dtype))


def combine_partial(expert_out: torch.Tensor, slot: torch.Tensor,
                    gate_vals: torch.Tensor) -> torch.Tensor:
    """Each token's outputs from the (E, cap, d) buffers (dropped pairs
    and another rank's experts read the zero row), weighted by its gates
    cast to the compute dtype, summed in float32: -> (c, d) float32."""
    c, k = slot.shape
    d = expert_out.shape[-1]
    dtype = expert_out.dtype
    out_z = torch.cat([expert_out.reshape(-1, d), expert_out.new_zeros(1, d)])
    picked = out_z[slot.reshape(-1)].view(c, k, d)
    weighted = picked.to(torch.float32) \
        * gate_vals.to(dtype).to(torch.float32)[..., None]
    return torch.sum(weighted, dim=1)


def combine(expert_out: torch.Tensor, slot: torch.Tensor,
            gate_vals: torch.Tensor) -> torch.Tensor:
    """:func:`combine_partial` cast to the compute dtype: -> (c, d)."""
    return combine_partial(expert_out, slot, gate_vals).to(expert_out.dtype)


def _moe_ws(moe: MoE, x: torch.Tensor, mo: MoEConfig, dispatch_chunk: int,
            ws) -> tuple[torch.Tensor, torch.Tensor]:
    """A decode step's layer under the weight-stationary layout: x is
    every row of the batch at the rank's block of d over the data axes.
    The router runs on its block of d (``layers.ws_in``).  Gate and up
    FSDP'd on d (or whole over the data axes, then sliced) are contracted
    on the rank's block of d, their partials summed over the data ranks;
    FSDP'd on d_ff they take x's whole d (gathered: activations, not
    weights) and give the rank's block of d_ff.  A down FSDP'd on d (or
    whole) gives the block of d; one FSDP'd on d_ff takes the block of
    d_ff, its output reduce-scattered over the data axes onto the block
    of d.  No weight is gathered; the aux loss is not formed (a decode
    step's)."""
    b, t, _ = x.shape
    n = b * t
    e = mo.num_experts
    xf = x.reshape(n, -1)
    plan = parallel.expert_plan(moe, e)
    logits, = layers.ws_in([moe.router], xf, ws)
    _, gate_vals, expert_idx = _pick(logits.to(torch.float32), mo)
    # gate / up (E, d, f) and down (E, f, d): each FSDP'd on d, on d_ff
    # or on neither (then sliced at the rank's block of d)
    up_ff = parallel.data_dim(moe, "gate") == 2
    down_ff = parallel.data_dim(moe, "down") == 1
    if up_ff:
        xin = parallel.gather_data(xf, ws, 1)
        w_gate, w_up = moe.gate, moe.up
    else:
        xin = xf
        w_gate, w_up = (parallel.d_block(moe, a, 1) for a in ("gate", "up"))
    w_down = moe.down if down_ff else parallel.d_block(moe, "down", 2)
    j, n_data = parallel.data_index(ws), mesh_lib.data_axis_size(ws)
    chunk = min(dispatch_chunk, n)
    cap = capacity(chunk, mo)
    parts = []
    for s in range(0, n, chunk):
        expert_in, slot = dispatch(xin[s:s + chunk], expert_idx[s:s + chunk],
                                   e, cap, first=plan.first,
                                   count=plan.count)
        dtype = expert_in.dtype
        g = torch.bmm(expert_in, w_gate.to(dtype))
        u = torch.bmm(expert_in, w_up.to(dtype))
        if not up_ff:
            gu = parallel.reduce_data(torch.cat([g, u], dim=-1).to(
                torch.float32), ws).to(dtype)
            g, u = torch.split(gu, [g.shape[-1], u.shape[-1]], dim=-1)
        h = F.silu(g) * u
        if down_ff and not up_ff:
            f = h.shape[-1] // n_data
            h = h.narrow(-1, j * f, f)
        elif up_ff and not down_ff:
            h = parallel.gather_data(h, ws, 2)
        y = torch.bmm(h, w_down.to(dtype))
        parts.append(combine_partial(y, slot, gate_vals[s:s + chunk]))
    out = torch.cat(parts)
    if plan.mesh is not None:
        out = coll.all_reduce_raw(out, plan.mesh, MODEL_AXIS)
    if down_ff:
        out = parallel.scatter_data(out, ws, 1)
    out = out.to(x.dtype)
    if moe.shared is not None:
        out = out + layers.mlp_ws(moe.shared, xf, ws)
    return out.reshape(b, t, -1), torch.zeros((), dtype=torch.float32,
                                              device=x.device)


def _chunk_offsets(expert_idx: torch.Tensor, start: int, n: int, chunk: int,
                   num_experts: int, pl, j: int) -> torch.Tensor:
    """(chunks, E): the pairs on each expert in each chunk of the global
    batch held by the data ranks before rank ``j`` (its tokens start at
    global token ``start``), from every data rank's counts all-gathered
    over the data axes, the innermost first (rank-major)."""
    nl = expert_idx.shape[0]
    n_chunks = -(-n // chunk)
    cid = (start + torch.arange(nl, device=expert_idx.device)) // chunk
    key = (cid[:, None] * num_experts + expert_idx).reshape(-1)
    counts = torch.zeros(n_chunks * num_experts, dtype=torch.int32,
                         device=expert_idx.device)
    counts.index_add_(0, key, torch.ones_like(key, dtype=torch.int32))
    every = counts[None]
    for a in reversed(data_axes(pl.mesh)):
        every = coll.all_gather_raw(every, pl.mesh, a, 0)
    return every[:j].sum(dim=0).view(n_chunks, num_experts)


def moe_forward(moe: MoE, x: torch.Tensor, mo: MoEConfig, *,
                dispatch_chunk: int = DISPATCH_CHUNK, with_aux: bool = True,
                global_batch: int | None = None, seq=None, ws=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, d) -> (out, aux_loss), as the reference's ``moe_forward``.

    Tokens dispatch in chunks of ``min(dispatch_chunk, n)``; every chunk,
    the short last one too, has the capacity of a full chunk (the
    reference pads the last chunk with rows that route to expert 0 after
    every real row, so they push no real pair out).  ``aux_loss`` is the
    Switch load-balance loss ``E · Σ_e f_e · p_e``: ``f`` the share of
    tokens whose top-1 expert is e, ``p`` the mean router probability
    (0 without ``with_aux``, as a decode step, which drops it).  On a
    placed model: the module's docstring; n, the chunks and the means
    are those of the batch of ``global_batch`` rows
    (``parallel.data_rows``).  With ``seq`` x and out are the rank's
    block of T (the module's docstring); with ``ws`` (a decode step) every
    row at the rank's block of d (:func:`_moe_ws`).
    """
    check_options(mo)
    if ws is not None:
        return _moe_ws(moe, x, mo, dispatch_chunk, ws)
    pl = parallel.placement(moe)
    plan = parallel.expert_plan(moe, mo.num_experts)
    if seq is not None and plan.mesh is None:
        out, aux = moe_forward(
            moe, coll.all_gather_same(x, seq, MODEL_AXIS, 1), mo,
            dispatch_chunk=dispatch_chunk, with_aux=with_aux,
            global_batch=global_batch)
        return coll.split(out, seq, MODEL_AXIS, 1), aux
    if seq is not None:
        x = coll.all_gather(x, seq, MODEL_AXIS, 1)
    b, t, d = x.shape
    nl = b * t
    e = mo.num_experts
    xf = x.reshape(nl, d)
    j, n_data = parallel.data_rows(pl, b, global_batch)
    n, start = nl * n_data, j * nl
    probs, gate_vals, expert_idx = (route(moe, xf, mo) if seq is None
                                    else route(moe, xf, mo, seq=seq))
    chunk = min(dispatch_chunk, n)
    cap = capacity(chunk, mo)
    offsets = None
    if n_data > 1 and nl % chunk:      # a chunk spans ranks' rows
        offsets = _chunk_offsets(expert_idx, start, n, chunk, e, pl, j)
    weights = [parallel.weight(moe, a) for a in ("gate", "up", "down")]
    xd, gd = xf, gate_vals
    if plan.mesh is not None and seq is None:
        # each rank's cotangents are its experts' (or its ff block's)
        # partials: Megatron's "f" sums them over "model"
        xd = coll.copy_to(xf, plan.mesh, MODEL_AXIS)
        gd = coll.copy_to(gate_vals, plan.mesh, MODEL_AXIS)
    parts = []
    s = start
    while s < start + nl:
        c = s // chunk
        end = min((c + 1) * chunk, start + nl)
        lo, hi = s - start, end - start
        expert_in, slot = dispatch(
            xd[lo:hi], expert_idx[lo:hi], e, cap, first=plan.first,
            count=plan.count, offset=None if offsets is None else offsets[c])
        parts.append(combine_partial(expert_ffn(expert_in, *weights), slot,
                                     gd[lo:hi]))
        s = end
    out = torch.cat(parts)
    if seq is not None:
        out = coll.reduce_scatter(out.view(b, t, d), plan.mesh, MODEL_AXIS,
                                  1)
    elif plan.mesh is not None:
        out = coll.all_reduce(out, plan.mesh, MODEL_AXIS)
    out = out.to(x.dtype)
    if moe.shared is not None:
        out = out + (layers.mlp(moe.shared, xf) if seq is None else
                     layers.mlp(moe.shared, xf.view(b, t, d), seq=seq,
                                entered=True))
    out = out.reshape(b, -1, d)
    if not with_aux:
        return out, torch.zeros((), dtype=torch.float32, device=x.device)

    top1 = (expert_idx[:, :1] == torch.arange(e, device=x.device)
            ).to(torch.float32)
    if n_data == 1:
        f = torch.mean(top1, dim=0)
        p = torch.mean(probs, dim=0)
    else:
        # the global means: the ranks' sums over n, all-reduced over the
        # data axes before the product
        fp = torch.cat([torch.sum(top1, dim=0), torch.sum(probs, dim=0)]) / n
        for a in data_axes(pl.mesh):
            fp = coll.all_reduce_sum(fp, pl.mesh, a)
        f, p = fp[:e], fp[e:]
    aux = e * torch.sum(f * p)
    if seq is not None:
        aux = coll.once(aux, seq, MODEL_AXIS)
    return out, aux
