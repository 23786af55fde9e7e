"""Expert-parallel MoE with explicit all-to-all dispatch.

The reference's ``moe_a2a.py`` (a ``shard_map`` over the active mesh), from
the math: each rank routes its own tokens, sends each expert's slots to the
rank that owns that expert, runs its experts on its ff shard and returns
the outputs.  The collectives go through ``launch/collectives.py``, one
axis at a time as the reference issues them, so their tally can be held to
the reference's compiled HLO op for op.

Layout, the shard_map's ``in_specs``: tokens (B, T, d) with B on the data
axes and T on "model"; gate and up (E, d, ff) and down (E, ff, d) with E on
"model" and ff on the data axes; the router replicated.  For olmoe (d
2,048 > ff 1,024) that is not ``param_pspec``'s FSDP fill, which would
split d: :func:`moe_forward_a2a` slices the rank's blocks out of the
module's whole weights by these specs.

Per rank, on n_local tokens (:func:`moe_a2a_local`):

  route locally -> dispatch into (E, cap, d), ``cap = capacity(n_local)``
  over all local tokens (the pairs the reference's ``_local_dispatch``
  drops, in token-major order) -> all-to-all over "model" as (m, E/m,
  cap, d) -> all-gather the buffers over the data axes, the last first ->
  the SwiGLU on the local ff shard -> reduce-scatter over the data axes in
  order (the reduce sums ff shards, the scatter returns each rank its
  tokens) -> the reverse all-to-all -> the local combine.

The buffers stay (ranks, E/m, cap, d) through every exchange, so each
runs along dim 0 with no copy around it; one transpose before the SwiGLU
and one after lay them out by expert.  The reference transposes after
the all-to-all and gathers along the tokens, which costs the port four
more passes over the buffer (PERF.md, PR 27).

The load-balance aux loss sums each rank's top-1 counts, router
probabilities and token count over the data axes, then "model"; the three
travel packed in one all-reduce an axis, the one tuple all-reduce an axis
that XLA's combiner makes of the reference's three psums.
"""
from __future__ import annotations

import torch

from repro_torch.launch import collectives as coll
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.shardings import P, local_shard
from repro_torch.models import layers
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import MoEConfig


def _axes(mesh, model_axis: str) -> tuple[tuple[str, ...], int]:
    if model_axis not in mesh.shape:
        raise RuntimeError("moe impl='a2a' needs a mesh with a "
                           f"{model_axis!r} axis made active by set_mesh()")
    return (tuple(a for a in mesh.axis_names if a != model_axis),
            mesh.shape[model_axis])


def expert_specs(mesh, model_axis: str = "model"
                 ) -> tuple[P, P, P, P]:
    """The specs of gate, up, down (E, d, ff) / (E, ff, d) and of the
    tokens (B, T, d) (the reference's ``in_specs``)."""
    daxes, _ = _axes(mesh, model_axis)
    return (P(model_axis, None, daxes), P(model_axis, None, daxes),
            P(model_axis, daxes, None), P(daxes, model_axis, None))


def moe_a2a_local(moe: moe_mod.MoE, xl: torch.Tensor, mo: MoEConfig, mesh,
                  *, experts: tuple[torch.Tensor, ...],
                  model_axis: str = "model"
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """One rank's body: ``xl`` (B/data, T/model, d) its tokens, ``moe``'s
    router (replicated), ``experts`` its (gate, up, down) blocks.  Returns
    its (B/data, T/model, d) outputs and the global aux loss."""
    daxes, m = _axes(mesh, model_axis)
    bl, tl, d = xl.shape
    n = bl * tl
    e = mo.num_experts
    xf = xl.reshape(n, d)
    probs, gate_vals, expert_idx = moe_mod.route(moe, xf, mo)
    cap = moe_mod.capacity(n, mo)
    expert_in, slot = moe_mod.dispatch(xf, expert_idx, e, cap)

    # (m, E/m, cap, d), dim 0 the rank of "model" the slots came from;
    # the gathers over the data axes stack the data rows' buffers along
    # that dim, data-major (the order of the reference's tiled gathers
    # along the tokens), so every exchange runs along dim 0
    buf = coll.all_to_all(expert_in.view(m, e // m, cap, d), mesh,
                          model_axis)
    for ax in reversed(daxes):
        buf = coll.all_gather(buf, mesh, ax, dim=0)
    rows = buf.shape[0]
    out = moe_mod.expert_ffn(buf.transpose(0, 1).reshape(e // m, rows * cap,
                                                         d), *experts)
    out = out.view(e // m, rows, cap, d).transpose(0, 1).contiguous()
    for ax in daxes:
        out = coll.reduce_scatter(out, mesh, ax, dim=0)
    # back: dim 0 of the result is the owner of experts r·E/m + j, which is
    # the original expert-major order
    ret = coll.all_to_all(out, mesh, model_axis)
    y = moe_mod.combine(ret.reshape(e, cap, d), slot, gate_vals)

    top1 = (expert_idx[:, :1] == torch.arange(e, device=xl.device)
            ).to(torch.float32)
    stats = torch.cat([torch.sum(top1, dim=0), torch.sum(probs, dim=0),
                       probs.new_full((1,), float(n))])
    for ax in daxes + (model_axis,):
        stats = coll.all_reduce(stats, mesh, ax)
    f_sum, p_sum, count = stats[:e], stats[e:2 * e], stats[2 * e]
    aux = e * torch.sum((f_sum / count) * (p_sum / count))
    return y.reshape(bl, tl, d), aux


def _gather_tokens(y: torch.Tensor, mesh, daxes, model_axis) -> torch.Tensor:
    """Every rank's (B/data, T/model, d) block -> the global (B, T, d)."""
    y = coll.all_gather_raw(y, mesh, model_axis, dim=1)
    for ax in reversed(daxes):
        y = coll.all_gather_raw(y, mesh, ax, dim=0)
    return y


class _TokenBlock(torch.autograd.Function):
    """The rank's block of tokens replicated on every rank.  Every rank
    computes the same loss from the global output, so the cotangent of the
    global tokens is every rank's blocks: the backward gathers them."""

    @staticmethod
    def forward(ctx, x, mesh, model_axis):
        daxes, _ = _axes(mesh, model_axis)
        ctx.mesh, ctx.daxes, ctx.model_axis = mesh, daxes, model_axis
        spec = P(daxes, model_axis, None)
        return local_shard(x, spec, mesh, mesh.coords()).contiguous()

    @staticmethod
    def backward(ctx, g):
        return (_gather_tokens(g.contiguous(), ctx.mesh, ctx.daxes,
                               ctx.model_axis), None, None)


class _GlobalTokens(torch.autograd.Function):
    """Every rank's output block gathered into the global tokens; the
    backward takes the rank's block of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, y, mesh, model_axis):
        daxes, _ = _axes(mesh, model_axis)
        ctx.mesh, ctx.spec = mesh, P(daxes, model_axis, None)
        return _gather_tokens(y, mesh, daxes, model_axis)

    @staticmethod
    def backward(ctx, g):
        return (local_shard(g, ctx.spec, ctx.mesh, ctx.mesh.coords())
                .contiguous(), None, None)


def moe_forward_a2a(moe: moe_mod.MoE, x: torch.Tensor, mo: MoEConfig, *,
                    model_axis: str = "model"
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, d), the same on every rank -> (out, aux), the global
    output on every rank.  Runs under :func:`~repro_torch.launch.mesh.
    set_mesh` with a mesh that has a "model" axis, else raises
    ``RuntimeError`` (the reference's ``moe_forward_a2a``)."""
    mesh = mesh_lib.get_active_mesh()
    if mesh is None:
        raise RuntimeError("moe impl='a2a' needs a mesh made active by "
                           "set_mesh()")
    gate_s, up_s, down_s, _ = expert_specs(mesh, model_axis)
    coords = mesh.coords()
    experts = (local_shard(moe.gate, gate_s, mesh, coords),
               local_shard(moe.up, up_s, mesh, coords),
               local_shard(moe.down, down_s, mesh, coords))
    xl = _TokenBlock.apply(x, mesh, model_axis)
    yl, aux = moe_a2a_local(moe, xl, mo, mesh, experts=experts,
                            model_axis=model_axis)
    out = _GlobalTokens.apply(yl, mesh, model_axis)
    if moe.shared is not None:
        out = out + layers.mlp(moe.shared, x)
    return out, aux
