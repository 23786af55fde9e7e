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

A whole model's layer (no placement) takes the same global tokens on
every rank and gives the global output on every rank, so every rank
computes the same loss.  A placed model's layer (``models/parallel.py``)
meets the train step's data-parallel mean instead (each rank's loss over
the data ranks' count, the gradients summed over the data axes):

  * the tokens are the block's residual: under the sequence-parallel
    layout the rank's (B/data, T/model) block already, with no exchange;
    under the baseline layout (every rank of "model" holds its rows' whole
    T) the rank takes its block of T (``collectives.split``, whose
    backward gathers over "model") and all-gathers the output back (the
    gather whose backward keeps the rank's block);
  * the experts are placed by ``param_pspec``, so the optimizer state and
    the records keep the production rules' layout.  Where FSDP put the
    data axes on ff the rank's block is the layer's block (jamba's and
    llama4's, whose ff is the larger dim); where it put them on d (the
    smoke configs' gate and up, d = ff, the tie going to d) one
    all-to-all a data axis trades the block of
    d for the block of ff (:func:`_d_to_ff`, counted in the tally; its
    backward is the reverse exchange); an expert weight FSDP did not cut
    is sliced to the rank's block of ff (olmoe at full width, which the
    rules do not FSDP), its gradient the data ranks' blocks, which the
    train step's all-reduce sums;
  * the router routes only the rank's tokens, so its weight takes "f"
    over "model" (its gradient summed there; the train step sums the data
    axes);
  * the aux loss's stats are summed over the data axes by
    ``collectives.all_reduce_sum``, whose backward sums the data ranks'
    cotangents (each rank's loss carries the aux once over the data
    ranks' count), and over "model" by the all-reduce that passes its
    cotangent through, so a sum over the ranks counts it once;
  * the capacity is the rank's, from its own tokens, as in the
    reference's ``shard_map``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.launch import collectives as coll
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import MODEL_AXIS
from repro_torch.launch.shardings import P, local_shard
from repro_torch.models import layers, parallel
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
                  model_axis: str = "model", placed: bool = False
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """One rank's body: ``xl`` (B/data, T/model, d) its tokens, ``moe``'s
    router (replicated), ``experts`` its (gate, up, down) blocks.  Returns
    its (B/data, T/model, d) outputs and the global aux loss.  ``placed``:
    the layer of a placed model under the data-parallel mean (the module's
    docstring): the router's weight takes "f" over ``model_axis`` and the
    aux stats' sums over the data axes are summed back."""
    daxes, m = _axes(mesh, model_axis)
    bl, tl, d = xl.shape
    n = bl * tl
    e = mo.num_experts
    xf = xl.reshape(n, d)
    probs, gate_vals, expert_idx = moe_mod.route(
        moe, xf, mo, seq=mesh if placed else None)
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
        if placed and ax != model_axis:
            stats = coll.all_reduce_sum(stats, mesh, ax)
        else:
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
                    model_axis: str = "model", seq=None,
                    global_batch: int | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, d) -> (out, aux).  A whole model's layer (no placement)
    takes the same x on every rank and gives the global output on every
    rank; it runs under :func:`~repro_torch.launch.mesh.set_mesh` with a
    mesh that has a "model" axis, else raises ``RuntimeError`` (the
    reference's ``moe_forward_a2a``).  A placed model's layer runs over
    its own mesh on the rank's rows (:func:`_placed`): ``seq`` and
    ``global_batch`` as ``moe.moe_forward`` takes them."""
    if parallel.placement(moe) is not None:
        return _placed(moe, x, mo, seq, global_batch)
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


def _ff_blocks(moe: moe_mod.MoE, mesh) -> tuple[torch.Tensor, ...]:
    """The rank's (E/m, d, ff/n) gate and up and (E/m, ff/n, d) down
    (``expert_specs``) from a placed layer's blocks under the production
    rules: the block itself where FSDP put the data axes on ff, the
    rank's slice of ff where it did not shard the weight over them, and
    where it put them on d, the exchange of :func:`_d_to_ff`."""
    out = []
    for attr, d_dim, ff_dim in (("gate", 1, 2), ("up", 1, 2),
                                ("down", 2, 1)):
        t = getattr(moe, attr)
        fsdp = parallel.data_dim(moe, attr)
        if fsdp == d_dim:
            t = _d_to_ff(t, mesh, d_dim, ff_dim)
        elif fsdp is None:
            f = t.shape[ff_dim] // mesh_lib.data_axis_size(mesh)
            t = t.narrow(ff_dim, parallel.data_index(mesh) * f, f)
        elif fsdp != ff_dim:
            raise ValueError(f"the a2a MoE's {attr} is FSDP'd on dim "
                             f"{fsdp}, neither d nor ff")
        out.append(t)
    return tuple(out)


def _d_to_ff(t: torch.Tensor, mesh, d_dim: int, ff_dim: int
             ) -> torch.Tensor:
    """An expert weight's block of d over the data axes (every ff) ->
    its block of ff (every d): ff cut row-major over the data axes, one
    all-to-all an axis (the outermost first) sends each rank its ff
    block's piece, and the pieces of d come back in block order.  The
    backward is the reverse exchange, so the gradient of the rank's d
    block is whole (every data rank's tokens)."""
    sizes = [mesh.shape[a] for a in mesh_lib.data_axes(mesh)]
    k = len(sizes)
    x = t if d_dim == 1 else t.transpose(1, 2)       # (E/m, d/n, ff)
    e, dl, ff = x.shape
    x = x.reshape(e, dl, *sizes, ff // math.prod(sizes))
    for i, a in enumerate(mesh_lib.data_axes(mesh)):
        x = coll.all_to_all(x.movedim(2 + i, 0).contiguous(), mesh, a)
        x = x.movedim(0, 2 + i)
    # dims 2 .. 2 + k - 1 now index the sender's block of d, outermost
    # axis first: d in block order
    x = x.movedim(1, 1 + k).reshape(e, dl * math.prod(sizes), -1)
    return x if d_dim == 1 else x.transpose(1, 2)


def _placed(moe: moe_mod.MoE, x: torch.Tensor, mo: MoEConfig, seq,
            global_batch: int | None) -> tuple[torch.Tensor, torch.Tensor]:
    """The layer of a placed model (the module's docstring): x is the
    block's residual, the rank's rows over the data axes at the whole T
    (the baseline layout) or, with ``seq``, at its block of T, which is
    the layer's own token block already."""
    pl = parallel.placement(moe)
    mesh = pl.mesh
    m = mesh_lib.model_axis_size(mesh)
    b, t, _ = x.shape
    if parallel.data_rows(pl, b, global_batch)[1] == 1 and \
            mesh_lib.data_axis_size(mesh) > 1:
        raise ValueError(f"the a2a MoE cuts the batch over the data axes: "
                         f"a batch of {b} rows whole on every data rank "
                         "does not divide there")
    if mo.num_experts % m:
        raise ValueError(f"the a2a MoE puts {mo.num_experts} experts on "
                         f"{m} ranks of 'model', which they do not divide")
    if seq is None:
        if t % m:
            raise ValueError(f"the a2a MoE cuts T = {t} over {m} ranks of "
                             "'model', which it does not divide")
        xl = coll.split(x, mesh, MODEL_AXIS, 1)
    else:
        xl = x
    yl, aux = moe_a2a_local(moe, xl, mo, mesh, experts=_ff_blocks(moe, mesh),
                            placed=True)
    out = yl if seq is not None else coll.all_gather_same(yl, mesh,
                                                          MODEL_AXIS, 1)
    if moe.shared is not None:
        out = out + layers.mlp(moe.shared, x, seq=seq)
    return out, aux
