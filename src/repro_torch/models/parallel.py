"""A rank's share of the dense model: its parameter shards under the
production rules, and the Megatron column / row machinery over them.

The reference has no hand-written tensor parallelism: GSPMD partitions its
jitted step under the name-based rules of ``launch/shardings.py``.  The
port does it by hand.  :func:`parallelize` replaces each parameter of a
``Model`` by the block the rank holds (``shardings.local_shard`` under
``shardings.param_pspecs``, FSDP included) and records each leaf's spec
on the module that owns it (:class:`Placement`), so a rank's parameter
bytes are exactly ``launch/dryrun.py::argument_bytes_per_device``'s.  At
a mesh of one rank every block is the whole tensor, kept as a view: no
copy.

The layers read the placement of their module:

  * a weight with an FSDP dim (one of the data axes' entries) is
    all-gathered over those axes just before use, innermost axis first
    (:func:`weight`); the gather's backward is the reduce-scatter of its
    gradient over the data ranks;
  * a column-parallel weight (output dim on "model") gives the rank its
    block of output columns; its input enters through Megatron's "f"
    (:func:`enter`), whose backward all-reduces over "model";
  * a row-parallel weight (input dim on "model") takes the rank's block of
    input columns and all-reduces its partial output over "model" ("g").

A replicated activation is the same on every rank of "model"; a
replicated parameter gets the whole gradient on every rank of "model"
(the f / g pairing sees to it), and the data-parallel step
(``training/train.py``) sums the ranks of the data axes.

The attention's column blocks need not be whole heads (the rules cut
columns: qwen3-8b's keys at 16 ranks are half a head each).
:func:`head_plan` says which whole heads a rank computes and what it
exchanges to get them (``models/attention.py``).

Every block of the catalog shards: attention, Mamba, mLSTM and sLSTM
mixers with a SwiGLU MLP, an einsum or an all-to-all MoE
(``models/moe_a2a.py``, on the rank's own token block) or no FFN.  The
rules cut
the recurrent mixers where no Megatron pairing fits: the Mamba's
``in_proj`` and the mLSTM's ``up`` are column parallel over the
concatenated (x | z) columns, so a rank's columns are channel blocks of x
or of z that other ranks' states hold, and the sLSTM's ``w_in`` /
``w_rec`` are column parallel over the concatenated gates [i | f | z |
o].  :func:`gate_plan` says which channel block of which part each of a
rank's column pieces is and which rank owns it, and :func:`mlstm_plan`
which block of a head's d_k / d_v the head-wise projections give a rank;
the mixers' exchanges (``models/mamba.py``, ``models/xlstm.py``) follow
them.  The einsum MoE reads its
experts' placement (:func:`expert_plan`): E on "model" (whole experts a
rank) or, where E does not divide, every expert on the rank's block of
``d_ff_expert``.  The decode reads :func:`cache_plan`: which slots of a
KV cache a rank holds where ``cache_pspec`` puts the sequence on "model",
and which it attends over (flash-decoding).

The reference's ``act_pspec`` names one of two layouts of the residual
stream (:func:`act_layout`).  ``P(data axes, "model", None)`` is
Megatron's sequence parallelism, which the port writes as its own
schedule: between blocks the residual is the rank's (rows, T/m, d)
block of the sequence, norms run on the block (their scales' gradients
all-reduced over "model"), a block's entry is an all-gather over T on
"model" (:func:`enter` with ``seq``; backward a reduce-scatter) where
Megatron's "f" was, and its closing row-parallel all-reduce a
reduce-scatter over T (``layers.linear`` with ``seq``; backward an
all-gather).  A layer the rules keep whole runs on the whole sequence on
every rank: an all-gather whose backward keeps the rank's block before
it, the rank's block of its output after (``collectives.split``).
A sequence that does not divide over "model" raises with its sizes
(:func:`check_seq`): GSPMD would pad it, the port does not (no catalog
cell needs it).

``P(None, None, "data")`` is the weight-stationary decode
(:func:`ws_mesh`): the residual is every row of the batch at the rank's
block of d over the data axes (on the multi-pod mesh "pod" and "data"
together, as the FSDP dim of every weight spans both).  Each weight is
contracted in place on its block (:func:`d_block`): a weight whose
input is d gives partial sums, all-reduced over the data axes; one whose
output is d gives the rank's block of it; norms all-reduce their sums
of squares.  The cache stays batch-sharded under ``cache_pspec``, so
attention and the recurrent mixers work on the rank's rows
(:func:`ws_rows`) and the rows, not the weights, move
(:func:`ws_all_rows`).  The Mamba's ``x_proj``, ``dt_proj``, ``A_log``
(and ``conv_w``), the mLSTM's head-wise blocks and ``w_if`` and the
sLSTM's ``w_rec`` never touch the residual: they stay gathered where
FSDP put them (``models/mamba.py``, ``models/xlstm.py`` say why).

A placed model's rows of a batch are its block of the batch sharded over
the data axes, as ``shardings.batch_pspec`` gives every batch that
divides over them.  A caller whose batch does not divide (and so is
whole on every rank) says so with the call that carries it:
``global_batch`` equal to the rows it passes (:func:`data_rows`).  Only
the MoE reads it: its capacity and slots are counted over the global
batch.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.launch import collectives as coll
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import shardings
from repro_torch.launch.mesh import DATA_AXES, MODEL_AXIS, Mesh
from repro_torch.launch.shardings import PartitionSpec


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a module's parameters live: the mesh, this rank's coordinates
    on it and each parameter's spec (by attribute name)."""

    mesh: Mesh
    coords: dict[str, int]
    specs: dict[str, PartitionSpec]

    @property
    def model_size(self) -> int:
        return mesh_lib.model_axis_size(self.mesh)

    @property
    def model_rank(self) -> int:
        return self.coords.get(MODEL_AXIS, 0)


@dataclasses.dataclass(frozen=True)
class Parallel:
    """A sharded model's mesh and every parameter's spec."""

    mesh: Mesh
    specs: dict[str, PartitionSpec]


def placement(module: nn.Module | None) -> Placement | None:
    return None if module is None else module.__dict__.get("placement")


def of(model: nn.Module) -> Parallel | None:
    """The model's :class:`Parallel`, or None for a whole model."""
    return model.__dict__.get("parallel")


SEQUENCE, WEIGHT_STATIONARY = "sequence", "weight_stationary"


def act_layout(act_pspec, mesh: Mesh | None = None) -> str | None:
    """Which of the reference's residual layouts ``act_pspec`` names:
    None for none, :data:`SEQUENCE` for ``P(data axes, "model", None)``
    (the data axes of ``mesh`` where one is given), and
    :data:`WEIGHT_STATIONARY` for the decode's ``P(None, None, "data")``;
    any other spec raises ``ValueError`` naming it."""
    if act_pspec is None:
        return None
    if isinstance(act_pspec, tuple):
        spec = PartitionSpec(*act_pspec)
        if tuple(spec) == (None, None, "data"):
            return WEIGHT_STATIONARY
        if len(spec) == 3 and spec[1] == MODEL_AXIS and spec[2] is None:
            daxes = _axes(spec[0])
            want = daxes if mesh is None else mesh_lib.data_axes(mesh)
            if daxes and set(daxes) <= set(DATA_AXES) and daxes == want:
                return SEQUENCE
    raise ValueError(
        f"act_pspec {act_pspec!r} is neither of the reference's layouts: "
        f"P(<the data axes>, 'model', None) (sequence parallel) or "
        f"P(None, None, 'data') (the weight-stationary decode)")


def seq_mesh(model: nn.Module, act_pspec) -> Mesh | None:
    """The mesh over whose "model" axis ``model``'s residual is cut in
    blocks of the sequence under ``act_pspec``, None where it is whole
    (no spec, or a whole model, on which the layout changes nothing).
    The weight-stationary layout, the decode's, raises here."""
    par = of(model)
    layout = act_layout(act_pspec, None if par is None else par.mesh)
    if layout == WEIGHT_STATIONARY:
        raise ValueError("act_pspec P(None, None, 'data'), the "
                         "weight-stationary layout, is a decode step's")
    return par.mesh if layout == SEQUENCE and par is not None else None


def ws_mesh(model: nn.Module, act_pspec) -> Mesh | None:
    """The mesh over whose data axes a decode step's residual is cut in
    blocks of d under ``act_pspec`` (the weight-stationary layout), None
    where the step runs the baseline layout (no spec, or a whole model,
    on which the layout changes nothing).  The sequence-parallel layout
    raises here (a decode step has one token), and so does a d that does
    not divide over the data ranks."""
    par = of(model)
    layout = act_layout(act_pspec, None if par is None else par.mesh)
    if layout == SEQUENCE:
        raise ValueError("a decode step has one token: no sequence to cut "
                         "over 'model'")
    if layout != WEIGHT_STATIONARY or par is None:
        return None
    d = model.cfg.d_model
    if d % mesh_lib.data_axis_size(par.mesh):
        raise ValueError(f"the weight-stationary decode cuts d = {d} over "
                         f"{mesh_lib.data_axis_size(par.mesh)} data ranks, "
                         "which it does not divide")
    return par.mesh


def ws_rows(y: torch.Tensor, rows: int, ws: Mesh) -> torch.Tensor:
    """The rank's ``rows`` rows of ``y`` (every row of the batch, dim 0)
    under the weight-stationary decode: its block over the data axes, as
    ``cache_pspec`` cuts the decode states, or every row where the batch
    does not divide there (``rows`` is then all of them)."""
    if rows == y.shape[0]:
        return y
    j = data_index(ws)
    return y[j * rows:(j + 1) * rows]


def ws_all_rows(y: torch.Tensor, batch: int, ws: Mesh) -> torch.Tensor:
    """Every row of the batch of ``batch`` from the rank's rows of ``y``
    (:func:`ws_rows`): all-gathered over the data axes where they are a
    block of it."""
    return y if y.shape[0] == batch else gather_data(y, ws, 0)


def data_index(mesh: Mesh) -> int:
    """This rank's index over the data axes, row-major (the first axis the
    slowest), as FSDP and the batch's rows number their blocks."""
    j = 0
    coords = mesh.coords()
    for a in mesh_lib.data_axes(mesh):
        j = j * mesh.shape[a] + coords[a]
    return j


def d_block(module: nn.Module, attr: str, dim: int) -> torch.Tensor:
    """``module.attr`` at the rank's block of d along ``dim`` (the
    residual's d under the weight-stationary decode): the parameter
    itself where its spec puts ``dim`` on the data axes (FSDP), the
    rank's slice of it where ``dim`` is whole.  A parameter FSDP'd on
    another dim raises: it cannot be contracted in place on d."""
    t = getattr(module, attr)
    pl = placement(module)
    spec = pl.specs[attr]
    data = [i for i, entry in enumerate(spec)
            if set(_axes(entry)) & set(DATA_AXES)]
    if data == [dim]:
        return t
    if data:
        raise ValueError(f"{attr} is FSDP'd on dim {data}, not on d "
                         f"(dim {dim})")
    n = mesh_lib.data_axis_size(pl.mesh)
    size = t.shape[dim] // n
    return t.narrow(dim, data_index(pl.mesh) * size, size)


def data_dim(module: nn.Module, attr: str) -> int | None:
    """The dim of ``module.attr`` its spec puts on the data axes (FSDP),
    None for none."""
    spec = placement(module).specs[attr]
    for i, entry in enumerate(spec):
        if set(_axes(entry)) & set(DATA_AXES):
            return i
    return None


def reduce_data(y: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``y`` over the data ranks (each data axis in turn)."""
    for a in mesh_lib.data_axes(mesh):
        y = coll.all_reduce_raw(y, mesh, a)
    return y


def gather_data(y: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """Every data rank's block of ``y`` along ``dim``, in block order (the
    innermost data axis first)."""
    for a in reversed(mesh_lib.data_axes(mesh)):
        y = coll.all_gather_raw(y, mesh, a, dim)
    return y


def scatter_data(y: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """The sum of ``y`` over the data ranks, the rank keeping its block
    along ``dim`` (the outermost data axis first)."""
    for a in mesh_lib.data_axes(mesh):
        y = coll.reduce_scatter_raw(y, mesh, a, dim)
    return y


def check_seq(t: int, seq: Mesh | None) -> None:
    """A sequence of ``t`` tokens must divide over "model" of ``seq``."""
    if seq is not None and t % mesh_lib.model_axis_size(seq):
        raise ValueError(
            f"sequence parallelism cuts T = {t} over "
            f"{mesh_lib.model_axis_size(seq)} ranks of 'model', which it "
            "does not divide (the port does not pad it)")


@torch.no_grad()
def parallelize(model: nn.Module, mesh: Mesh, *, fsdp: bool = False
                ) -> nn.Module:
    """Give this rank of ``mesh`` (live, or shape-only: rank 0's block)
    its shards of ``model``'s parameters, in place; returns the model.
    A block smaller than its tensor is copied out, so the whole tensor is
    freed with the model's old parameter."""
    cfg = model.cfg
    if of(model) is not None:
        raise ValueError("the model is sharded already")
    specs = shardings.param_pspecs(cfg, model, mesh, fsdp=fsdp)
    coords = mesh.coords()
    by_owner: dict[str, dict[str, PartitionSpec]] = {}
    for name, p in list(model.named_parameters()):
        owner_name, _, attr = name.rpartition(".")
        owner = model.get_submodule(owner_name)
        block = shardings.local_shard(p.detach(), specs[name], mesh, coords)
        if block.shape != p.shape:
            block = block.clone(memory_format=torch.contiguous_format)
        owner._parameters[attr] = nn.Parameter(
            block, requires_grad=p.requires_grad)
        by_owner.setdefault(owner_name, {})[attr] = specs[name]
    for owner_name, owned in by_owner.items():
        model.get_submodule(owner_name).__dict__["placement"] = Placement(
            mesh, coords, owned)
    model.__dict__["parallel"] = Parallel(mesh, specs)
    return model


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec: PartitionSpec) -> tuple[str, ...]:
    """Every axis a spec shards on, in the spec's order."""
    return tuple(a for entry in spec for a in _axes(entry))


def gather_full(t: torch.Tensor, spec: PartitionSpec, mesh: Mesh
                ) -> torch.Tensor:
    """The whole tensor of which ``t`` is this rank's block, all-gathered
    (no autograd) over the axes of ``spec``, the innermost axis of each
    dim first."""
    for dim, entry in enumerate(spec):
        for a in reversed(_axes(entry)):
            t = coll.all_gather_raw(t, mesh, a, dim)
    return t


def weight(module: nn.Module, attr: str) -> torch.Tensor:
    """``module``'s parameter ``attr`` as a layer uses it: its FSDP dim
    all-gathered over the data axes (differentiably), the model axis's
    block kept.  Under a train step's bf16 casts (``training/train.py``)
    the leaf is bf16 already, so the gathers and the reduce-scatters of
    its gradient move bf16."""
    t = getattr(module, attr)
    pl = placement(module)
    if pl is None:
        return t
    for dim, entry in enumerate(pl.specs[attr]):
        for a in reversed(_axes(entry)):
            if a in DATA_AXES:
                t = coll.all_gather(t, pl.mesh, a, dim)
    return t


def sharded_on_model(module: nn.Module, attr: str, dim: int) -> bool:
    pl = placement(module)
    return pl is not None and MODEL_AXIS in _axes(pl.specs[attr][dim])


def rank_block(module: nn.Module, attr: str, dim: int,
               block: tuple[int, int] | None) -> torch.Tensor:
    """``module.attr`` as :func:`weight` gives it, narrowed along ``dim``
    to ``block`` (first, count): the rank's channels of a per-channel
    parameter.  A parameter the rules put on "model" along ``dim`` is that
    block already; a replicated one (the Mamba's ``dt_bias``, which the
    rules' "bias" keeps whole) is narrowed after Megatron's "f", so that
    its gradient, the ranks' blocks' sum, is whole on every rank.
    ``block`` None: the whole tensor (no placement, or the mixer whole on
    every rank)."""
    t = weight(module, attr)
    if block is None or sharded_on_model(module, attr, dim):
        return t
    t = coll.copy_to(t, placement(module).mesh, MODEL_AXIS)
    return t.narrow(dim, *block)


def enter(x: torch.Tensor, module: nn.Module, attr: str = "weight",
          seq: Mesh | None = None) -> torch.Tensor:
    """Megatron's "f" before ``module``, where its ``attr`` is column
    parallel (dim 0 on "model"; the rows of an embedding table): ``x``
    forward, the all-reduce of its cotangent over "model" backward.
    With ``seq`` (sequence parallel, x the rank's block of dim 1) the
    all-gather of the sequence over "model", whose backward
    reduce-scatters the ranks' partial cotangents; before a module the
    rules keep whole, the all-gather whose backward keeps the rank's
    block (every rank then computes the whole layer alike)."""
    if seq is not None:
        if sharded_on_model(module, attr, 0):
            return coll.all_gather(x, seq, MODEL_AXIS, 1)
        return coll.all_gather_same(x, seq, MODEL_AXIS, 1)
    if not sharded_on_model(module, attr, 0):
        return x
    return coll.copy_to(x, placement(module).mesh, MODEL_AXIS)


def vocab_block(module: nn.Module, attr: str, dim: int = 0
                ) -> tuple[int, int] | None:
    """(first row, rows) of the vocabulary this rank holds along ``dim``
    of ``module.attr``, or None where the vocabulary is not on "model"."""
    if not sharded_on_model(module, attr, dim):
        return None
    pl = placement(module)
    rows = getattr(module, attr).shape[dim]
    return pl.model_rank * rows, rows


# ---------------------------------------------------------------------------
# the attention's heads
# ---------------------------------------------------------------------------

class HeadPlan(NamedTuple):
    """What one rank of "model" computes of an attention layer.

    The rank holds q columns ``[q_cols[0], q_cols[0] + q_cols[1])`` and
    the same block of wo's input; it attends with the whole q heads
    ``q_heads`` (first, count) that cover them and the key / value heads
    ``kv_heads`` those use, grouped as without a mesh.  ``gather_q`` /
    ``gather_kv``: the projection's column blocks are not those whole
    heads, so the rank all-gathers them over "model" first."""

    q_cols: tuple[int, int]
    q_heads: tuple[int, int]
    kv_heads: tuple[int, int]
    gather_q: bool
    gather_kv: bool


def head_plan(cfg, m: int, r: int) -> HeadPlan:
    hd, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    qpk = hq // hkv
    cq, ck = hq * hd // m, hkv * hd // m
    if cq * m != hq * hd or ck * m != hkv * hd:
        raise ValueError(f"{cfg.name}: {hq} / {hkv} heads of {hd} do not "
                         f"split in columns over {m} ranks")
    q_lo, q_hi = r * cq // hd, ((r + 1) * cq - 1) // hd
    kv_lo, kv_hi = q_lo // qpk, q_hi // qpk
    nq, nk = q_hi - q_lo + 1, kv_hi - kv_lo + 1
    if nq % nk or any((q_lo + i) // qpk - kv_lo != i // (nq // nk)
                      for i in range(nq)):
        # no shipped config at any m that divides its columns: their q
        # heads a rank come in whole kv groups or within one
        raise ValueError(f"{cfg.name}: rank {r} of {m} holds q heads "
                         f"{q_lo}-{q_hi}, which split unevenly over their "
                         "kv heads")
    gather_kv = not (ck % hd == 0 and r * ck // hd == kv_lo
                     and ck // hd == nk)
    return HeadPlan((r * cq, cq), (q_lo, nq), (kv_lo, nk), cq % hd != 0,
                    gather_kv)


# ---------------------------------------------------------------------------
# the recurrent mixers' column pieces
# ---------------------------------------------------------------------------

class GatePlan(NamedTuple):
    """A rank's share of a projection whose ``parts`` x ``width`` columns
    (the concatenated parts: the Mamba's / mLSTM's (x | z), the sLSTM's
    [i | f | z | o]) the rules cut in m equal column blocks, beside
    ``width`` cut in m channel blocks of ``c`` each.

    ``channels``: (first, count) of the rank's channel block, which its
    states hold and whose every part it computes.  ``pieces``: the
    (part, channel block) of each c-wide piece of the rank's column
    block, in column order; channel block b is rank b's.  ``order``: the
    pieces' indices sorted by the rank they go to, and ``send`` / ``recv``
    the pieces the rank sends each rank and receives from each rank: one
    split all-to-all over "model" gives each rank every part of its own
    channel block, in part order."""

    channels: tuple[int, int]
    pieces: tuple[tuple[int, int], ...]
    order: tuple[int, ...]
    send: tuple[int, ...]
    recv: tuple[int, ...]


def gate_plan(parts: int, width: int, m: int, r: int, name: str = ""
              ) -> GatePlan | None:
    """Rank r of m's :class:`GatePlan`, or None where the columns do not
    divide over m (the rules keep the projection, and so every
    per-channel leaf and state beside it, whole on every rank).  Columns
    that divide where the channels do not (a column block that ends
    inside a channel block) raise."""
    if (parts * width) % m:
        return None
    if width % m:
        raise ValueError(f"{name}: {parts} x {width} columns divide over "
                         f"{m} ranks but the {width} channels do not: a "
                         "rank's columns would end inside another rank's "
                         "channel block")
    c, per = width // m, parts
    first = r * per                    # the rank's first c-wide piece
    pieces = tuple(divmod(j, m) for j in range(first, first + per))
    order = tuple(sorted(range(per), key=lambda i: pieces[i][1]))
    send = tuple(sum(1 for _, b in pieces if b == j) for j in range(m))
    # part p of channel block r sits in piece p * m + r, held by the rank
    # whose column block holds it
    owners = [(p * m + r) // per for p in range(parts)]
    recv = tuple(owners.count(j) for j in range(m))
    return GatePlan((r * c, c), pieces, order, send, recv)


class MLSTMPlan(NamedTuple):
    """A rank's share of an mLSTM layer: ``up``'s column pieces
    (:func:`gate_plan` over (x | z); the layer all-gathers them, as its
    head-wise products read every feature of a head), ``head_block``:
    (first, count) of each head's d_k (q, k, the states C and n) and d_v
    (v) the head-wise projections give the rank, and ``channels``: its
    block of d_in, ``down``'s row-parallel input."""

    up: GatePlan
    head_block: tuple[int, int]
    channels: tuple[int, int]


def mlstm_plan(n_heads: int, head_dim: int, m: int, r: int,
               name: str = "") -> MLSTMPlan | None:
    """Rank r of m's :class:`MLSTMPlan`, None where the rules keep the
    layer whole (``up``'s columns do not divide); a layout the port does
    not handle raises: d_in on "model" but the heads' width not (q, k, v
    and the states then whole beside a sharded ``down``), or a cache
    spec that puts the heads, not d_k, on "model" (more heads than
    their width: no config)."""
    d_in = n_heads * head_dim
    up = gate_plan(2, d_in, m, r, name)
    if up is None:
        return None
    if head_dim % m:
        raise ValueError(f"{name}: d_in = {d_in} divides over {m} ranks "
                         f"but the heads' width {head_dim} does not")
    if n_heads > head_dim:
        raise ValueError(f"{name}: {n_heads} heads of {head_dim}: the "
                         "cache's rule would put the heads on 'model'")
    w = head_dim // m
    return MLSTMPlan(up, (r * w, w), up.channels)


# ---------------------------------------------------------------------------
# the experts, the cache's slots and the batch's rows
# ---------------------------------------------------------------------------

class ExpertPlan(NamedTuple):
    """What one rank computes of a MoE layer's experts: experts ``first``
    to ``first + count`` whole (E on "model"), or every expert on its
    block of ``d_ff_expert`` (the col / row fallback).  ``mesh``: the
    mesh over whose "model" axis the rank's partial output is summed,
    None where the rank computes the whole output (no placement, or
    experts replicated)."""

    first: int
    count: int
    mesh: Mesh | None


def expert_plan(moe: nn.Module, num_experts: int) -> ExpertPlan:
    pl = placement(moe)
    if pl is None:
        return ExpertPlan(0, num_experts, None)
    gate = pl.specs["gate"]                  # (E, d, f)
    if MODEL_AXIS in _axes(gate[0]):
        count = num_experts // pl.model_size
        return ExpertPlan(pl.model_rank * count, count, pl.mesh)
    if MODEL_AXIS in _axes(gate[2]):
        return ExpertPlan(0, num_experts, pl.mesh)
    return ExpertPlan(0, num_experts, None)


class CachePlan(NamedTuple):
    """A rank's slots of one KV cache: it holds ``held`` (first slot,
    slots) and attends over ``attended``.  Where the capacity divides
    over "model" both are the rank's block of the sequence; where it does
    not, ``cache_pspec`` keeps the cache whole on every rank, each rank
    writes every slot and attends over its share of them, so the combine
    over "model" sees each slot once."""

    held: tuple[int, int]
    attended: tuple[int, int]


def cache_plan(capacity: int, m: int, r: int) -> CachePlan:
    if capacity % m == 0:
        s = capacity // m
        return CachePlan((r * s, s), (r * s, s))
    lo, hi = r * capacity // m, (r + 1) * capacity // m
    return CachePlan((0, capacity), (lo, hi - lo))


def data_rows(pl: Placement | None, rows: int,
              global_batch: int | None = None) -> tuple[int, int]:
    """(index, count) of this rank's block of the batch over the data
    axes (row-major, the first axis the slowest), for ``rows`` rows of a
    batch of ``global_batch``: their block where it is ``rows`` times the
    data ranks (None: so), (0, 1) where it is ``rows`` (the whole batch
    on every rank).  Any other ``global_batch`` raises."""
    n = 1 if pl is None else mesh_lib.data_axis_size(pl.mesh)
    if global_batch is None:
        global_batch = rows * n
    if global_batch == rows:
        return 0, 1
    if global_batch != rows * n:
        raise ValueError(f"{rows} rows are neither the batch of "
                         f"{global_batch} nor its block over {n} data "
                         "ranks")
    j = 0
    for a in mesh_lib.data_axes(pl.mesh):
        j = j * pl.mesh.shape[a] + pl.coords[a]
    return j, n
