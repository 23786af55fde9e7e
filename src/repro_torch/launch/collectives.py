"""The port's collectives, and a tally of what they move.

Every collective the port issues goes through this module: an all-to-all,
an all-gather, a reduce-scatter or an all-reduce over one axis of a
:class:`~repro_torch.launch.mesh.Mesh`.  The reference reads its
collectives out of XLA's compiled HLO (``launch/hlo_costs.py``), weighting
each by the trip counts of the loops around it.  The port has no HLO, so it
counts at the source: while a :func:`tally` is active, each call adds its
result's per-device bytes and one count under the reference's kind names
(``_COLLECTIVE_RE`` / ``_shape_bytes``: a result's bytes, each op once).  A
Python loop over layers counts every call, so no trip count is needed.

On meta tensors the functions return outputs of the right shape and only
count, with no process group: the dry run of one rank of a pod mesh.  That
path is chosen by the tensor's device.

Over an axis of one rank the all-gather, reduce-scatter and all-reduce are
still issued, and an all-to-all is not: the reference's compiled program
keeps the first three and drops the last (``tests/test_torch_moe_a2a.py``
holds the tally to it op for op).

The differentiable forms are ``torch.autograd.Function``s whose backward is
the adjoint collective: an all-to-all's is the reverse all-to-all (the same
exchange), an all-gather's a reduce-scatter and a reduce-scatter's an
all-gather.  An all-reduce's result is the same on every rank and each rank
takes its cotangent as the cotangent of that one value (a loss every rank
computes alike), so its backward passes the cotangent through: Megatron's
"g".  :func:`copy_to` is its "f", the identity forward whose backward
all-reduces: a replicated activation entering a column-parallel layer, or
a replicated parameter used on a rank's share of the heads, gets on every
rank the sum of the ranks' partial cotangents.  :func:`all_reduce_sum`
all-reduces both ways: the adjoint of a sum that every rank's share of
the objective uses (the MoE's global means over the data ranks, the
mLSTM's normaliser).  Each collective's backward follows from whether
its result's cotangent is the same on every rank: an all-gather whose
result every rank uses alike (:func:`all_gather_same`, the sLSTM's
gathered weights) keeps the rank's block of that cotangent and
exchanges nothing, where :func:`all_gather`, whose ranks use the result
each on their own share, reduce-scatters it.

:func:`split` is the adjoint of the all-gather whose result every rank
uses alike: the rank's chunk forward, the all-gather of the chunks'
cotangents backward (a replicated tensor cut to the rank's block of the
sequence, Megatron's "scatter to the sequence-parallel region").
:func:`once` passes a replicated value through and, backward, keeps its
cotangent on rank 0 of the axis only (zeros elsewhere): where every rank
computes the value alike but the cotangents around it are the ranks'
partials, whose sum is then the whole.

:func:`all_to_all_split` is the all-to-all with a split size a rank: the
pieces a rank sends each rank are any number of rows of dim 0, as the
Mamba's x / z exchange and the sLSTM decode's gate exchange need
(``models/parallel.py::gate_plan``); its backward is the reverse
exchange.

The tally is one stack for the process, not a context variable: on the
card autograd runs the backward (and the recompute of a remat group) on
a thread of its own, whose collectives count all the same.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator

import torch

from repro_torch.launch.mesh import Mesh

@dataclasses.dataclass(eq=False)
class Collectives:
    """Per-device collective bytes and counts by kind (the reference's
    ``HloCollectives``).  ``static_count`` is every call counted.  Two
    tallies are equal only if they are the same object, so an open tally
    is found by identity."""

    bytes_by_kind: dict[str, float] = dataclasses.field(default_factory=dict)
    count_by_kind: dict[str, float] = dataclasses.field(default_factory=dict)
    static_count: int = 0

    def add(self, kind: str, nbytes: int) -> None:
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0.0) + nbytes
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0.0) + 1
        self.static_count += 1

    def weighted_bytes(self, factors: dict[str, float]) -> float:
        return sum(factors.get(k, 1.0) * v
                   for k, v in self.bytes_by_kind.items())

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())


_TALLIES: list[Collectives] = []


@contextlib.contextmanager
def tally() -> Iterator[Collectives]:
    """Count every collective issued inside the ``with`` block (nested
    blocks each count it)."""
    counts = Collectives()
    _TALLIES.append(counts)
    try:
        yield counts
    finally:
        _TALLIES.remove(counts)


def _count(kind: str, result: torch.Tensor) -> torch.Tensor:
    for counts in _TALLIES:
        counts.add(kind, result.numel() * result.element_size())
    return result


def _front(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x.movedim(dim, 0).contiguous()


# ---------------------------------------------------------------------------
# the collectives (no autograd)
# ---------------------------------------------------------------------------

def all_to_all_raw(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Dim 0 of ``x`` in ``n`` equal chunks, chunk j to rank j of ``axis``;
    dim 0 of the result is the chunk each rank sent here, by rank."""
    n = mesh.shape[axis]
    if x.shape[0] % n:
        raise ValueError(f"dim 0 ({x.shape[0]}) is not a multiple of "
                         f"{axis}'s {n} ranks")
    if n == 1:
        return x
    if x.device.type == "meta":
        return _count("all-to-all", torch.empty_like(x))
    import torch.distributed as dist

    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=mesh.group(axis))
    return _count("all-to-all", out)


def all_to_all_split_raw(x: torch.Tensor, mesh: Mesh, axis: str,
                        send: list[int], recv: list[int]) -> torch.Tensor:
    """Rows of dim 0 of ``x``, ``send[j]`` of them (in order) to rank j of
    ``axis``; dim 0 of the result is the ``recv[j]`` rows each rank j sent
    here, by rank.  Over one rank it is ``x`` (not issued)."""
    n = mesh.shape[axis]
    if len(send) != n or len(recv) != n or sum(send) != x.shape[0]:
        raise ValueError(f"splits {send} / {recv} of {x.shape[0]} rows "
                         f"over {axis}'s {n} ranks")
    if n == 1:
        return x
    shape = (sum(recv),) + tuple(x.shape[1:])
    if x.device.type == "meta":
        return _count("all-to-all", x.new_empty(shape))
    import torch.distributed as dist

    out = x.new_empty(shape)
    dist.all_to_all_single(out, x.contiguous(), list(recv), list(send),
                           group=mesh.group(axis))
    return _count("all-to-all", out)


def all_gather_raw(x: torch.Tensor, mesh: Mesh, axis: str, dim: int
                   ) -> torch.Tensor:
    """Every rank's ``x`` of ``axis`` concatenated along ``dim``, by rank
    (contiguous)."""
    n = mesh.shape[axis]
    shape = list(x.shape)
    shape[dim] *= n
    if x.device.type == "meta":
        return _count("all-gather", x.new_empty(shape))
    import torch.distributed as dist

    src = _front(x, dim)
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=mesh.group(axis))
    return _count("all-gather", out.movedim(0, dim).contiguous())


def reduce_scatter_raw(x: torch.Tensor, mesh: Mesh, axis: str, dim: int
                       ) -> torch.Tensor:
    """The sum over the ranks of ``axis`` of their ``x``, split in equal
    chunks along ``dim``: chunk j to rank j (contiguous)."""
    n = mesh.shape[axis]
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} ({x.shape[dim]}) is not a multiple of "
                         f"{axis}'s {n} ranks")
    shape = list(x.shape)
    shape[dim] //= n
    if x.device.type == "meta":
        return _count("reduce-scatter", x.new_empty(shape))
    import torch.distributed as dist

    src = _front(x, dim)
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=mesh.group(axis))
    return _count("reduce-scatter", out.movedim(0, dim).contiguous())


def all_reduce_raw(x: torch.Tensor, mesh: Mesh, axis: str, op: str = "sum"
                   ) -> torch.Tensor:
    """The sum (or, ``op="max"``, the largest) over the ranks of ``axis``
    of their ``x`` (a new tensor)."""
    if x.device.type == "meta":
        return _count("all-reduce", torch.empty_like(x))
    out = x.clone(memory_format=torch.contiguous_format)
    return all_reduce_(out, mesh, axis, op)


def all_reduce_(x: torch.Tensor, mesh: Mesh, axis: str, op: str = "sum"
                ) -> torch.Tensor:
    """:func:`all_reduce_raw` into ``x`` itself (contiguous), as the
    data-parallel reduction of the gradients does."""
    if x.device.type == "meta":
        return _count("all-reduce", x)
    import torch.distributed as dist

    dist.all_reduce(x, op={"sum": dist.ReduceOp.SUM,
                           "max": dist.ReduceOp.MAX}[op],
                    group=mesh.group(axis))
    return _count("all-reduce", x)


# ---------------------------------------------------------------------------
# differentiable forms
# ---------------------------------------------------------------------------

class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_to_all_raw(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return all_to_all_raw(g, ctx.mesh, ctx.axis), None, None


class _AllToAllSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, send, recv):
        ctx.mesh, ctx.axis, ctx.send, ctx.recv = mesh, axis, send, recv
        return all_to_all_split_raw(x, mesh, axis, send, recv)

    @staticmethod
    def backward(ctx, g):
        return (all_to_all_split_raw(g, ctx.mesh, ctx.axis, ctx.recv,
                                     ctx.send), None, None, None, None)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather_raw(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter_raw(g, ctx.mesh, ctx.axis, ctx.dim), None,
                None, None)


class _AllGatherSame(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.dim, ctx.n, ctx.rows = dim, mesh.shape[axis], x.shape[dim]
        ctx.index = (mesh.coords()[axis] if mesh.live else 0)
        return all_gather_raw(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.index * ctx.rows, ctx.rows), None,
                None, None)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return reduce_scatter_raw(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (all_gather_raw(g, ctx.mesh, ctx.axis, ctx.dim), None, None,
                None)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce_raw(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_reduce_raw(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_raw(g, ctx.mesh, ctx.axis), None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_raw(g, ctx.mesh, ctx.axis), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return chunk_of(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (all_gather_raw(g, ctx.mesh, ctx.axis, ctx.dim), None, None,
                None)


class _Once(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.keep = mesh.coords()[axis] == 0
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.keep else torch.zeros_like(g)), None, None


def _tracked(x: torch.Tensor) -> bool:
    """Whether autograd follows ``x``: outside it (a decode step, a
    prefill) the raw collective runs without a Function's cost a call."""
    return torch.is_grad_enabled() and x.requires_grad


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    if mesh.shape[axis] == 1 or not _tracked(x):
        return all_to_all_raw(x, mesh, axis)
    return _AllToAll.apply(x, mesh, axis)


def all_to_all_split(x: torch.Tensor, mesh: Mesh, axis: str,
                     send: list[int], recv: list[int]) -> torch.Tensor:
    if mesh.shape[axis] == 1 or not _tracked(x):
        return all_to_all_split_raw(x, mesh, axis, send, recv)
    return _AllToAllSplit.apply(x, mesh, axis, tuple(send), tuple(recv))


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int
               ) -> torch.Tensor:
    if not _tracked(x):
        return all_gather_raw(x, mesh, axis, dim)
    return _AllGather.apply(x, mesh, axis, dim)


def all_gather_same(x: torch.Tensor, mesh: Mesh, axis: str, dim: int
                    ) -> torch.Tensor:
    """The all-gather of a block whose whole every rank of ``axis`` uses
    alike, so that the whole's cotangent is the same on every rank: the
    backward keeps this rank's block of it (no collective)."""
    if not _tracked(x):
        return all_gather_raw(x, mesh, axis, dim)
    return _AllGatherSame.apply(x, mesh, axis, dim)


def reduce_scatter(x: torch.Tensor, mesh: Mesh, axis: str, dim: int
                   ) -> torch.Tensor:
    if not _tracked(x):
        return reduce_scatter_raw(x, mesh, axis, dim)
    return _ReduceScatter.apply(x, mesh, axis, dim)


def all_reduce(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    if not _tracked(x):
        return all_reduce_raw(x, mesh, axis)
    return _AllReduce.apply(x, mesh, axis)


def all_reduce_sum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum over the ranks of ``axis`` whose backward is the same sum
    of the cotangents: the adjoint where the objective is the sum of the
    ranks' objectives, each of which uses the result (the MoE's global
    means over the data ranks under the data-parallel loss scale).
    :func:`all_reduce` is Megatron's "g" instead, whose ranks' cotangents
    are each the whole."""
    if not _tracked(x):
        return all_reduce_raw(x, mesh, axis)
    return _AllReduceSum.apply(x, mesh, axis)


def chunk_of(x: torch.Tensor, mesh: Mesh, axis: str, dim: int
             ) -> torch.Tensor:
    """This rank's chunk of ``dim`` cut in equal chunks over the ranks of
    ``axis``, in rank order (contiguous; no collective)."""
    n = mesh.shape[axis]
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} ({x.shape[dim]}) is not a multiple of "
                         f"{axis}'s {n} ranks")
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.coords()[axis] * size, size).contiguous()


def split(x: torch.Tensor, mesh: Mesh, axis: str, dim: int
          ) -> torch.Tensor:
    """:func:`chunk_of` a tensor every rank of ``axis`` holds alike; its
    backward all-gathers the chunks' cotangents, so the whole cotangent
    is the same on every rank."""
    if not _tracked(x):
        return chunk_of(x, mesh, axis, dim)
    return _Split.apply(x, mesh, axis, dim)


def once(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``x`` forward; backward its cotangent on rank 0 of ``axis`` and
    zeros on the others, so a sum over the ranks counts it once."""
    if not _tracked(x):
        return x
    return _Once.apply(x, mesh, axis)


def copy_to(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Megatron's "f": ``x`` itself forward, the all-reduce of its
    cotangent over ``axis`` backward.  Outside autograd it is ``x``."""
    if not _tracked(x):
        return x
    return _CopyTo.apply(x, mesh, axis)
