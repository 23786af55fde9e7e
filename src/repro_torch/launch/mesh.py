"""Meshes: the production pod meshes, the host mesh, and the tenant mesh.

Production meshes (the reference's ``launch/mesh.py``):

  single pod: 256 ranks as ("data", "model") = (16, 16);
  multi-pod:  512 ranks as ("pod", "data", "model") = (2, 16, 16), "pod"
              an outer data-parallel axis.

A :class:`Mesh` is axis names and sizes.  Made by
:func:`make_production_mesh` or :func:`make_host_mesh` it is shape-only:
the sharding rules (``launch/shardings.py``) and the dry-run read its
shape, and a collective on meta tensors (``launch/collectives.py``) only
counts.  :func:`init_mesh` makes one live over the initialised process
group: a ``torch.distributed`` device mesh with one group an axis, on the
card with NCCL unless the caller asks for the CPU, where it runs over gloo.
:func:`set_mesh` makes a mesh the active one, the counterpart of
``jax.set_mesh``, which the all-to-all MoE (``models/moe_a2a.py``) needs.

The TPU's peak constants are not carried over: the one-card roofline takes
the H100's published rates (``launch/roofline.py``).

The tenant mesh is S shards of the "tenants" axis over P placements, one
torch device each (``S % P == 0``): shard ``s`` lives on placement
``s // (S / P)``.  Each placement holds only its shards' rows of a sharded
bank, and the sharded dispatcher
(``serving/server.py::ShardedBankDispatcher``) scores a window with one
launch of the banked kernel a placement.  Two placements may name the same
device, as the reference's forced host devices share one CPU: the whole
path then runs on one card (or on the CPU) as it runs over several.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Iterator, Sequence

import torch

from repro_torch.core.transforms import TENANT_AXIS
from repro_torch.device import resolve_device

DATA_AXES = ("pod", "data")
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes of ranks; live where ``device_mesh`` is set."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    device_mesh: Any = dataclasses.field(default=None, compare=False)

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as a JAX mesh's ``shape`` reads."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def live(self) -> bool:
        return self.device_mesh is not None

    def group(self, axis: str):
        """The process group of ``axis`` that holds this rank."""
        if not self.live:
            raise RuntimeError(f"mesh {self.shape} is shape-only: make it "
                               "live with init_mesh()")
        return self.device_mesh.get_group(axis)

    def coords(self) -> dict[str, int]:
        """This rank's index along each axis; rank 0's (all 0) on a
        shape-only mesh, which the dry run of one rank takes."""
        if not self.live:
            return {a: 0 for a in self.axis_names}
        return dict(zip(self.axis_names, self.device_mesh.get_coordinate()))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh(("pod", "data", MODEL_AXIS), (2, 16, 16))
    return Mesh(("data", MODEL_AXIS), (16, 16))


def make_host_mesh() -> Mesh:
    """One rank with the production axis names."""
    return Mesh(("data", MODEL_AXIS), (1, 1))


def init_mesh(mesh: Mesh, device: torch.device | str | None = None) -> Mesh:
    """``mesh`` made live over the initialised default process group, whose
    world must be ``mesh.size`` ranks: rank r sits at the row-major
    coordinate r.  The device is the card unless the caller asks for the
    CPU; the card takes NCCL, the CPU gloo, and another backend raises."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("init_mesh needs torch.distributed."
                           "init_process_group first")
    want = {"cuda": "nccl", "cpu": "gloo"}.get(dev.type)
    backend = dist.get_backend()
    if backend != want:
        raise RuntimeError(f"a mesh on {dev.type} runs over {want}, not "
                           f"{backend}")
    if dist.get_world_size() != mesh.size:
        raise ValueError(f"mesh {mesh.shape} needs {mesh.size} ranks, the "
                         f"world has {dist.get_world_size()}")
    dm = init_device_mesh(dev.type, mesh.axis_sizes,
                          mesh_dim_names=mesh.axis_names)
    return dataclasses.replace(mesh, device_mesh=dm)


_ACTIVE: contextvars.ContextVar[Mesh | None] = contextvars.ContextVar(
    "active_mesh", default=None)


@contextlib.contextmanager
def set_mesh(mesh: Mesh) -> Iterator[Mesh]:
    """Make ``mesh`` the active mesh inside the ``with`` block."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def get_active_mesh() -> Mesh | None:
    return _ACTIVE.get()


def data_axes(mesh) -> tuple[str, ...]:
    """The batch-sharding axes of ``mesh`` (('pod', 'data') or ('data',));
    ``mesh`` is anything with ``axis_names``, a JAX mesh too."""
    return tuple(a for a in mesh.axis_names if a in DATA_AXES)


def model_axis_size(mesh) -> int:
    return mesh.shape.get(MODEL_AXIS, 1)


def data_axis_size(mesh) -> int:
    return math.prod(mesh.shape[a] for a in data_axes(mesh))


# ---------------------------------------------------------------------------
# the tenant mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TenantMesh:
    """``num_shards`` shards of the "tenants" axis in contiguous blocks over
    ``placements``, one device each; ``device`` is the first placement's,
    where results gather and a server's own tensors live."""

    num_shards: int
    placements: tuple[torch.device, ...]
    axis_name: str = TENANT_AXIS

    def __post_init__(self) -> None:
        if self.num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {self.num_shards}")
        if not self.placements:
            raise ValueError("a tenant mesh needs at least one placement")
        if self.num_shards % len(self.placements):
            raise ValueError(
                f"{self.num_shards} shards do not split evenly over "
                f"{len(self.placements)} placements")
        for d in self.placements:
            if d.type == "meta":
                raise ValueError(f"a placement on {d} holds no rows")
        if len({d.type for d in self.placements}) > 1:
            raise ValueError("placements mix device types: "
                             f"{[str(d) for d in self.placements]}")

    @property
    def device(self) -> torch.device:
        return self.placements[0]

    @property
    def num_placements(self) -> int:
        return len(self.placements)

    @property
    def shards_per_placement(self) -> int:
        return self.num_shards // len(self.placements)

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as a JAX mesh's ``shape`` reads."""
        return {self.axis_name: self.num_shards}


def make_tenant_mesh(
    num_shards: int,
    device: torch.device | str | Sequence[torch.device | str] | None = None,
) -> TenantMesh:
    """1-D serving mesh over the "tenants" axis (sharded transform banks).

    ``device`` is one device (one placement holding every shard), a
    sequence of P devices (P placements, repeats allowed), or ``None``: the
    reference's layout over the visible cards, P the largest divisor of
    ``num_shards`` that is at most ``torch.cuda.device_count()``, on
    ``cuda:0`` ... ``cuda:P-1`` (raises without a card).  ``num_shards %
    P != 0``, a placement on ``meta`` and placements of mixed device types
    raise ``ValueError``.
    """
    if isinstance(device, (list, tuple)):
        placements = tuple(_placement(d) for d in device)
    elif device is None:
        resolve_device(None)          # raises without a card
        p = max((d for d in range(1, torch.cuda.device_count() + 1)
                 if num_shards % d == 0), default=1)
        placements = tuple(torch.device("cuda", i) for i in range(p))
    else:
        placements = (_placement(device),)
    return TenantMesh(num_shards, placements)


def _placement(device: torch.device | str) -> torch.device:
    """A placement's device; a card named without its index is the current
    one, named by index, so a placement equals its tensors' device."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None \
            and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def tenant_axis_size(mesh: TenantMesh) -> int:
    return mesh.shape.get(TENANT_AXIS, 1)
