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

The tenant mesh is S shards of the "tenants" axis on ONE torch device:
every shard's sub-bank lives on that device, and the sharded dispatcher
(``serving/server.py::ShardedBankDispatcher``) scores all of them in one
launch of the banked kernel.  That is the port's counterpart of the
reference's S forced host devices on one CPU.  A tenant mesh over several
cards (one launch a card) raises (:data:`SEVERAL_CARDS`).
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

# what is not ported yet, named as ROADMAP Queue 1 names it
SEVERAL_CARDS = ("ROADMAP Queue 1 item 11b, the tenant mesh over several "
                 "cards")

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
    """``num_shards`` shards of the "tenants" axis, all on ``device``."""

    num_shards: int
    device: torch.device
    axis_name: str = TENANT_AXIS

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as a JAX mesh's ``shape`` reads."""
        return {self.axis_name: self.num_shards}


def make_tenant_mesh(
    num_shards: int,
    device: torch.device | str | Sequence[torch.device | str] | None = None,
) -> TenantMesh:
    """1-D serving mesh over the "tenants" axis (sharded transform banks).

    ``device`` is where every shard lives: the card unless the caller asks
    for another device.  A sequence of devices names one per shard; more
    than one distinct device is a mesh over several cards, which raises
    ``NotImplementedError`` (:data:`SEVERAL_CARDS`).
    """
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if isinstance(device, (list, tuple)):
        devices = {resolve_device(d) for d in device}
        if len(devices) > 1:
            raise NotImplementedError(
                "a tenant mesh over several cards (one launch a card) is not "
                f"ported yet: {SEVERAL_CARDS}")
        if not devices:
            raise ValueError("no device given")
        (dev,) = devices
    else:
        dev = resolve_device(device)
    return TenantMesh(num_shards, dev)


def tenant_axis_size(mesh: TenantMesh) -> int:
    return mesh.shape.get(TENANT_AXIS, 1)
