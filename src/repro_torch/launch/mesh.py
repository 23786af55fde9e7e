"""The tenant mesh: the "tenants" axis a sharded transform bank spans.

The reference builds a 1-D JAX mesh of S devices and launches the banked
kernel once per device through ``shard_map``.  The port's mesh is S shards
on ONE torch device: every shard's sub-bank lives on that device, and the
sharded dispatcher (``serving/server.py::ShardedBankDispatcher``) scores all
of them in one launch of the banked kernel.  That is the port's counterpart
of the reference's S forced host devices on one CPU.  A mesh over several
cards (one launch a card) is ROADMAP Queue 1 item 11b and raises here.

Only the tenant part of the reference's ``launch/mesh.py`` is ported.  The
pod meshes belong to a mesh over several cards (ROADMAP Queue 1 items 13f
and 11b); the one-card roofline takes the H100's rates in place of the
TPU's peak constants (``launch/roofline.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core.transforms import TENANT_AXIS
from repro_torch.device import resolve_device


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
    ``NotImplementedError`` (ROADMAP Queue 1 item 11b).
    """
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if isinstance(device, (list, tuple)):
        devices = {resolve_device(d) for d in device}
        if len(devices) > 1:
            raise NotImplementedError(
                "a tenant mesh over several cards (one launch a card) is not "
                "ported yet (ROADMAP Queue 1 item 11b)")
        if not devices:
            raise ValueError("no device given")
        (dev,) = devices
    else:
        dev = resolve_device(device)
    return TenantMesh(num_shards, dev)


def tenant_axis_size(mesh: TenantMesh) -> int:
    return mesh.shape.get(TENANT_AXIS, 1)
