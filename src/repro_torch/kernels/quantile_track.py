"""Fused device quantile tracking: score -> transform -> track on the device.

The track stage (``MuseServer.track``) in its eager form copies each
window's posterior-corrected aggregate to the host and runs one numpy
reservoir update per (tenant, predictor) stream.  With a
:class:`DeviceQuantileTracker` the hot path stays on the device:

* :func:`_fused_append` computes the banked ``pre_quantile`` aggregate with
  :func:`repro_torch.core.transforms._banked_pre_quantile` (the op sequence
  the eager path runs, so the two agree bitwise) and copies each row into a
  per-stream slot of one flat float32 staging tensor, in place.  No host
  transfer, no per-stream Python on the hot path.
* :class:`DeviceQuantileTracker` owns the staging tensor and the host
  bookkeeping that makes the deferred host materialization BITWISE equal
  to eager tracking, RNG state included.

Port of the reference package's ``kernels/quantile_track.py``: its two XLA
programs become in-place torch ops (``index_copy_`` into the staging
tensor), and the planning, spill, fallback and drain logic is the same line
for line, so the counters and estimator states agree across the packages.

Exactness contract (why replay is bitwise, not approximate):

* Per-stream estimators are independent, and a
  :class:`~repro_torch.core.quantiles.StreamingQuantileEstimator`'s state
  after a sequence of ``update`` calls depends only on the sample values
  and the UPDATE-CALL BOUNDARIES (the recent ring resets on >= capacity
  bulk writes and the PCG64 draws are consumed per overflow batch).  The
  eager path issues exactly one ``update`` per stream per window.
* The tracker therefore records, per stream, the cumulative sample count at
  every window boundary.  Draining replays ``update`` once per ORIGINAL
  window chunk, in arrival order, against the same host estimator class.
* Scatter indices are ``slot * capacity + pending + within-window rank`` —
  unique by construction, so the copy is deterministic.

Host pulls happen ONLY at the calibration boundary: a stream spills when its
staging would overflow, and the calibration plane (Eq.-5 gating, snapshots,
checkpoints) calls :meth:`DeviceQuantileTracker.sync` before reading
estimators; each drain is one device-to-host copy.  Thread-safety: the
owner (``MuseServer``) serializes every tracker call under its estimator
lock; the tracker itself is not locked.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.transforms import _banked_pre_quantile
from repro_torch.device import resolve_device

# chunks replayed at drain time must respect the estimator's documented
# per-update-call bound; windows are far smaller in practice (engine cap)
DEFAULT_STAGING = 4096


def _fused_append(staging: torch.Tensor, flat_idx: torch.Tensor,
                  expert_scores: torch.Tensor, tenant_idx: torch.Tensor,
                  betas: torch.Tensor, weights: torch.Tensor) -> None:
    """score -> transform -> track: the aggregate of each row, copied into
    ``staging`` (the flat ``(slots * capacity,)`` float32 plane) at
    ``flat_idx``, in place.  The aggregate is ``_banked_pre_quantile``'s —
    bitwise the value the eager path pulls to the host."""
    agg = _banked_pre_quantile(expert_scores, tenant_idx, betas, weights)
    staging.index_copy_(0, flat_idx, agg)


def _staged_append(staging: torch.Tensor, flat_idx: torch.Tensor,
                   agg: torch.Tensor) -> None:
    """Copy an already-computed aggregate into ``staging`` at ``flat_idx``."""
    staging.index_copy_(0, flat_idx, agg.to(torch.float32))


def _segment_plan(slots: np.ndarray) -> tuple[np.ndarray, np.ndarray,
                                              np.ndarray]:
    """Vectorized per-window segment bookkeeping over the row->slot vector.

    Returns ``(ranks, uniq_slots, incoming)``: each row's 0-based arrival
    rank within its stream, the unique slots present, and the per-unique-
    slot row counts.  Stable sort keeps arrival order inside a stream —
    the property the bitwise replay contract rests on."""
    b = len(slots)
    order = np.argsort(slots, kind="stable")
    sorted_slots = slots[order]
    new_seg = np.r_[True, sorted_slots[1:] != sorted_slots[:-1]]
    seg_start = np.flatnonzero(new_seg)
    ranks_sorted = np.arange(b, dtype=np.int64) - \
        np.repeat(seg_start, np.diff(np.r_[seg_start, b]))
    ranks = np.empty(b, dtype=np.int64)
    ranks[order] = ranks_sorted
    return ranks, sorted_slots[seg_start], np.diff(np.r_[seg_start, b])


class DeviceQuantileTracker:
    """Device staging plane for per-(tenant, predictor) quantile streams.

    ``apply(key, chunks)`` is the host-materialization callback: it must
    route each chunk list into the stream's estimator via one ``update``
    call per chunk (see ``StreamingQuantileEstimator.apply_chunks``).  The
    staging tensor lives on ``device``: the card when it is None (and a
    machine without one raises), as every entry point of the port.  The
    owner calls every method under one lock.
    """

    def __init__(self, apply: Callable[[tuple, list[np.ndarray]], None], *,
                 staging_capacity: int = DEFAULT_STAGING,
                 initial_slots: int = 64,
                 device: torch.device | str | None = None) -> None:
        if staging_capacity < 1:
            raise ValueError("staging_capacity must be >= 1")
        self.capacity = int(staging_capacity)
        self.device = resolve_device(device)
        self._apply = apply
        self._slots: dict[tuple, int] = {}        # stream key -> slot
        self._slot_key: dict[int, tuple] = {}
        self._free: list[int] = []
        self._num_slots = int(initial_slots)
        self._counts = np.zeros(self._num_slots, dtype=np.int64)
        # per-slot cumulative sample counts at each appended window's end —
        # the replay boundaries that make drain bitwise-equal to eager
        self._bounds: list[list[int]] = [[] for _ in range(self._num_slots)]
        self._staging = torch.zeros(self._num_slots * self.capacity,
                                    dtype=torch.float32, device=self.device)
        # observability: spills (staging-full drains), windows that fell
        # back to the eager host path because one stream outsized the
        # plane, windows staged, and drains (device-to-host copies)
        self.spills = 0
        self.host_fallbacks = 0
        self.appends = 0
        self.drains = 0

    # ------------------------------------------------------------- capacity
    def _alloc(self, key: tuple) -> int:
        if self._free:
            slot = self._free.pop()
        else:
            slot = len(self._slots)
            if slot >= self._num_slots:
                self._grow(slot + 1)
        self._slots[key] = slot
        self._slot_key[slot] = key
        return slot

    def _grow(self, needed: int) -> None:
        new_n = self._num_slots
        while new_n < needed:
            new_n *= 2   # doubling bounds the reallocations to O(log streams)
        pad = (new_n - self._num_slots) * self.capacity
        self._staging = torch.cat(
            [self._staging, self._staging.new_zeros(pad)])
        self._counts = np.concatenate(
            [self._counts, np.zeros(new_n - self._num_slots, np.int64)])
        self._bounds.extend([] for _ in range(new_n - self._num_slots))
        self._num_slots = new_n

    # --------------------------------------------------------------- append
    def _plan(self, keys: list[tuple]) -> torch.Tensor | None:
        """Spill-aware scatter plan for one window, as int64 indices on the
        device; None => host fallback.

        Updates counts/bounds as if the append already happened, so the
        caller MUST follow a non-None plan with the device copy."""
        slots = np.empty(len(keys), dtype=np.int64)
        for j, key in enumerate(keys):
            s = self._slots.get(key)
            slots[j] = self._alloc(key) if s is None else s
        ranks, uniq, incoming = _segment_plan(slots)
        if int(incoming.max()) > self.capacity:
            # one stream's share of this window outsizes the whole staging
            # plane — drain its history first (order!), then let the caller
            # take the eager path for the entire window
            self.host_fallbacks += 1
            self._drain_slots(uniq)
            return None
        over = uniq[self._counts[uniq] + incoming > self.capacity]
        if len(over):
            self.spills += 1
            self._drain_slots(over)
        flat_idx = slots * self.capacity + self._counts[slots] + ranks
        self._counts[uniq] += incoming
        for s, inc in zip(uniq, incoming):
            self._bounds[s].append(int(self._counts[s]))
        self.appends += 1
        return torch.from_numpy(flat_idx).to(self.device)

    def append_fused(self, keys: list[tuple], expert_scores: torch.Tensor,
                     tenant_idx: torch.Tensor, bank: Any) -> bool:
        """Stage one window through the fused path: ``expert_scores`` (B, K)
        float32 and ``tenant_idx`` (B,) on the tracker's device, indexing
        ``bank``'s rows.

        Returns False when the window must take the eager host path (a
        single stream larger than the staging plane)."""
        if not keys:
            return True
        flat_idx = self._plan(keys)
        if flat_idx is None:
            return False
        _fused_append(self._staging, flat_idx, expert_scores, tenant_idx,
                      bank.betas, bank.weights)
        return True

    def append_agg(self, keys: list[tuple], agg: Any) -> bool:
        """Stage one window whose aggregate is already computed."""
        if not keys:
            return True
        flat_idx = self._plan(keys)
        if flat_idx is None:
            return False
        _staged_append(self._staging, flat_idx,
                       torch.as_tensor(agg, device=self.device))
        return True

    # ---------------------------------------------------------------- drain
    def _drain_slots(self, slots: Any) -> int:
        todo = [int(s) for s in slots if self._counts[s] > 0]
        if not todo:
            return 0
        host = self._staging.cpu().numpy()   # ONE device->host copy
        self.drains += 1
        drained = 0
        for s in todo:
            n = int(self._counts[s])
            scores = host[s * self.capacity : s * self.capacity + n].copy()
            chunks = np.split(scores, self._bounds[s][:-1])
            self._apply(self._slot_key[s], chunks)
            self._counts[s] = 0
            self._bounds[s] = []
            drained += n
        return drained

    def sync(self) -> int:
        """Materialize every staged sample into its host estimator (the
        calibration plane's host-pull boundary).  Returns samples drained."""
        return self._drain_slots(np.flatnonzero(self._counts > 0))

    # ------------------------------------------------------------ ownership
    def pending(self, key: tuple) -> int:
        """Samples staged on device but not yet in the host estimator."""
        s = self._slots.get(key)
        return 0 if s is None else int(self._counts[s])

    def pending_total(self) -> int:
        return int(self._counts.sum())

    def drop_where(self, predicate: Callable[[tuple], bool]) -> int:
        """Discard streams (staged data included) whose key matches —
        decommission support: a dead predictor's staged samples must never
        materialize into a revived stream."""
        dead = [k for k in self._slots if predicate(k)]
        for key in dead:
            slot = self._slots.pop(key)
            del self._slot_key[slot]
            self._counts[slot] = 0
            self._bounds[slot] = []
            self._free.append(slot)
        return len(dead)
