"""Tiered tenant-bank store: hot device rows, host-paged cold rows, priors.

The fully-resident bank is the wall past ~10^5 tenants: every (tenant,
predictor) transform row costs ``(2K+2N)·4`` device bytes, forever.  This
module breaks that coupling with a three-tier store in which device
residency is bounded by CONFIGURATION, not by tenant count:

  * **hot tier** — the ``hot_capacity`` hottest tenants' rows live in a
    device bank (the row layout the banked kernel dispatches against) and
    are only ever moved by an explicit control-plane
    :meth:`TieredBankStore.rebalance`;
  * **victim cache** — a bounded ``victim_capacity``-slot device ring where
    cold tenants' rows are staged on demand (clock eviction).  The async
    engine prefetches pending windows' rows into it
    (:meth:`TieredBankStore.prefetch`) so the dispatch normally never blocks
    on a host read; a miss that *does* reach dispatch is staged
    synchronously and counted as a ``cold_miss_stall``;
  * **cold-start prior** — tenants that have not yet passed the Eq.-5
    sample-size gate (paper Sec. 2.4) score through ONE shared prior row
    (``core/coldstart.py``) pinned in the last device slot.  Once a
    tenant's observed stream reaches ``required_sample_size(a, δ, z)``
    events, the next ``rebalance`` admits it to its own (host) row.

The authoritative copy of EVERY row is the host-memory
:class:`HostBankStore` (numpy); the device bank holds exactly
``hot_capacity + victim_capacity + 1`` rows regardless of tenant count.  A
dispatch maps tenant ids to device SLOTS and launches the same banked kernel
(``kernels/ops.score_pipeline_banked``) as the dense path — per-row compute
is independent of bank size and row order, and the slot vector is
edge-padded as the dense server pads its tenant vector, so tiered scores
equal a dense bank built from the same rows BITWISE.

The tier bookkeeping (slot maps, clock hand, hotness, Eq.-5 admission,
generation fencing, every counter) is the reference's
(``repro/serving/tiering.py``) line for line, so the two stores fed the same
sequence of dispatches, prefetches, rebalances and publishes hold the same
slot maps and counters.  The device side is PyTorch's:

A view is immutable
-------------------

:class:`_TierView` is one device-bank snapshot, swapped by reference under
the store lock (staging, rebalance, publish).  A new view is built from the
old one by ``clone`` + ``index_copy_`` into fresh tensors; no view is ever
written in place, since a dispatch on another thread may hold the old view
with a kernel still reading it.  A dispatch that captured a view scores
every row of its window against exactly one generation.

Overlapped staging
------------------

With ``TieringConfig.overlap_staging`` (the default) :meth:`prefetch`
reserves victim slots under the lock, builds the staged view OUTSIDE it
against the captured immutable view, and commits under the lock only if
the view reference (and the staged rows' eligibility) did not change in
flight; otherwise it restages whatever is still cold under the lock
(``staging_conflicts``).  On the card every new view is built on a side
stream: the host rows are packed into a pinned buffer, copied to the device
with ``non_blocking=True``, and scattered into clones of the old view's
tensors there.  The side stream records an event when the view is ready;
a dispatch makes its stream wait on that event before the kernel reads the
view, and the next build waits on it before it overwrites the pinned
buffer.  The new tensors are recorded on the dispatch stream
(``record_stream``) so the caching allocator cannot hand their memory out
again while a dispatch kernel may still read them.  On the CPU there is no
stream, and the same code runs the plain path.

Tiered over sharded
-------------------

:class:`ShardedTieredBankStore` composes this store with the tenant-sharded
topology: global rows are partitioned over the "tenants" axis by the same
round-robin rule as :class:`~repro_torch.core.transforms.ShardedTransformBank`
(``core.transforms.shard_rows``), each shard owns a per-shard
:class:`HostBankStore` plus its own hot/victim/prior
:class:`TieredBankStore`, and a dispatch buckets the window by owning
shard, resolves slots per shard, and launches the banked kernel ONCE a
pass through the sharded dispatcher over the stacked per-shard views (the
dispatch stream waits on every view's ``ready`` event first).  Device
residency is ``(hot+victims+1)·(2K+2N)·4`` bytes PER SHARD, independent of
tenant count; publishes land in every shard's host rows and device view
under ONE generation (all shard locks held in shard order, per-shard
generations advance in lockstep).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.hotness import HotnessTracker
from repro_torch.core.quantiles import required_sample_size
from repro_torch.core.transforms import (
    QuantileMap,
    TransformBank,
    banked_score_pipeline,
    pad_quantile_tables,
    shard_rows,
)
from repro_torch.device import resolve_device, to_numpy
from repro_torch.kernels import ops
from repro_torch.serving.types import StaleGenerationError


def _shape_bucket(n: int) -> int:
    """Next power of two >= n (the server's bucketing of kernel shapes)."""
    b = 1
    while b < n:
        b *= 2
    return b


def prior_bank_row(
    prior: Any,
    ref_quantiles: np.ndarray,
    num_experts: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The shared cold-start device row from a fitted Beta-mixture prior.

    ``prior`` is a :class:`~repro_torch.core.coldstart.BetaMixtureFit`
    (anything with ``.quantiles(levels)``) or a raw source-quantile table.
    T^C is the identity (beta=1 — the prior already models the *corrected*
    score distribution on the training data) and aggregation is uniform;
    T^Q maps the fitted prior's quantiles onto the reference, i.e. the
    paper's ``T^Q_{v0}`` (Sec. 2.4) as one bank row.
    """
    ref = np.asarray(to_numpy(ref_quantiles), np.float64).ravel()
    if hasattr(prior, "quantiles"):
        src = np.asarray(to_numpy(prior.quantiles(
            np.linspace(0.0, 1.0, len(ref)))))
    else:
        src = np.asarray(to_numpy(prior), np.float64).ravel()
        if len(src) != len(ref):
            src = np.interp(np.linspace(0.0, 1.0, len(ref)),
                            np.linspace(0.0, 1.0, len(src)), src)
    return (np.ones(num_experts, np.float32),
            np.ones(num_experts, np.float32),
            np.maximum.accumulate(src).astype(np.float32),
            np.asarray(ref, np.float32))


@dataclasses.dataclass
class TieringConfig:
    """Capacity + gating knobs for one :class:`TieredBankStore`.

    ``prior`` (optional) is the cold-start row — a
    ``(betas, weights, src_quantiles, ref_quantiles)`` tuple, typically
    from :func:`prior_bank_row`.  Without it the prior slot is the
    identity map and the Eq.-5 admission gate only matters for rows
    explicitly marked cold.
    """

    hot_capacity: int = 1024
    victim_capacity: int = 128
    decay: float = 0.98               # hotness decay per rebalance window
    gate_alert_rate: float = 0.01     # Eq. 5 target alert rate ``a``
    gate_rel_error: float = 0.2       # Eq. 5 relative error ``delta``
    gate_z: float = 1.96              # Eq. 5 confidence (95%)
    # the banked kernel (ops.score_pipeline_banked); False runs the plain
    # banked version (core.transforms.banked_score_pipeline)
    fused_kernel: bool = True
    # prefetch builds its staged view outside the dispatch lock and swaps
    # it in under an identity check (see module docstring); False holds
    # the lock across the copy (the benchmark's comparison)
    overlap_staging: bool = True
    prior: tuple | None = None

    def __post_init__(self) -> None:
        if self.hot_capacity < 1:
            raise ValueError("hot_capacity must be >= 1")
        if self.victim_capacity < 1:
            raise ValueError("victim_capacity must be >= 1")


class HostBankStore:
    """Host-memory (numpy) authoritative store of EVERY tenant's bank row.

    Plain contiguous float32 arrays — ``(T, K)`` betas/weights and
    ``(T, N)`` quantile tables — written in place only under the owning
    :class:`TieredBankStore`'s lock.  ``admitted`` marks rows past the
    Eq.-5 gate; un-admitted tenants score through the shared prior slot
    regardless of what their host row holds.
    """

    def __init__(self, betas: np.ndarray, weights: np.ndarray,
                 src_quantiles: np.ndarray, ref_quantiles: np.ndarray,
                 admitted: np.ndarray | None = None) -> None:
        # np.array (not asarray): write_rows mutates these in place
        self.betas = np.array(to_numpy(betas), np.float32, order="C")
        self.weights = np.array(to_numpy(weights), np.float32, order="C")
        self.src_quantiles = np.array(to_numpy(src_quantiles), np.float32,
                                      order="C")
        self.ref_quantiles = np.array(to_numpy(ref_quantiles), np.float32,
                                      order="C")
        t = self.betas.shape[0]
        for arr, name in ((self.weights, "weights"),
                          (self.src_quantiles, "src_quantiles"),
                          (self.ref_quantiles, "ref_quantiles")):
            if arr.shape[0] != t:
                raise ValueError(f"{name} has {arr.shape[0]} rows, betas {t}")
        self.admitted = (np.ones(t, bool) if admitted is None
                         else np.asarray(admitted, bool).copy())

    # ------------------------------------------------------------- geometry
    @property
    def num_rows(self) -> int:
        return int(self.betas.shape[0])

    @property
    def num_experts(self) -> int:
        return int(self.betas.shape[-1])

    @property
    def num_quantiles(self) -> int:
        return int(self.src_quantiles.shape[-1])

    @property
    def nbytes(self) -> int:
        """Host bytes of the row arrays (the O(total tenants) cost that
        tiering moves OFF the device)."""
        return (self.betas.nbytes + self.weights.nbytes
                + self.src_quantiles.nbytes + self.ref_quantiles.nbytes)

    # ------------------------------------------------------------- builders
    @staticmethod
    def from_rows(
        params: Sequence[tuple],
        admitted: np.ndarray | None = None,
    ) -> "HostBankStore":
        """Stack ragged ``(betas, weights, src_q, ref_q)`` rows, padding the
        expert axis with (beta=1, weight=0) columns and quantile tables
        edge-wise — :meth:`TransformBank.from_params`'s padding, so a dense
        bank built from the same params is row-for-row identical."""
        return HostBankStore.from_bank(
            TransformBank.from_params(params, device="cpu"), admitted)

    @staticmethod
    def from_bank(bank: TransformBank,
                  admitted: np.ndarray | None = None) -> "HostBankStore":
        return HostBankStore(bank.betas, bank.weights, bank.src_quantiles,
                             bank.ref_quantiles, admitted)

    # --------------------------------------------------------------- access
    def rows(self, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray,
                                             np.ndarray, np.ndarray]:
        ids = np.asarray(ids, np.int64)
        return (self.betas[ids], self.weights[ids],
                self.src_quantiles[ids], self.ref_quantiles[ids])

    def write_rows(
        self,
        updates: Mapping[int, "QuantileMap | tuple"],
    ) -> np.ndarray:
        """In-place T^Q table replacement for the given rows (the publish
        write path — caller holds the tier lock).  Narrow tables are
        edge-padded as the bank's ``with_rows`` pads them.  Every table is
        validated/padded BEFORE the first in-place write, so a bad row
        raises with the host arrays untouched — no torn half-published
        update.  Returns the updated row ids."""
        n = self.num_quantiles
        staged = []
        for row, value in sorted(updates.items()):
            if not 0 <= row < self.num_rows:
                raise IndexError(f"row {row} outside store of {self.num_rows}")
            src, ref = pad_quantile_tables(value, n, row=row)
            staged.append((row, to_numpy(src), to_numpy(ref)))
        ids = []
        for row, src, ref in staged:
            self.src_quantiles[row] = src
            self.ref_quantiles[row] = ref
            ids.append(row)
        return np.asarray(ids, np.int64)

    def dense_bank(self, generation: int = 0,
                   device: torch.device | str | None = None
                   ) -> TransformBank:
        """The dense bank these rows describe (the parity oracle), on
        ``device`` (the card unless the caller asks for another)."""
        device = resolve_device(device)
        return TransformBank(
            *(torch.tensor(a, device=device) for a in (
                self.betas, self.weights, self.src_quantiles,
                self.ref_quantiles)),
            generation=generation)


@dataclasses.dataclass(frozen=True)
class _TierView:
    """One immutable device-bank snapshot a dispatch scores against.

    ``hot_capacity + victim_capacity + 1`` rows: hot slots, victim slots,
    then the pinned prior row.  Swapped by reference under the store lock
    (staging, rebalance, publish); never written in place.  ``ready`` is
    the CUDA event a kernel's stream waits on before reading the view
    (None on the CPU).
    """

    betas: torch.Tensor            # (R, K)
    weights: torch.Tensor          # (R, K)
    src_quantiles: torch.Tensor    # (R, N)
    ref_quantiles: torch.Tensor    # (R, N)
    generation: int
    ready: Any = None

    @property
    def nbytes(self) -> int:
        r = int(self.betas.shape[0])
        k = int(self.betas.shape[-1])
        n = int(self.src_quantiles.shape[-1])
        return r * (2 * k + 2 * n) * 4


class _RowCopier:
    """Builds new views on the card: host rows -> pinned buffer -> device
    (``non_blocking``) -> scatter into clones of the old view, all on one
    side stream.  One pinned buffer, refilled only after the event of the
    copy that last read it has completed; a lock serializes the builds
    (a prefetch off the store lock against a dispatch's staging)."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self._lock = threading.Lock()
        self._pinned = torch.empty(0, dtype=torch.float32).pin_memory()
        self._slots = torch.empty(0, dtype=torch.int64).pin_memory()
        self._done: torch.cuda.Event | None = None   # last copy of _pinned

    def build(self, view: _TierView, slots: np.ndarray,
              rows: Sequence[np.ndarray | None], generation: int
              ) -> _TierView:
        olds = (view.betas, view.weights, view.src_quantiles,
                view.ref_quantiles)
        sizes = [0 if r is None else r.size for r in rows]
        with self._lock:
            if self._done is not None:
                self._done.synchronize()      # pinned buffer free again
            if self._pinned.numel() < sum(sizes):
                self._pinned = torch.empty(sum(sizes), dtype=torch.float32
                                           ).pin_memory()
            if self._slots.numel() < len(slots):
                self._slots = torch.empty(len(slots), dtype=torch.int64
                                          ).pin_memory()
            host, at = self._pinned.numpy(), 0
            for r, size in zip(rows, sizes):
                if size:
                    host[at:at + size] = r.ravel()
                    at += size
            self._slots.numpy()[:len(slots)] = slots
            dispatch = torch.cuda.current_stream(self.device)
            with torch.cuda.stream(self.stream):
                if view.ready is not None:
                    self.stream.wait_event(view.ready)
                flat = self._pinned[:at].to(self.device, non_blocking=True)
                idx = self._slots[:len(slots)].to(self.device,
                                                  non_blocking=True)
                new, at = [], 0
                for old, r, size in zip(olds, rows, sizes):
                    if not size:
                        new.append(old)       # unchanged: shared, immutable
                        continue
                    old.record_stream(self.stream)
                    t = old.clone()
                    t.index_copy_(0, idx, flat[at:at + size].view(
                        len(slots), -1))
                    at += size
                    t.record_stream(dispatch)
                    new.append(t)
                ready = torch.cuda.Event()
                ready.record(self.stream)
            self._done = ready
        return _TierView(*new, generation=generation, ready=ready)


class TieredBankStore:
    """Hot/victim/prior tiered serving view over a :class:`HostBankStore`.

    See the module docstring for the tier model.  All public methods are
    thread-safe; ``dispatch`` holds the store lock across its kernel
    launch(es) so the (slot map, device view) pair it scores with is
    consistent and each window serves under one generation — publishes
    from another thread land before or after a window, never inside it.
    The device view lives on ``device`` (the card unless the caller asks
    for another).
    """

    def __init__(self, host: HostBankStore,
                 config: TieringConfig | None = None, *,
                 generation: int = 0, hot_slots: int | None = None,
                 device: torch.device | str | None = None) -> None:
        self.host = host
        self.config = config or TieringConfig()
        self.device = resolve_device(device)
        t = host.num_rows
        # hot_slots: explicit hot-tier size override (the composed sharded
        # store gives every shard the same value)
        self._hot = min(self.config.hot_capacity, t) if hot_slots is None \
            else int(hot_slots)
        self._victims = self.config.victim_capacity
        self._prior_slot = self._hot + self._victims
        self._gate_n = required_sample_size(
            self.config.gate_alert_rate, self.config.gate_rel_error,
            self.config.gate_z)
        self.tracker = HotnessTracker(t, self.config.decay)
        self._seen = np.zeros(t, np.int64)
        self._slot_of = np.full(t, -1, np.int32)   # -1 = not device-resident
        self._owner = np.full(self._prior_slot, -1, np.int64)
        self._hand = 0                             # victim clock hand
        # identity witness for the serving layer's bank cache (which
        # pipelines this store's host rows were built from); opaque here
        self.source_pipelines: tuple | None = None
        k, n = host.num_experts, host.num_quantiles
        rows = self._prior_slot + 1
        betas = np.ones((rows, k), np.float32)
        weights = np.ones((rows, k), np.float32)
        ident = np.linspace(0.0, 1.0, n, dtype=np.float32)
        src = np.broadcast_to(ident, (rows, n)).copy()
        ref = src.copy()
        if self.config.prior is not None:
            pb, pw, ps, pr = self.config.prior
            betas[-1] = to_numpy(pb)
            weights[-1] = to_numpy(pw)
            ps, pr = pad_quantile_tables(
                (torch.as_tensor(to_numpy(ps)), torch.as_tensor(to_numpy(pr))),
                n)
            src[-1] = to_numpy(ps)
            ref[-1] = to_numpy(pr)
        # the prior row never changes (staging, promotion and publishes
        # write hot and victim slots only): its host copy feeds
        # pre_quantile without a device read
        self._prior_host = (betas[-1].copy(), weights[-1].copy())
        tensors = [torch.tensor(a, device=self.device)
                   for a in (betas, weights, src, ref)]
        self._copier: _RowCopier | None = None
        ready = None
        if self.device.type == "cuda":
            self._copier = _RowCopier(self.device)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        self._view = _TierView(*tensors, generation=generation, ready=ready)
        # RLock: the composed sharded store holds every shard's lock and
        # then calls per-shard methods that re-acquire their own
        self._lock = threading.RLock()
        # victim slots reserved by an in-flight overlapped prefetch (its
        # copy runs OFF the lock); concurrent prefetches avoid these.
        # Dispatch staging deliberately does NOT — a dispatch miss must
        # always make progress, and stealing a reserved slot just fails
        # the prefetch's commit identity check (it restages or drops).
        self._staging: set[int] = set()
        self.metrics: dict[str, int] = {
            "dispatches": 0, "events": 0, "hot_hits": 0, "victim_hits": 0,
            "prior_scores": 0, "cold_miss_stalls": 0, "stalled_events": 0,
            "staged_rows": 0, "prefetched_rows": 0, "extra_passes": 0,
            "staging_conflicts": 0,
            "promotions": 0, "demotions": 0, "admissions": 0, "updates": 0,
        }

    # ------------------------------------------------------------- geometry
    @property
    def num_rows(self) -> int:
        return self.host.num_rows

    @property
    def hot_capacity(self) -> int:
        return self._hot

    @property
    def victim_capacity(self) -> int:
        return self._victims

    @property
    def generation(self) -> int:
        return self._view.generation

    @property
    def gate_samples(self) -> int:
        """Eq.-5 sample count a tenant's stream needs for admission."""
        return self._gate_n

    @property
    def device_bytes(self) -> int:
        """Device-resident bank bytes — a function of CONFIGURED capacity
        (hot + victim + prior row), independent of ``num_rows``."""
        return self._view.nbytes

    @property
    def host_bytes(self) -> int:
        return self.host.nbytes

    def hot_rows(self) -> np.ndarray:
        """Tenant ids currently in the hot tier (unordered)."""
        with self._lock:
            owners = self._owner[:self._hot]
            return owners[owners >= 0].copy()

    def resident_rows(self) -> np.ndarray:
        """Tenant ids device-resident in either tier (unordered)."""
        with self._lock:
            return self._owner[self._owner >= 0].copy()

    # --------------------------------------------------------------- private
    def _effective_slots(self, tid: np.ndarray) -> np.ndarray:
        """Device slot per event: un-admitted -> prior slot; admitted ->
        its resident slot or -1 (needs staging).  Caller holds the lock."""
        slots = self._slot_of[tid].astype(np.int32)
        return np.where(self.host.admitted[tid], slots,
                        np.int32(self._prior_slot))

    def _pick_victim_slots_locked(self, n: int,
                                  protected: set[int]) -> list[int]:
        """Choose ``n`` distinct victim slots by clock, skipping
        ``protected``.  Caller holds the lock and guarantees enough
        unprotected slots exist."""
        chosen: list[int] = []
        taken: set[int] = set()
        for _ in range(n):
            for _ in range(self._victims):
                s = self._hot + self._hand
                self._hand = (self._hand + 1) % self._victims
                if s not in protected and s not in taken:
                    break
            else:  # pragma: no cover — caller enforces capacity
                raise RuntimeError("no victim slot available")
            taken.add(s)
            chosen.append(s)
        return chosen

    def _assign_slots_locked(self, take: np.ndarray,
                             slots: Sequence[int]) -> None:
        """Point the slot maps at the new owners (caller holds the lock;
        the view rows for ``slots`` must already hold ``take``'s data or
        be swapped in the same lock hold)."""
        for t, s in zip(take, slots):
            prev = self._owner[s]
            if prev >= 0:
                self._slot_of[prev] = -1
            self._owner[s] = int(t)
            self._slot_of[int(t)] = s

    def _scatter(self, view: _TierView, slots: Sequence[int],
                 rows: Sequence[np.ndarray | None],
                 generation: int) -> _TierView:
        """A NEW view: ``view`` with the given (betas, weights, src, ref)
        host rows (None: that tensor unchanged) written into ``slots``.
        Never writes ``view``; on the card the copy runs on the side
        stream (:class:`_RowCopier`)."""
        slots = np.asarray(list(slots), np.int64)
        if self._copier is not None:
            return self._copier.build(view, slots, rows, generation)
        idx = torch.from_numpy(slots)
        new = []
        for old, r in zip((view.betas, view.weights, view.src_quantiles,
                           view.ref_quantiles), rows):
            if r is None:
                new.append(old)
                continue
            t = old.clone()
            t.index_copy_(0, idx, torch.from_numpy(np.ascontiguousarray(r)))
            new.append(t)
        return _TierView(*new, generation=generation)

    def _staged_view(self, view: _TierView, slots: Sequence[int],
                     take: np.ndarray) -> _TierView:
        """A new view with host rows ``take`` scattered into ``slots`` —
        the host->device copy.  Pure function of its inputs against the
        IMMUTABLE ``view``: the overlapped prefetch path builds this
        outside the lock and swaps it in under an identity check (host
        row values only change under ``apply_updates``, which always
        swaps the view reference, so a torn read here is always caught
        at commit)."""
        return self._scatter(view, slots,
                             self.host.rows(np.asarray(take, np.int64)),
                             view.generation)

    def _stage_locked(self, take: np.ndarray,
                      protected: set[int]) -> None:
        """Page ``take`` host rows into victim slots (clock eviction,
        skipping ``protected`` slots).  Caller holds the lock and
        guarantees ``len(take) <= victim_capacity - len(protected)``."""
        slots = self._pick_victim_slots_locked(len(take), protected)
        self._assign_slots_locked(take, slots)
        self._view = self._staged_view(self._view, slots, take)
        self.metrics["staged_rows"] += len(take)

    def _score_slots(self, raws: np.ndarray, slots: np.ndarray,
                     view: _TierView) -> np.ndarray:
        """One banked kernel launch over slot-indexed rows (pow-2 bucketed,
        edge-padded slot vector — the dense server's padding, which the
        bitwise-parity contract depends on)."""
        b = len(slots)
        pad = _shape_bucket(b) - b
        if pad:
            raws = np.concatenate(
                [raws, np.zeros((pad,) + raws.shape[1:], raws.dtype)])
            # Edge-pad with the LAST event's slot — which may be a live
            # victim slot — and NOT with ``_prior_slot``: the dense server
            # edge-pads its tenant vector the same way.  The padded vector
            # exists only inside this (lock-held, synchronous) launch
            # against the immutable ``view``; pad rows are sliced off on
            # return, and each later pass rebuilds its eviction-protection
            # set from the UNPADDED event slots (``_resolve_pass_locked``).
            assert 0 <= slots[-1] <= self._prior_slot
            slots = np.concatenate(
                [slots, np.full(pad, slots[-1], np.int32)])
        scores = torch.from_numpy(np.ascontiguousarray(raws, np.float32))
        idx = torch.from_numpy(np.ascontiguousarray(slots, np.int32))
        scores, idx = scores.to(self.device), idx.to(self.device)
        if view.ready is not None:
            # the view was built on the copier's side stream
            torch.cuda.current_stream(self.device).wait_event(view.ready)
        impl = ops.score_pipeline_banked if self.config.fused_kernel \
            else banked_score_pipeline
        out = impl(scores, idx, view.betas, view.weights,
                   view.src_quantiles, view.ref_quantiles)
        return to_numpy(out)[:b]

    # -------------------------------------------------------------- serving
    def dispatch(self, expert_scores: np.ndarray, tenant_idx: np.ndarray
                 ) -> tuple[np.ndarray, int]:
        """Score one mixed-tenant window; returns ``(scores, generation)``.

        Hot path (every referenced row device-resident — the prefetched
        steady state): one slot remap + ONE banked kernel launch, no host
        reads.  A cold miss stages the row synchronously into the victim
        cache first (counted in ``cold_miss_stalls``/``stalled_events``);
        if a window references more distinct cold tenants than the victim
        cache holds, it is scored in multiple passes (``extra_passes``) —
        correctness never depends on capacity.
        """
        raws = np.asarray(expert_scores, np.float32)
        tid = np.asarray(tenant_idx, np.int64).ravel()
        if tid.size == 0:
            return np.empty(0, np.float32), self._view.generation
        with self._lock:
            self._record_window_locked(tid)
            out = np.empty(len(tid), np.float32)
            done = np.zeros(len(tid), bool)
            passes = 0
            while not done.all():
                eff, ready = self._resolve_pass_locked(tid, done)
                ev = np.flatnonzero(ready)
                if not len(ev):  # pragma: no cover — room>0 or ready!=[]
                    raise RuntimeError("tiered dispatch made no progress")
                out[ev] = self._score_slots(raws[ev], eff[ev], self._view)
                done[ev] = True
                passes += 1
            if passes > 1:
                self.metrics["extra_passes"] += passes - 1
            return out, self._view.generation

    def _record_window_locked(self, tid: np.ndarray) -> None:
        """Per-window accounting: hotness, Eq.-5 seen counts, tier-hit
        metrics.  Caller holds the lock.  ``np.add.at``: O(window), where
        a bincount over every tenant would be O(total tenants)."""
        self.tracker.record(tid)
        np.add.at(self._seen, tid, 1)
        self.metrics["dispatches"] += 1
        self.metrics["events"] += len(tid)
        eff = self._effective_slots(tid)
        self.metrics["prior_scores"] += int(
            np.sum(eff == self._prior_slot))
        self.metrics["hot_hits"] += int(
            np.sum((eff >= 0) & (eff < self._hot)))
        self.metrics["victim_hits"] += int(
            np.sum((eff >= self._hot) & (eff < self._prior_slot)))

    def _resolve_pass_locked(self, tid: np.ndarray, done: np.ndarray
                             ) -> tuple[np.ndarray, np.ndarray]:
        """One staging pass of a dispatch window (caller holds the lock):
        stage as many still-missing rows as the victim cache can take
        without evicting slots this pass's ready events reference, then
        return ``(effective slots, ready mask)``."""
        eff = self._effective_slots(tid)
        ready = ~done & (eff >= 0)
        missing = ~done & (eff < 0)
        if missing.any():
            miss = np.unique(tid[missing])
            # victim slots serving THIS pass's ready events must not be
            # evicted out from under the same kernel launch
            live = np.unique(eff[ready]) if ready.any() else ()
            protected = {int(s) for s in live
                         if self._hot <= s < self._prior_slot}
            room = self._victims - len(protected)
            if room > 0:
                take = miss[:room]
                self._stage_locked(take, protected)
                self.metrics["cold_miss_stalls"] += len(take)
                staged_ev = ~done & np.isin(tid, take)
                self.metrics["stalled_events"] += int(staged_ev.sum())
                eff = self._effective_slots(tid)
                ready = ~done & (eff >= 0)
        return eff, ready

    def _prefetch_misses_locked(self, tid: np.ndarray,
                                cap: int) -> np.ndarray:
        """Admitted, non-resident rows referenced by ``tid`` (at most
        ``cap`` of them).  Caller holds the lock."""
        if cap <= 0:
            return np.empty(0, np.int64)
        uniq = np.unique(tid)
        uniq = uniq[self.host.admitted[uniq]]
        miss = uniq[self._slot_of[uniq] < 0]
        return miss[:cap]

    def prefetch(self, tenant_idx: np.ndarray) -> int:
        """Stage pending windows' cold rows ahead of dispatch (no stall
        accounting, no hotness recording — the dispatch that actually
        serves the window records it).  At most ``victim_capacity`` rows
        are staged per call; returns the number staged.

        With ``overlap_staging`` (default) the host->device copy runs OFF
        the dispatch lock: slots are reserved under the lock, the staged
        view is built outside it against the captured immutable view, and
        the commit validates the view reference before the swap.  A
        concurrent publish/rebalance/dispatch-staging invalidates the
        prepared view — the commit then restages whatever is still cold
        under the lock (``staging_conflicts``)."""
        tid = np.asarray(tenant_idx, np.int64).ravel()
        if tid.size == 0:
            return 0
        if not self.config.overlap_staging:
            # hold the lock across the whole copy (the benchmark's
            # before/after p99 comparison)
            with self._lock:
                take = self._prefetch_misses_locked(tid, self._victims)
                if not len(take):
                    return 0
                self._stage_locked(take, set())
                self.metrics["prefetched_rows"] += len(take)
                return len(take)
        with self._lock:
            room = self._victims - len(self._staging)
            take = self._prefetch_misses_locked(tid, room)
            if not len(take):
                return 0
            slots = self._pick_victim_slots_locked(len(take), self._staging)
            self._staging.update(slots)
            v0 = self._view
        try:
            # the expensive part — host gather + device scatter — runs
            # with NO lock held: dispatches proceed concurrently
            staged = self._staged_view(v0, slots, take)
        except BaseException:
            with self._lock:
                self._staging.difference_update(slots)
            raise
        with self._lock:
            self._staging.difference_update(slots)
            fresh = (self._view is v0
                     and bool(np.all(self._slot_of[take] < 0))
                     and bool(np.all(self.host.admitted[take])))
            if fresh:
                # nothing swapped the view while the copy was in flight,
                # and every staged row is still cold+admitted (mark_cold
                # can flip eligibility without a view swap): commit
                self._assign_slots_locked(take, slots)
                self._view = staged
                self.metrics["staged_rows"] += len(take)
                self.metrics["prefetched_rows"] += len(take)
                return len(take)
            # conflict: drop the prepared view, restage what is still
            # cold under the lock (rare — counted for the benchmark)
            self.metrics["staging_conflicts"] += 1
            take = take[(self._slot_of[take] < 0)
                        & self.host.admitted[take]]
            take = take[:max(self._victims - len(self._staging), 0)]
            if not len(take):
                return 0
            self._stage_locked(take, set(self._staging))
            self.metrics["prefetched_rows"] += len(take)
            return len(take)

    def pre_quantile(self, expert_scores: np.ndarray,
                     tenant_idx: np.ndarray) -> np.ndarray:
        """Per-event T^Q input (corrected weighted aggregate) through the
        rows the dispatch serves — host rows for admitted tenants, the
        prior row otherwise.  Numpy on host arrays, the reference's own
        arithmetic: the track stage must not pull cold rows onto the
        device just to fit estimators."""
        raws = np.asarray(expert_scores, np.float32)
        tid = np.asarray(tenant_idx, np.int64).ravel()
        with self._lock:
            adm = self.host.admitted[tid]
            b = self.host.betas[tid]
            w = self.host.weights[tid]
        pb, pw = self._prior_host
        b = np.where(adm[:, None], b, pb[None, :])
        w = np.where(adm[:, None], w, pw[None, :])
        corrected = (b * raws) / (1.0 - (1.0 - b) * raws)
        w = w / np.sum(w, axis=-1, keepdims=True)
        return np.sum(corrected * w, axis=-1)

    # -------------------------------------------------------------- control
    def rebalance(self, *, generation: int | None = None) -> dict[str, int]:
        """Explicit control-plane promotion/demotion + Eq.-5 admission.

        ``generation`` fences a decision computed against an old view:
        a stamp STRICTLY OLDER than the store's current generation raises
        :class:`StaleGenerationError`.  Rebalance moves rows between tiers
        but never changes their values, so the generation is unchanged.

        Admission: tenants whose observed stream reached ``gate_samples``
        events leave the prior tier.  Promotion: the ``hot_capacity``
        hottest admitted tenants by decayed access count hold the hot
        slots; everyone else pages through the victim cache.  Returns a
        summary dict.
        """
        with self._lock:
            cur = self._view.generation
            if generation is not None and generation < cur:
                raise StaleGenerationError(generation, cur)
            newly = np.flatnonzero(~self.host.admitted
                                   & (self._seen >= self._gate_n))
            if len(newly):
                self.host.admitted[newly] = True
            self.tracker.tick()
            want = self.tracker.top(self._hot, mask=self.host.admitted)
            want_set = {int(t) for t in want}
            cur_hot = {int(self._owner[s]): s for s in range(self._hot)
                       if self._owner[s] >= 0}
            demote = [t for t in cur_hot if t not in want_set]
            promote = [int(t) for t in want if int(t) not in cur_hot]
            for t in demote:
                self._owner[cur_hot[t]] = -1
                self._slot_of[t] = -1
            free = [s for s in range(self._hot) if self._owner[s] < 0]
            if promote:
                slots: list[int] = []
                for t, s in zip(promote, free):
                    old = self._slot_of[t]
                    if old >= 0:           # leaving the victim cache
                        self._owner[old] = -1
                    self._owner[s] = t
                    self._slot_of[t] = s
                    slots.append(s)
                self._view = self._scatter(
                    self._view, slots,
                    self.host.rows(np.asarray(promote, np.int64)),
                    self._view.generation)
            self.metrics["admissions"] += len(newly)
            self.metrics["promotions"] += len(promote)
            self.metrics["demotions"] += len(demote)
            return {"admitted": len(newly), "promoted": len(promote),
                    "demoted": len(demote), "generation": cur}

    def apply_updates(self, updates: Mapping[int, "QuantileMap | tuple"],
                      *, generation: int | None = None) -> int:
        """Publish refreshed T^Q tables into BOTH tiers atomically.

        Host rows are rewritten in place and every device-resident copy
        (hot slot or victim slot) is scattered into a NEW view under the
        new generation, all inside one lock hold.  Updated rows are marked
        admitted (a published map means the stream passed calibration).
        Fencing matches ``MuseServer.publish_quantile_maps``: with
        ``generation=`` the stamp must be strictly newer (else
        :class:`StaleGenerationError`); an empty fenced update fast-forwards
        the generation; an empty unfenced update is a no-op.  Returns the
        store generation after the call.
        """
        with self._lock:
            cur = self._view.generation
            if generation is None:
                if not updates:
                    return cur
                gen = cur + 1
            else:
                if generation <= cur:
                    raise StaleGenerationError(generation, cur)
                gen = generation
            v = self._view
            if updates:
                ids = self.host.write_rows(updates)
                self.host.admitted[ids] = True
                self.metrics["updates"] += len(ids)
                resident = ids[self._slot_of[ids] >= 0]
                if len(resident):
                    _, _, qs, qr = self.host.rows(resident)
                    self._view = self._scatter(
                        v, self._slot_of[resident], (None, None, qs, qr), gen)
                    return gen
            self._view = dataclasses.replace(v, generation=gen)
            return gen

    def mark_cold(self, rows: Sequence[int]) -> None:
        """Send rows back behind the Eq.-5 gate: they score through the
        prior slot until their stream re-reaches ``gate_samples`` events
        and a ``rebalance`` re-admits them.  Any device-resident copy is
        evicted (unreachable rows must not hold slots)."""
        ids = np.asarray(list(rows), np.int64)
        if not len(ids):
            return
        with self._lock:
            self.host.admitted[ids] = False
            self._seen[ids] = 0
            resident = ids[self._slot_of[ids] >= 0]
            for t in resident:
                self._owner[self._slot_of[t]] = -1
                self._slot_of[t] = -1

    def seen(self, row: int) -> int:
        """Observed event count for one tenant (the Eq.-5 gate input)."""
        return int(self._seen[row])

    # ---------------------------------------------------------- persistence
    def hotness_snapshot(self) -> dict:
        """Portable hotness/admission state a surged replica adopts so it
        warms up with its predecessor's hot set instead of a cold one."""
        with self._lock:
            return {"tracker": self.tracker.snapshot(),
                    "seen": self._seen.copy(),
                    "admitted": self.host.admitted.copy()}

    def adopt_hotness(self, snap: dict) -> None:
        with self._lock:
            self.tracker.adopt(snap["tracker"])
            seen = np.asarray(snap["seen"], np.int64)
            adm = np.asarray(snap["admitted"], bool)
            n = min(len(seen), len(self._seen))
            self._seen[:n] = seen[:n]
            self.host.admitted[:n] = adm[:n]


class ShardedTieredBankStore:
    """Per-shard hot/victim/prior tiers over a row-partitioned host store.

    Global rows partition over the "tenants" axis by the SAME round-robin
    rule as :class:`~repro_torch.core.transforms.ShardedTransformBank`
    (``shard_rows``), each shard owning a :class:`HostBankStore` slice and
    a full :class:`TieredBankStore` (hot slots, victim clock, pinned prior
    row, all PER SHARD — device residency is ``(hot+victims+1)·(2K+2N)·4``
    bytes per shard regardless of tenant count).  The public surface
    mirrors :class:`TieredBankStore` addressed by GLOBAL row ids, so the
    serving layer (publish, rebalance, prefetch, warm start, mark_cold)
    treats both interchangeably; hotness snapshots are global-indexed, so
    a rollout can warm a composed store from a single-tier predecessor and
    vice versa.

    A dispatch buckets events by owning shard, runs every shard's staging
    pass, packs one ``(S, Bs, K)`` slot-remapped batch (edge-padded per
    shard, as the pure-sharded dispatcher pads), and launches the banked
    kernel ONCE through the dispatcher's ``run_packed`` over the stacked
    per-shard views — per-row compute is the dense path's kernel, so
    composed scores match the dense bank BITWISE.  Cross-shard operations
    (dispatch, publish, rebalance, hotness snapshots) take every shard's
    lock in shard order; per-shard operations (prefetch, mark_cold) take
    one shard's lock at a time and never wait for another's while holding
    one.  ``dispatcher`` defaults to a :class:`ShardedBankDispatcher` over
    ``num_shards`` shards on ``device`` (the card unless the caller asks
    for another); a given one's mesh device is the stores' device.
    """

    def __init__(self, host: HostBankStore, num_shards: int,
                 config: TieringConfig | None = None, *,
                 dispatcher: Any = None,
                 generation: int = 0,
                 shard_of: np.ndarray | None = None,
                 device: torch.device | str | None = None) -> None:
        self.config = config or TieringConfig()
        t = host.num_rows
        assign, local, counts = shard_rows(t, num_shards, shard_of)
        self.shard_of = assign
        self.local_of = local
        self.row_counts = counts
        self.global_of = [np.flatnonzero(assign == s)
                          for s in range(num_shards)]
        # every shard gets the SAME hot-slot count (even the underfull
        # ones) so the per-shard views stack into one (S, R, ·) operand
        hot_slots = min(self.config.hot_capacity,
                        max(int(counts.max()) if counts.size else 1, 1))
        if dispatcher is None:
            # deferred: serving.server imports this module at the top
            from repro_torch.launch.mesh import make_tenant_mesh
            from repro_torch.serving.server import ShardedBankDispatcher
            dispatcher = ShardedBankDispatcher(
                make_tenant_mesh(num_shards, device),
                fused=self.config.fused_kernel)
        if device is None:    # where the dispatcher's shards live
            device = getattr(getattr(dispatcher, "mesh", None), "device",
                             None)
        self.device = resolve_device(device)
        self.dispatcher = dispatcher
        self.shards: list[TieredBankStore] = []
        for s in range(num_shards):
            g = self.global_of[s]
            sub = HostBankStore(
                host.betas[g], host.weights[g],
                host.src_quantiles[g], host.ref_quantiles[g],
                admitted=host.admitted[g])
            self.shards.append(TieredBankStore(
                sub, self.config, generation=generation,
                hot_slots=hot_slots, device=self.device))
        # identity witness for the serving layer's bank cache (same
        # contract as TieredBankStore.source_pipelines)
        self.source_pipelines: tuple | None = None
        # stacked-view cache: restacking S x R rows costs a device copy
        # per dispatch; keyed on the per-shard view IDENTITIES (strong
        # refs — any staging/publish/rebalance swaps a view and misses).
        # On the card the stack carries the event that marks it written.
        self._stacked_key: tuple | None = None
        self._stacked: tuple | None = None
        self._stacked_ready: Any = None
        self.joint_metrics: dict[str, int] = {
            "dispatches": 0, "extra_passes": 0}

    # ------------------------------------------------------------- geometry
    @property
    def num_rows(self) -> int:
        return int(self.shard_of.shape[0])

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    @property
    def hot_capacity(self) -> int:
        return self.shards[0].hot_capacity

    @property
    def victim_capacity(self) -> int:
        return self.shards[0].victim_capacity

    @property
    def generation(self) -> int:
        # all shards agree by construction (lockstep publishes)
        return self.shards[0].generation

    @property
    def gate_samples(self) -> int:
        return self.shards[0].gate_samples

    @property
    def per_shard_device_bytes(self) -> int:
        """Device-resident bank bytes of ONE shard — a function of
        configured capacity, independent of tenant count."""
        return self.shards[0].device_bytes

    @property
    def device_bytes(self) -> int:
        return sum(st.device_bytes for st in self.shards)

    @property
    def host_bytes(self) -> int:
        return sum(st.host_bytes for st in self.shards)

    @property
    def metrics(self) -> dict[str, int]:
        """Aggregated counters: composed-level ``dispatches`` /
        ``extra_passes`` (joint windows and joint passes) plus every
        per-shard counter summed; the per-shard window counts land under
        ``shard_windows`` so they don't double-count dispatches."""
        agg = dict(self.joint_metrics)
        for st in self.shards:
            for k, v in st.metrics.items():
                if k == "dispatches":
                    k = "shard_windows"
                elif k == "extra_passes":
                    continue  # composed passes counted jointly
                agg[k] = agg.get(k, 0) + v
        return agg

    def hot_rows(self) -> np.ndarray:
        """GLOBAL tenant ids currently in any shard's hot tier."""
        return np.concatenate(
            [self.global_of[s][st.hot_rows()]
             for s, st in enumerate(self.shards)] or
            [np.empty(0, np.int64)])

    def resident_rows(self) -> np.ndarray:
        """GLOBAL tenant ids device-resident in any shard, either tier."""
        return np.concatenate(
            [self.global_of[s][st.resident_rows()]
             for s, st in enumerate(self.shards)] or
            [np.empty(0, np.int64)])

    def dense_bank(self, generation: int = 0,
                   device: torch.device | str | None = None
                   ) -> TransformBank:
        """The dense global bank the per-shard host rows describe (the
        parity oracle), on ``device`` (the card unless the caller asks for
        another) — :meth:`HostBankStore.dense_bank`'s contract."""
        k = self.shards[0].host.num_experts
        n = self.shards[0].host.num_quantiles
        t = self.num_rows
        rows = (np.empty((t, k), np.float32), np.empty((t, k), np.float32),
                np.empty((t, n), np.float32), np.empty((t, n), np.float32))
        for s, st in enumerate(self.shards):
            g = self.global_of[s]
            for dst, src in zip(rows, (st.host.betas, st.host.weights,
                                       st.host.src_quantiles,
                                       st.host.ref_quantiles)):
                dst[g] = src
        return HostBankStore(*rows).dense_bank(generation, device)

    # --------------------------------------------------------------- private
    @contextlib.contextmanager
    def _locked(self):
        """Hold every shard's lock, acquired in shard order (the one
        global lock order — no deadlock against per-shard paths)."""
        with contextlib.ExitStack() as stack:
            for st in self.shards:
                stack.enter_context(st._lock)
            yield

    def _stacked_views(self, views: Sequence[_TierView]) -> tuple:
        """The per-shard views stacked into (S, R, ·) operands, cached on
        the views' identities.  On the card a view may have been built on
        its shard's copier side stream: the stack (on the dispatch stream)
        waits on every view's ``ready`` event first, and the views'
        tensors are recorded on the dispatch stream so the allocator cannot
        reuse them while it reads them.  A cached stack is waited on
        through the event recorded when it was written."""
        key = tuple(views)
        cuda = self.device.type == "cuda"
        stream = torch.cuda.current_stream(self.device) if cuda else None
        if self._stacked is None or self._stacked_key is None \
                or len(self._stacked_key) != len(key) \
                or not all(a is b for a, b in zip(self._stacked_key, key)):
            if cuda:
                for v in key:
                    if v.ready is not None:
                        stream.wait_event(v.ready)
                    for x in (v.betas, v.weights, v.src_quantiles,
                              v.ref_quantiles):
                        x.record_stream(stream)
            self._stacked = (
                torch.stack([v.betas for v in key]),
                torch.stack([v.weights for v in key]),
                torch.stack([v.src_quantiles for v in key]),
                torch.stack([v.ref_quantiles for v in key]))
            self._stacked_key = key
            self._stacked_ready = None
            if cuda:
                self._stacked_ready = torch.cuda.Event()
                self._stacked_ready.record(stream)
        elif cuda:
            stream.wait_event(self._stacked_ready)
            for x in self._stacked:
                x.record_stream(stream)
        return self._stacked

    def _bucket(self, tid: np.ndarray
                ) -> tuple[np.ndarray, list[np.ndarray]]:
        """Local ids + per-shard event-index buckets for one window."""
        shard_ids = self.shard_of[tid]
        local = self.local_of[tid]
        buckets = [np.flatnonzero(shard_ids == s)
                   for s in range(self.num_shards)]
        return local, buckets

    # -------------------------------------------------------------- serving
    def dispatch(self, expert_scores: np.ndarray, tenant_idx: np.ndarray
                 ) -> tuple[np.ndarray, int]:
        """Score one mixed-tenant window across all shards; returns
        ``(scores, generation)``.

        Hot path: per-shard slot remap + ONE launch of the banked kernel
        over the stacked per-shard views.  Cold misses stage per shard
        exactly like the single store; a window that overflows some
        shard's victim cache runs joint multi-pass rounds (every shard's
        pass scores in the same launch)."""
        raws = np.asarray(expert_scores, np.float32)
        tid = np.asarray(tenant_idx, np.int64).ravel()
        if tid.size == 0:
            return np.empty(0, np.float32), self.generation
        local, buckets = self._bucket(tid)
        k = raws.shape[-1]
        s_count = self.num_shards
        with self._locked():
            gen = self.shards[0]._view.generation
            for s, st in enumerate(self.shards):
                if len(buckets[s]):
                    st._record_window_locked(local[buckets[s]])
            self.joint_metrics["dispatches"] += 1
            out = np.empty(len(tid), np.float32)
            done = [np.zeros(len(b), bool) for b in buckets]
            passes = 0
            while not all(d.all() for d in done):
                ready_evs: list[np.ndarray] = []
                slot_vecs: list[np.ndarray] = []
                views: list[_TierView] = []
                for s, st in enumerate(self.shards):
                    if not len(buckets[s]) or done[s].all():
                        ready_evs.append(np.empty(0, np.int64))
                        slot_vecs.append(np.empty(0, np.int32))
                        views.append(st._view)
                        continue
                    eff, ready = st._resolve_pass_locked(
                        local[buckets[s]], done[s])
                    ev = np.flatnonzero(ready)
                    ready_evs.append(ev)
                    slot_vecs.append(eff[ev].astype(np.int32))
                    views.append(st._view)
                widest = max(len(e) for e in ready_evs)
                if widest == 0:  # pragma: no cover — per-shard progress
                    raise RuntimeError(
                        "tiered+sharded dispatch made no progress")
                bs = _shape_bucket(widest)
                packed = np.zeros((s_count, bs, k), np.float32)
                pidx = np.zeros((s_count, bs), np.int32)
                for s, ev in enumerate(ready_evs):
                    n = len(ev)
                    if n:
                        packed[s, :n] = raws[buckets[s][ev]]
                        pidx[s, :n] = slot_vecs[s]
                        if n < bs:
                            # edge pad per shard, as the pure-sharded
                            # dispatcher's _pack_bucket pads
                            pidx[s, n:] = pidx[s, n - 1]
                res = self.dispatcher.run_packed(
                    packed, pidx, *self._stacked_views(views))
                for s, ev in enumerate(ready_evs):
                    n = len(ev)
                    if n:
                        out[buckets[s][ev]] = res[s, :n]
                        done[s][ev] = True
                passes += 1
            if passes > 1:
                self.joint_metrics["extra_passes"] += passes - 1
            return out, gen

    def prefetch(self, tenant_idx: np.ndarray) -> int:
        """Per-shard anti-stall prefetch (each shard's copy overlaps its
        own lock independently, one shard's lock at a time); returns total
        rows staged."""
        tid = np.asarray(tenant_idx, np.int64).ravel()
        if tid.size == 0:
            return 0
        local, buckets = self._bucket(tid)
        staged = 0
        for s, st in enumerate(self.shards):
            if len(buckets[s]):
                staged += st.prefetch(local[buckets[s]])
        return staged

    def pre_quantile(self, expert_scores: np.ndarray,
                     tenant_idx: np.ndarray) -> np.ndarray:
        """Per-event T^Q input through each row's owning shard (row-local
        numpy math — identical values to the single-store path)."""
        raws = np.asarray(expert_scores, np.float32)
        tid = np.asarray(tenant_idx, np.int64).ravel()
        local, buckets = self._bucket(tid)
        out: np.ndarray | None = None
        for s, st in enumerate(self.shards):
            if not len(buckets[s]):
                continue
            vals = st.pre_quantile(raws[buckets[s]], local[buckets[s]])
            if out is None:
                out = np.empty(len(tid), vals.dtype)
            out[buckets[s]] = vals
        return out if out is not None else np.empty(0, np.float32)

    # -------------------------------------------------------------- control
    def rebalance(self, *, generation: int | None = None) -> dict[str, int]:
        """One promotion/demotion/admission pass on EVERY shard under the
        full lock set (generation fencing checked once, against the
        lockstep store generation)."""
        with self._locked():
            cur = self.shards[0]._view.generation
            if generation is not None and generation < cur:
                raise StaleGenerationError(generation, cur)
            agg = {"admitted": 0, "promoted": 0, "demoted": 0}
            for st in self.shards:
                r = st.rebalance()
                agg["admitted"] += r["admitted"]
                agg["promoted"] += r["promoted"]
                agg["demoted"] += r["demoted"]
            return {**agg, "generation": cur}

    def apply_updates(self, updates: Mapping[int, "QuantileMap | tuple"],
                      *, generation: int | None = None) -> int:
        """Publish refreshed T^Q tables (GLOBAL row ids) into every
        shard's host rows AND device-resident copies under ONE generation.

        All shard locks are held across the whole publish; every shard's
        ``apply_updates`` lands with the SAME explicit generation
        (untouched shards take an empty fenced fast-forward), so per-shard
        generations can never diverge.  Row ids and table widths are
        validated BEFORE the first shard write — a bad update raises with
        no shard touched.  Fencing matches
        :meth:`TieredBankStore.apply_updates`.
        """
        with self._locked():
            cur = self.shards[0]._view.generation
            if generation is None:
                if not updates:
                    return cur
                gen = cur + 1
            else:
                if generation <= cur:
                    raise StaleGenerationError(generation, cur)
                gen = generation
            n = self.shards[0].host.num_quantiles
            per: list[dict] = [dict() for _ in range(self.num_shards)]
            for row, value in updates.items():
                if not 0 <= row < self.num_rows:
                    raise IndexError(
                        f"row {row} outside store of {self.num_rows}")
                # dry-run pad: raises ValueError on an over-wide table
                # BEFORE any shard is written
                pad_quantile_tables(value, n, row=row)
                per[int(self.shard_of[row])][int(self.local_of[row])] = value
            for s, st in enumerate(self.shards):
                st.apply_updates(per[s], generation=gen)
            return gen

    def mark_cold(self, rows: Sequence[int]) -> None:
        """Send GLOBAL rows back behind the Eq.-5 gate on their owning
        shards."""
        ids = np.asarray(list(rows), np.int64)
        if not len(ids):
            return
        local, buckets = self._bucket(ids)
        for s, st in enumerate(self.shards):
            if len(buckets[s]):
                st.mark_cold(local[buckets[s]])

    def seen(self, row: int) -> int:
        return self.shards[int(self.shard_of[row])].seen(
            int(self.local_of[row]))

    # ---------------------------------------------------------- persistence
    def hotness_snapshot(self) -> dict:
        """GLOBAL-indexed hotness/admission state — the layout a single
        :class:`TieredBankStore` emits, so rollouts warm start across
        topologies (single-tier <-> sharded-tier)."""
        t = self.num_rows
        scores = np.zeros(t, np.float64)
        seen = np.zeros(t, np.int64)
        adm = np.zeros(t, bool)
        windows = 0
        with self._locked():
            for s, st in enumerate(self.shards):
                g = self.global_of[s]
                scores[g] = st.tracker.scores()
                seen[g] = st._seen
                adm[g] = st.host.admitted
                windows = max(windows, st.tracker.windows)
        return {"tracker": {"num_keys": t, "decay": float(self.config.decay),
                            "scores": scores, "windows": windows},
                "seen": seen, "admitted": adm}

    def adopt_hotness(self, snap: dict) -> None:
        scores = np.asarray(snap["tracker"]["scores"], np.float64)
        seen = np.asarray(snap["seen"], np.int64)
        adm = np.asarray(snap["admitted"], bool)
        windows = int(snap["tracker"].get("windows", 0))
        n = min(len(scores), self.num_rows)
        with self._locked():
            for s, st in enumerate(self.shards):
                g = self.global_of[s]
                valid = g < n
                # rows past the snapshot (size mismatch) keep their local
                # seen/admitted state — the single store's prefix-adopt
                # semantics; tracker scores reset to 0 either way
                sub_scores = np.zeros(len(g), np.float64)
                sub_seen = st._seen.copy()
                sub_adm = st.host.admitted.copy()
                sub_scores[valid] = scores[g[valid]]
                sub_seen[valid] = seen[g[valid]]
                sub_adm[valid] = adm[g[valid]]
                st.adopt_hotness({
                    "tracker": {"num_keys": len(g),
                                "decay": float(self.config.decay),
                                "scores": sub_scores, "windows": windows},
                    "seen": sub_seen, "admitted": sub_adm})


__all__ = ["HostBankStore", "ShardedTieredBankStore", "TieredBankStore",
           "TieringConfig", "prior_bank_row"]
