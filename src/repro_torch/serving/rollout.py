"""Rolling deployments (paper Sec. 2.5.2 / Fig. 3 / Fig. 5).

Simulates the Kubernetes rolling update MUSE relies on, with the properties
that matter for the paper's claims:

  * replicas are versioned, stateless scoring instances (routing table +
    transformation pipelines); model containers live in a SHARED pool —
    updating transformations re-provisions zero models;
  * maxSurge=1 / maxUnavailable=0 semantics: a new replica is created, warmed
    up (real XLA compilation — the JVM-JIT analogue), and only then marked
    ready; an old replica is drained after;
  * a round-robin load balancer serves live traffic continuously during the
    update, recording per-request latency so the Fig.-5 "no SLO violation
    during rollout" claim is measurable;
  * generation-fenced session routing: ``ReplicaSet.dispatch(stream=...)``
    pins each client stream to replicas at or above the stream's observed
    ``bank_generation`` high-water mark, and ``fleet_generation()`` audits
    per-replica divergence — together with the fleet calibration plane
    (``calibration.FleetCalibrationController``, wired in via
    ``RollingUpdate(fleet_calibration=...)``) this makes generation stamps
    fleet-monotone per stream even while replicas are mid-publish or
    straggling.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Callable, Iterator

import numpy as np

from repro_torch.serving.types import ScoringRequest, ScoringResponse
from repro_torch.serving import warmup as warmup_mod


@dataclasses.dataclass
class Replica:
    replica_id: int
    server: "object"            # MuseServer (duck-typed)
    version: str
    ready: bool = False
    warmup_seconds: float = 0.0
    served: int = 0
    # optional AsyncDispatchEngine serving this replica's traffic: requests
    # route through its pipelined stage path instead of the synchronous
    # score_batch (duck-typed: needs score_batch; close() used on drain)
    engine: "object | None" = None

    def serve(self, requests: list[ScoringRequest]) -> list[ScoringResponse]:
        self.served += len(requests)
        target = self.engine if self.engine is not None else self.server
        return target.score_batch(requests)

    @property
    def bank_generation(self) -> int:
        """Transform-bank generation this replica currently serves."""
        return self.server.bank_generation


@dataclasses.dataclass(frozen=True)
class FleetGenerationAudit:
    """Snapshot of every ready replica's served bank generation.

    ``divergent`` is the condition the fleet calibration plane exists to
    prevent: two ready replicas answering the same load balancer with
    different generations, so a client stream bouncing between them can
    watch its ``bank_generation`` stamp go BACKWARDS mid-conversation.
    """

    per_replica: tuple[tuple[int, int], ...]   # (replica_id, bank_generation)
    min_generation: int
    max_generation: int

    @property
    def divergent(self) -> bool:
        return self.min_generation != self.max_generation


class ReplicaSet:
    """Round-robin load balancer over ready replicas.

    ``dispatch(..., stream=...)`` adds generation-fenced session routing:
    the set remembers the highest ``bank_generation`` each client stream
    has observed and only routes that stream to replicas serving at or
    above it, so per-stream generation stamps are monotone across the
    whole fleet even while a fleet publish (or a straggler) leaves
    replicas temporarily divergent.

    Stream floors are BOUNDED state: entries idle longer than
    ``stream_floor_ttl`` seconds are evicted, and when the table exceeds
    ``max_tracked_streams`` the least-recently-dispatched entries go first.
    Within the TTL a revived stream keeps its floor (still refuses
    rollback routing); after it, the stream re-fences from scratch — by
    then every in-fence replica has long converged past the old floor, so
    forgetting it is safe, whereas remembering every stream id ever seen
    is an unbounded leak on a long-lived balancer.
    """

    def __init__(self, replicas: list[Replica],
                 *, stream_floor_ttl: float = 3600.0,
                 max_tracked_streams: int = 100_000,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.replicas = replicas
        self._rr = itertools.count()
        self.stream_floor_ttl = stream_floor_ttl
        self.max_tracked_streams = max_tracked_streams
        self._clock = clock
        # per-stream (generation high-water mark, last-dispatch time);
        # insertion order is LRU order — touches re-insert (dict preserves
        # insertion order, so the first key is always the coldest stream)
        self._stream_floor: dict[str, tuple[int, float]] = {}

    # ------------------------------------------------------- floor eviction
    def _touch_floor(self, stream: str, floor: int) -> None:
        self._stream_floor.pop(stream, None)
        self._stream_floor[stream] = (floor, self._clock())
        self._evict_floors()

    def _evict_floors(self) -> None:
        now = self._clock()
        ttl = self.stream_floor_ttl
        expired = [s for s, (_, seen) in self._stream_floor.items()
                   if now - seen > ttl]
        for s in expired:
            del self._stream_floor[s]
        while len(self._stream_floor) > self.max_tracked_streams:
            # LRU: the first key is the least recently dispatched stream
            self._stream_floor.pop(next(iter(self._stream_floor)))

    @property
    def ready_replicas(self) -> list[Replica]:
        return [r for r in self.replicas if r.ready]

    @property
    def pod_count(self) -> int:
        return len(self.replicas)

    def fleet_generation(self) -> FleetGenerationAudit:
        """Audit helper: which generation is each ready replica serving?

        Before the fleet calibration plane, independent per-replica
        refreshes made ``audit.divergent`` the steady state during any
        update; under ``FleetCalibrationController`` the fleet converges to
        one generation per pass (stragglers excepted — and those are
        exactly what the fenced ``dispatch`` routes around).
        """
        reps = self.ready_replicas or self.replicas
        gens = tuple((r.replica_id, r.bank_generation) for r in reps)
        values = [g for _, g in gens] or [-1]
        return FleetGenerationAudit(gens, min(values), max(values))

    def stream_floor(self, stream: str) -> int:
        """Highest generation the given client stream has observed (-1 if
        the stream has never dispatched, or its floor entry expired)."""
        entry = self._stream_floor.get(stream)
        if entry is None:
            return -1
        floor, seen = entry
        if self._clock() - seen > self.stream_floor_ttl:
            return -1
        return floor

    def tracked_streams(self) -> int:
        """Number of stream-floor entries currently held (bounded by
        ``max_tracked_streams``; TTL-expired entries may still count until
        the next dispatch sweeps them)."""
        return len(self._stream_floor)

    def dispatch(self, requests: list[ScoringRequest],
                 stream: str | None = None) -> list[ScoringResponse]:
        """Route one batch to a ready replica (round-robin).

        With ``stream``, routing is generation-fenced: only replicas whose
        ``bank_generation`` is at or above the stream's high-water mark are
        eligible, and the mark advances to the highest generation stamped
        on the responses.  A stream that saw generation *g* can therefore
        never be answered under *g' < g*, no matter how divergent the
        fleet momentarily is.  Raises if no ready replica satisfies the
        floor (every up-to-date replica gone — an availability violation,
        not a silent rollback).
        """
        ready = self.ready_replicas
        if not ready:
            raise RuntimeError("no ready replicas — availability violated")
        if stream is None:
            replica = ready[next(self._rr) % len(ready)]
            return replica.serve(requests)
        floor = self.stream_floor(stream)
        eligible = [r for r in ready if r.bank_generation >= floor]
        if not eligible:
            raise RuntimeError(
                f"no ready replica at generation >= {floor} for stream "
                f"{stream!r} — refusing to serve a generation rollback")
        replica = eligible[next(self._rr) % len(eligible)]
        responses = replica.serve(requests)
        seen = max((r.bank_generation for r in responses), default=floor)
        self._touch_floor(stream, max(seen, floor))
        return responses


@dataclasses.dataclass
class RolloutEvent:
    t: float
    kind: str        # "surge" | "ready" | "drain" | "done"
    replica_id: int
    pod_count: int


class RollingUpdate:
    """maxSurge=1, maxUnavailable=0 rolling replacement of all replicas."""

    def __init__(
        self,
        replica_set: ReplicaSet,
        make_server: Callable[[], "object"],
        new_version: str,
        *,
        schema_dim: int,
        warmup_batch_sizes: tuple[int, ...] = (1, 8, 64),
        calibration_factory: Callable[["object"], "object"] | None = None,
        engine_factory: Callable[["object"], "object"] | None = None,
        fleet_calibration: "object | None" = None,
    ) -> None:
        """``calibration_factory``: optional ``server -> CalibrationController``
        hook.  When set, every promoted replica triggers a fleet calibration
        refresh right after its warm-up — the paper's Sec.-3.1 lifecycle
        where a model promotion automatically refits T^Q from the live
        streams the replica carries (no out-of-band operator step).

        ``engine_factory``: optional ``server -> AsyncDispatchEngine`` hook
        (must return a STARTED engine).  When set, every promoted replica
        serves through its own pipelined engine, the promotion refresh is
        scheduled at a stage boundary via ``engine.schedule_refresh``
        (never a quiesce), and a drained replica's engine is closed — its
        barrier guarantees no in-flight window is dropped.

        ``fleet_calibration``: optional
        ``calibration.FleetCalibrationController`` bound to this replica
        set.  When set it REPLACES the per-replica ``calibration_factory``
        path: a surged replica is generation-aligned (``align``, an empty
        fenced publish) right after warm-up so fenced session routing can
        use it immediately, and the promotion refresh is ONE fleet pass —
        pull + merge every replica's estimator sketches, fit once on the
        merged view, broadcast under a single fenced fleet generation —
        instead of N divergent per-replica publishes."""
        self.rs = replica_set
        self.make_server = make_server
        self.new_version = new_version
        self.schema_dim = schema_dim
        self.warmup_batch_sizes = warmup_batch_sizes
        self.calibration_factory = calibration_factory
        self.engine_factory = engine_factory
        self.fleet_calibration = fleet_calibration
        self.refreshes: list["object"] = []   # RefreshResult per promotion
        self._next_id = max((r.replica_id for r in replica_set.replicas),
                            default=-1) + 1
        self.events: list[RolloutEvent] = []
        self._t0 = time.perf_counter()

    def _log(self, kind: str, rid: int) -> None:
        self.events.append(RolloutEvent(
            t=time.perf_counter() - self._t0, kind=kind, replica_id=rid,
            pod_count=self.rs.pod_count,
        ))

    def steps(self) -> Iterator[str]:
        """Generator: yields after each state transition so the driver can
        interleave live traffic between transitions (Fig. 5 measurement)."""
        old = [r for r in self.rs.replicas]
        for victim in old:
            # surge: create the new replica (not yet ready)
            new = Replica(self._next_id, self.make_server(), self.new_version)
            self._next_id += 1
            if self.engine_factory is not None:
                new.engine = self.engine_factory(new.server)
            self.rs.replicas.append(new)
            self._log("surge", new.replica_id)
            yield "surged"

            # warm-up: compile every predictor at serving shapes BEFORE ready
            t0 = time.perf_counter()
            warmup_mod.warm_up(new.server, self.schema_dim,
                               batch_sizes=self.warmup_batch_sizes)
            new.warmup_seconds = time.perf_counter() - t0
            # tiered topology: a surged replica starts with EMPTY tiers (the
            # warm-up calls predictors directly, never the banked path) —
            # adopt the victim replica's hotness/admission state so the new
            # replica's first windows hit a promoted hot set instead of
            # paging its whole working set through the victim cache.
            # Hotness snapshots are GLOBAL-row-indexed, so this also warms
            # across topologies (single-tier victim -> tiered-over-sharded
            # surge and vice versa; see ShardedTieredBankStore).
            if hasattr(new.server, "warm_tiers_from"):
                new.server.warm_tiers_from(victim.server)
            if self.fleet_calibration is not None:
                # generation-align the fresh replica BEFORE it takes traffic:
                # an empty fenced publish fast-forwards its banks to the
                # fleet generation, so fenced session routing never has to
                # quarantine the newest replica behind old streams' floors.
                self.fleet_calibration.align(new)
            new.ready = True
            self._log("ready", new.replica_id)
            yield "warmed"

            # model promotion -> automatic fleet calibration refresh: refit
            # every ready (tenant, predictor) stream and publish one new
            # transform-bank generation atomically before the old replica
            # drains (clients never see the un-refreshed new model for
            # longer than one warm-up window)
            if self.fleet_calibration is not None:
                # ONE fleet pass replaces N per-replica refreshes: merged
                # sketches from every replica (new one included), one fit,
                # one fenced broadcast — no divergent generations behind
                # the load balancer while the rollout is mid-flight.
                self.refreshes.append(self.fleet_calibration.refresh_fleet())
                self._log("calibrate", new.replica_id)
                yield "calibrated"
            elif self.calibration_factory is not None:
                ctrl = self.calibration_factory(new.server)
                if new.engine is not None \
                        and hasattr(new.engine, "schedule_refresh"):
                    # refresh lands at a stage boundary of the live engine:
                    # in-flight windows finish on their snapshotted
                    # generation, the next transform stage picks up the new.
                    # Bounded wait: a wedged track executor must abort the
                    # promotion loudly, not hang the fleet mid-surge.
                    self.refreshes.append(
                        new.engine.schedule_refresh(ctrl).result(
                            timeout=300.0))
                else:
                    self.refreshes.append(ctrl.refresh_fleet())
                self._log("calibrate", new.replica_id)
                yield "calibrated"

            # drain the old replica (maxUnavailable=0: only after new is ready)
            victim.ready = False
            self.rs.replicas.remove(victim)
            if victim.engine is not None and hasattr(victim.engine, "close"):
                victim.engine.close()   # barrier: no in-flight window dropped
            self._log("drain", victim.replica_id)
            yield "drained"
        self._log("done", -1)

    def run_with_traffic(
        self,
        traffic: Iterator[list[ScoringRequest]],
        *,
        batches_per_transition: int = 5,
    ) -> list[dict]:
        """Drive the rollout while continuously serving traffic.

        Returns a timeline of {t, pod_count, ready_count, latency_ms, version}
        samples — the Fig.-5 reproduction data.
        """
        timeline: list[dict] = []

        def serve_some() -> None:
            for _ in range(batches_per_transition):
                reqs = next(traffic)
                t0 = time.perf_counter()
                resp = self.rs.dispatch(reqs)
                lat = (time.perf_counter() - t0) * 1000.0
                timeline.append({
                    "t": time.perf_counter() - self._t0,
                    "pod_count": self.rs.pod_count,
                    "ready_count": len(self.rs.ready_replicas),
                    "latency_ms": lat,
                    "version": resp[0].routing_version,
                    "batch": len(reqs),
                })

        serve_some()
        for _ in self.steps():
            serve_some()
        serve_some()
        return timeline
