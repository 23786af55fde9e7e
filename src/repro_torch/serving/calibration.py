"""Fleet-wide atomic calibration refresh — the T^Q control plane.

The paper's core promise (Sec. 3.1) is that retraining-induced score-
distribution shift never invalidates client thresholds: the Quantile Mapping
T^Q is refit from the live stream and swapped in minutes, fleet-wide, so a
model update is invisible to every tenant's alerting rules.  This module is
that control plane.  :class:`CalibrationController.refresh_fleet` runs one
pass of the update lifecycle; each step maps onto the paper:

  1. **Scan** — enumerate every live (tenant, predictor) score stream the
     server has accumulated (the unlabeled post-aggregation T^Q *input*
     distribution, Sec. 2.3.3 — fitting needs no labels).
  2. **Gate (Eq. 5)** — a stream is refit only once it holds at least
     ``n = z^2 (1-a) / (delta^2 a)`` samples, the Appendix-A bound ensuring
     the realized alert rate at the fitted threshold deviates from the
     target ``a`` by at most ``delta`` (relative) with confidence ``z``.
  3. **Refit** — ALL ready streams are refit in ONE vectorized pass
     (:func:`repro_torch.core.quantiles.batch_sample_quantiles`): reservoirs are
     padded into a single matrix and every tenant's source quantile table
     comes out of one ``np.nanquantile`` call (Eq. 4's q^S_i, fleet-wide).
  4. **Validate** — each candidate T^Q is checked against the live stream
     before it may ship: monotone non-decreasing knots (rank preservation,
     the paper's ROC invariant), non-degenerate support coverage, and a
     drift bound — PSI of the candidate-mapped stream against the reference
     R plus a realized-alert-rate band (``serving/drift.py``).  A failed
     candidate is withheld; the old map keeps serving.
  5. **Publish (atomic)** — every validated map lands in ONE
     ``MuseServer.publish_quantile_maps`` call: all affected model-group
     ``TransformBank``s are rebuilt as new immutable objects stamped with a
     bumped generation, then the server's references are swapped wholesale.
     In-flight dispatches finish on the old bank; the next window sees the
     new one — no torn reads, no partially-refreshed fleet.

Wired into ``serving/rollout.py``, a model promotion triggers the refresh
automatically — the paper's "model lead time from weeks to minutes",
testable end-to-end (``tests/test_calibration_refresh.py``).

The fleet calibration plane
---------------------------

One :class:`CalibrationController` refreshes ONE replica.  A fleet behind a
load balancer needs more: refreshing each replica independently lets N
replicas expose N divergent ``bank_generation``s to the same tenant
mid-update.  :class:`FleetCalibrationController` lifts calibration out of
the replica into a fleet-level control plane:

  * **who fits** — the fleet controller PULLS an exact estimator checkpoint
    snapshot from every replica (``MuseServer.snapshot_estimator_checkpoints``,
    the PR-5 serialization as wire format), reduces them per (tenant,
    predictor) with ``StreamingQuantileEstimator.merge_checkpoints`` (a
    mergeable-sketch reduction with a documented rank-error bound, see
    ``core/quantiles.py``), and runs the Eq.-5 gate → vectorized refit →
    candidate validation ONCE on the merged view — the fit sees the union
    of what every replica saw.
  * **who publishes** — the fleet controller broadcasts the validated maps
    to every replica under ONE fleet-stamped target generation
    (``publish_quantile_maps(updates, generation=...)``); on engine-backed
    replicas the publish lands at a stage boundary
    (``AsyncDispatchEngine.schedule_control``).  Replica acks advance the
    fleet generation; per-replica pull or publish failures become
    structured report entries (``pull_failures`` / ``nacked``), never a
    raise mid-refresh, and a fully failed pass leaves the fleet generation
    unchanged.
  * **what fences** — a replica rejects any fleet publish that is not
    strictly newer than what it already serves
    (:class:`~repro_torch.serving.server.StaleGenerationError`), so a late ack
    from a superseded pass can never roll a replica backwards; a straggler
    that never acks keeps serving its complete OLD plane (old maps, old
    generation — internally consistent), and the generation-fenced
    ``ReplicaSet.dispatch`` keeps every client stream on replicas at or
    above its observed generation, making ``bank_generation`` fleet-
    monotone per stream, not just per replica.

This module is the HOST-PULL BOUNDARY for fused device tracking
(``ServerConfig(track_device=True)``): while serving, per-window samples
accumulate in the :class:`~repro_torch.kernels.quantile_track.DeviceQuantileTracker`
staging buffer and the host estimators lag behind.  Every scan entry
point the controllers use — ``estimator_streams``,
``snapshot_estimator_checkpoints``, ``calibration_ready``,
``fit_custom_quantile_map``, ``save_estimators`` — first drains the
device stage under the server's estimator lock, replaying the exact
original window boundaries, so everything here (Eq.-5 gates, merges,
refits, checkpoints) observes estimator state bitwise identical to
eager host tracking.  Nothing in this module needs to know which
tracking mode a replica runs.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Mapping

import numpy as np
import torch

from repro_torch.core.quantiles import (
    StreamingQuantileEstimator,
    batch_sample_quantiles,
)
from repro_torch.core.transforms import QuantileMap
from repro_torch.serving.drift import realized_alert_rate, transformed_stream_psi


@dataclasses.dataclass(frozen=True)
class RefreshPolicy:
    """Gating + validation knobs for one fleet refresh pass."""

    alert_rate: float = 0.01        # Eq. 5 target alert rate ``a``
    rel_error: float = 0.2          # Eq. 5 relative error ``delta``
    z: float = 1.96                 # Eq. 5 confidence (95%)
    n_levels: int = 256             # knots in the refitted T^Q tables
    psi_bound: float = 0.25         # candidate-vs-reference drift bound
    alert_rate_tolerance: float = 0.5   # |realized - a| / a bound at tau
    min_distinct_knots: int = 8     # support coverage: degenerate-fit guard
    drift_bins: int = 10
    # which window the refit (and its validation) sees per stream:
    #   "reservoir" — the all-time uniform reservoir (default; right when
    #     the stream is stationary-but-miscalibrated, e.g. after a model
    #     promotion);
    #   "recent"    — the newest-samples ring (the Full-range-Calibration
    #     regime: a FAST-drifting malicious distribution is diluted to
    #     invisibility in the all-time reservoir, so a drift-triggered
    #     refresh must fit on what the stream looks like NOW).
    # The Eq.-5 gate still counts total observed events either way.
    fit_window: str = "reservoir"


@dataclasses.dataclass(frozen=True)
class CandidateReport:
    """Per-(tenant, predictor) outcome of one refresh pass."""

    tenant: str
    predictor: str
    samples: int                     # total events the stream has observed
    # "refreshed" | "not_ready" | "rejected" | "pull_failed"
    status: str
    reasons: tuple[str, ...] = ()
    psi: float = math.nan
    realized_alert_rate: float = math.nan


@dataclasses.dataclass(frozen=True)
class StreamSnapshot:
    """Materialized view of one (tenant, predictor) stream for a fit pass.

    The gate/refit/validate machinery operates on snapshots, not live
    estimators: a single-replica pass snapshots its server's streams, the
    fleet pass snapshots MERGED estimators — same fit code either way, and
    a stream whose estimator fails mid-pull surfaces as a structured
    ``pull_failed`` report instead of aborting the whole refresh.
    """

    tenant: str
    predictor: str
    count: int
    values: np.ndarray
    recent: np.ndarray
    ready: bool


@dataclasses.dataclass(frozen=True)
class RefreshResult:
    """Outcome of one ``refresh_fleet`` pass."""

    generation: int                  # server bank generation after the pass
    reports: tuple[CandidateReport, ...]
    refit_seconds: float
    validate_seconds: float
    publish_seconds: float
    # engine stage-boundary counter when the pass was scheduled from an
    # AsyncDispatchEngine (-1 for direct/synchronous invocations)
    epoch: int = -1

    def _with(self, status: str) -> list[CandidateReport]:
        return [r for r in self.reports if r.status == status]

    @property
    def refreshed(self) -> list[CandidateReport]:
        return self._with("refreshed")

    @property
    def rejected(self) -> list[CandidateReport]:
        return self._with("rejected")

    @property
    def not_ready(self) -> list[CandidateReport]:
        return self._with("not_ready")

    @property
    def pull_failed(self) -> list[CandidateReport]:
        return self._with("pull_failed")


class CalibrationController:
    """The calibration control plane for one :class:`MuseServer`.

    Owns the scan -> gate -> refit -> validate -> publish loop described in
    the module docstring.  The controller never mutates served state except
    through the server's atomic ``publish_quantile_maps`` — the data plane
    cannot observe a half-applied refresh.
    """

    def __init__(self, server: "object", ref_quantiles: np.ndarray,
                 policy: RefreshPolicy | None = None) -> None:
        self.server = server
        self.ref_quantiles = np.asarray(ref_quantiles, np.float64)
        self.policy = policy or RefreshPolicy()
        self.history: list[RefreshResult] = []

    # ------------------------------------------------------------------ scan
    def scan(self) -> dict[tuple[str, str], "object"]:
        """Step 1: every live (tenant, predictor) estimator stream."""
        return self.server.estimator_streams()

    def ready(self) -> dict[tuple[str, str], "object"]:
        """Step 2: streams past the Eq. 5 sample-size gate."""
        p = self.policy
        return {k: est for k, est in self.scan().items()
                if est.ready(p.alert_rate, p.rel_error, p.z)}

    @staticmethod
    def _support_coverage(src: np.ndarray, stream: np.ndarray) -> float:
        lo, hi = src[0], src[-1]
        span = max(hi - lo, 1e-12)
        return float(np.mean((stream >= lo - 0.01 * span)
                             & (stream <= hi + 0.01 * span)))

    # -------------------------------------------------------------- validate
    def _validate(self, src: np.ndarray, ref: np.ndarray, stream: np.ndarray,
                  recent: np.ndarray | None = None,
                  ) -> tuple[tuple[str, ...], float, float]:
        """Step 4 checks for one candidate against one live stream.

        ``recent`` is the stream's newest-samples window: the candidate was
        fitted on the (all-time, uniformly sampled) reservoir, so checking
        support coverage against the reservoir alone is vacuous — a shift
        that happened AFTER the reservoir filled is diluted to near
        invisibility there, but dominates the recent window and must fail
        coverage.  Returns (failure reasons, psi, realized alert rate);
        empty reasons means the candidate may ship for this stream.
        """
        p = self.policy
        reasons: list[str] = []
        if not np.isfinite(src).all():
            reasons.append("non_finite_knots")
        if np.any(np.diff(src) < -1e-9):
            reasons.append("non_monotone")
        if len(np.unique(src)) < p.min_distinct_knots:
            reasons.append("degenerate_support")
        if self._support_coverage(src, stream) < 0.99:
            reasons.append("support_coverage")
        if recent is not None and len(recent) \
                and self._support_coverage(src, recent) < 0.98:
            reasons.append("support_coverage_recent")
        if reasons:
            return tuple(reasons), math.nan, math.nan
        # drift bound: map the live stream through the candidate and compare
        # against R (np.interp == Eq. 4 on monotone tables, clipped to R)
        mapped = np.interp(stream, src, ref)
        drift = transformed_stream_psi(mapped, self.ref_quantiles,
                                       n_bins=p.drift_bins)
        rate = realized_alert_rate(mapped, self.ref_quantiles, p.alert_rate)
        if drift > p.psi_bound:
            reasons.append("psi_bound")
        if abs(rate - p.alert_rate) / p.alert_rate > p.alert_rate_tolerance:
            reasons.append("alert_rate_shift")
        return tuple(reasons), drift, rate

    # ------------------------------------------------------------- snapshot
    def _snapshot(self, streams: "Mapping[tuple[str, str], object]",
                  only: "set[tuple[str, str]] | None" = None,
                  ) -> tuple[dict[tuple[str, str], StreamSnapshot],
                             list[CandidateReport]]:
        """Materialize live estimators into :class:`StreamSnapshot`s.

        ``only`` is widened to PREDICTOR granularity here: a published map
        recalibrates every tenant on that predictor, so all of its live
        streams must join the pooled refit and the validation (otherwise a
        single alarmed tenant could silently shift its peers' alert rates —
        the veto invariant would be bypassed).  A stream whose estimator
        raises mid-read (its replica/predictor vanished between scan and
        pull) becomes a structured ``pull_failed`` report instead of
        aborting the pass.
        """
        p = self.policy
        if only is not None:
            preds = {pred for _, pred in only}
            streams = {k: v for k, v in streams.items() if k[1] in preds}
        snaps: dict[tuple[str, str], StreamSnapshot] = {}
        failures: list[CandidateReport] = []
        for (tenant, pred), est in streams.items():
            try:
                recent = np.asarray(est.recent(), np.float64) \
                    if hasattr(est, "recent") else np.empty(0, np.float64)
                snaps[(tenant, pred)] = StreamSnapshot(
                    tenant, pred, est.count,
                    np.asarray(est.values(), np.float64), recent,
                    est.ready(p.alert_rate, p.rel_error, p.z))
            except Exception as e:  # noqa: BLE001 — stream gone mid-scan
                failures.append(CandidateReport(
                    tenant, pred, 0, "pull_failed",
                    reasons=(f"pull:{type(e).__name__}",)))
        return snaps, failures

    # ------------------------------------------------------------------ plan
    def _plan(self, snaps: dict[tuple[str, str], StreamSnapshot],
              ) -> tuple[dict[str, QuantileMap], list[CandidateReport],
                         float, float]:
        """Steps 2–4 on materialized snapshots: gate, ONE vectorized refit,
        per-stream validation.  Returns (validated updates, reports,
        refit seconds, validate seconds) — publish is the caller's job (one
        atomic swap for a single server; a fenced fleet broadcast for the
        fleet plane)."""
        p = self.policy
        ready = {k: s for k, s in snaps.items() if s.ready}
        not_ready_reports: dict[tuple[str, str], CandidateReport] = {
            (t, pred): CandidateReport(t, pred, s.count, "not_ready",
                                       reasons=("eq5_gate",))
            for (t, pred), s in snaps.items() if (t, pred) not in ready
        }

        # Step 3: one vectorized refit across the whole ready fleet.  Ready
        # streams are grouped by predictor (the published unit); a predictor
        # serving several ready tenant streams is refit on the pooled
        # samples, and the pooled candidate must validate against EVERY
        # tenant's stream before it may ship.  ``fit_window`` picks WHICH
        # samples: the all-time reservoir, or (for fast-drift refreshes)
        # the recent ring — validated against the same window, since that
        # is the distribution the candidate will serve next.
        def fit_values(s: StreamSnapshot) -> np.ndarray:
            if p.fit_window == "recent" and len(s.recent):
                return s.recent
            return s.values

        t0 = time.perf_counter()
        by_pred: dict[str, list[StreamSnapshot]] = {}
        for (tenant, pred), s in ready.items():
            by_pred.setdefault(pred, []).append(s)
        pred_names = sorted(by_pred)
        levels = np.linspace(0.0, 1.0, p.n_levels)
        pooled = [np.concatenate([fit_values(s) for s in by_pred[n]])
                  for n in pred_names]
        src_tables = batch_sample_quantiles(pooled, levels)   # (R, n_levels)
        refit_s = time.perf_counter() - t0

        # Step 4: per-stream validation of each predictor's candidate.
        t0 = time.perf_counter()
        ref = np.interp(levels, np.linspace(0.0, 1.0, len(self.ref_quantiles)),
                        self.ref_quantiles)
        updates: dict[str, QuantileMap] = {}
        reports: list[CandidateReport] = []
        for row, pred in enumerate(pred_names):
            src = src_tables[row]
            ship = True
            stream_reports: list[CandidateReport] = []
            for s in by_pred[pred]:
                reasons, drift, rate = self._validate(
                    src, ref, fit_values(s),
                    s.recent if len(s.recent) else None)
                ok = not reasons
                ship = ship and ok
                stream_reports.append(CandidateReport(
                    s.tenant, pred, s.count,
                    "refreshed" if ok else "rejected", reasons, drift, rate))
            # NOT-ready peer streams of this predictor are recalibrated by
            # the publish too, yet never joined the pool — give them a
            # support-coverage vote (robust at small n, unlike PSI/rate):
            # traffic outside the candidate's support must veto the publish
            for (t2, p2), s in snaps.items():
                if p2 != pred or (t2, p2) in ready:
                    continue
                peer_reasons: list[str] = []
                if len(s.values) and \
                        self._support_coverage(src, s.values) < 0.99:
                    peer_reasons.append("support_coverage")
                if len(s.recent) and \
                        self._support_coverage(src, s.recent) < 0.98:
                    peer_reasons.append("support_coverage_recent")
                if peer_reasons:
                    ship = False
                    not_ready_reports[(t2, p2)] = dataclasses.replace(
                        not_ready_reports[(t2, p2)],
                        reasons=("eq5_gate", *peer_reasons))
            if ship:
                updates[pred] = QuantileMap(
                    src_quantiles=torch.as_tensor(src, dtype=torch.float32),
                    ref_quantiles=torch.as_tensor(ref, dtype=torch.float32))
                reports.extend(stream_reports)
            else:
                # withhold the whole predictor: publishing a map one of its
                # tenants rejects would shift that tenant's alert rate.
                # Streams that passed individually are marked as vetoed so
                # the report distinguishes "this stream failed" from "a
                # peer tenant on the shared predictor failed".
                reports.extend(
                    r if r.status == "rejected" else dataclasses.replace(
                        r, status="rejected", reasons=("vetoed_by_peer",))
                    for r in stream_reports)
        reports = list(not_ready_reports.values()) + reports
        validate_s = time.perf_counter() - t0
        return updates, reports, refit_s, validate_s

    # --------------------------------------------------------------- refresh
    def refresh_fleet(self, only: "set[tuple[str, str]] | None" = None,
                      *, epoch: int = -1) -> RefreshResult:
        """One full pass: scan, gate, vectorized refit, validate, publish.

        ``epoch`` is the engine stage-boundary counter when the pass is
        scheduled through ``AsyncDispatchEngine.schedule_refresh`` (stamped
        into the result; -1 for direct synchronous calls).

        ``only`` restricts the pass to the given (tenant, predictor) keys —
        the drift-triggered path (``drift.py::CalibrationRefreshController``)
        refreshes just its alarmed streams through the same gate/validate/
        atomic-publish machinery (widened to predictor granularity, see
        :meth:`_snapshot`).  Returns a :class:`RefreshResult`; the publish
        (if any stream was refreshed) is a single atomic generation bump on
        the server.
        """
        snaps, failures = self._snapshot(self.scan(), only)
        updates, reports, refit_s, validate_s = self._plan(snaps)

        # Step 5: one atomic publish for the entire server.
        t0 = time.perf_counter()
        generation = self.server.publish_quantile_maps(updates) \
            if updates else self.server.bank_generation
        if updates:
            # tiered topology: a publish may have just admitted tenants past
            # the Eq.-5 gate (their first calibrated map landed) — run one
            # promotion pass so they get real hot/victim slots instead of
            # paging on their next window.  No-op on non-tiered servers;
            # under tiered-over-sharded this rebalances every shard's tier
            # in one lockstep pass (per-shard clocks, one store op).
            rebalance = getattr(self.server, "rebalance_tiers", None)
            if rebalance is not None:
                rebalance()
        publish_s = time.perf_counter() - t0

        result = RefreshResult(
            generation=generation, reports=tuple(failures + reports),
            refit_seconds=refit_s, validate_seconds=validate_s,
            publish_seconds=publish_s, epoch=epoch)
        self.history.append(result)
        return result


# --------------------------------------------------------------------------
# Fleet-level calibration plane
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReplicaPullFailure:
    """One replica whose estimator snapshot could not be pulled this pass."""

    replica_id: str
    error: str


@dataclasses.dataclass(frozen=True)
class FleetRefreshResult(RefreshResult):
    """Outcome of one fleet-wide refresh pass.

    Extends :class:`RefreshResult` (``generation`` is the fleet generation
    after the pass) with the broadcast ledger: which replicas acked the
    fenced publish, which rejected or failed it, which could not even be
    pulled, plus the merge cost of the sketch reduction.
    """

    fleet_generation: int = -1
    acked: tuple[str, ...] = ()
    nacked: tuple[str, ...] = ()
    pull_failures: tuple[ReplicaPullFailure, ...] = ()
    merged_streams: int = 0
    merge_seconds: float = 0.0


class FleetCalibrationController(CalibrationController):
    """One calibration plane for a FLEET of replicas.

    Replaces N independent per-replica ``CalibrationController`` passes
    (which let replicas expose divergent generations to the same tenant)
    with a single pull -> merge -> fit -> fenced-broadcast pass:

      1. **Pull** — exact estimator checkpoints from every replica
         (``MuseServer.snapshot_estimator_checkpoints``).  A replica that
         fails the pull becomes a :class:`ReplicaPullFailure` entry; the
         pass continues on the replicas that answered.
      2. **Merge** — per (tenant, predictor) reduction via
         ``StreamingQuantileEstimator.merge_checkpoints`` (rank-error bound
         documented in ``core/quantiles.py``).
      3. **Fit** — the inherited ``_snapshot``/``_plan`` machinery (Eq.-5
         gate, ONE vectorized refit, per-stream validation with peer veto)
         runs once, on the merged view.
      4. **Broadcast (fenced)** — validated maps go to every replica under
         one target generation strictly above every generation currently
         served anywhere in the fleet.  Each replica's update set is
         filtered to its live predictors (an empty filtered set is a
         generation fast-forward, still an ack).  Engine-backed replicas
         apply the publish at a stage boundary via
         ``AsyncDispatchEngine.schedule_control``.  Acks advance the fleet
         generation; a replica that nacks (or never acks) keeps serving its
         complete old plane and is fenced out by
         ``MuseServer.publish_quantile_maps(..., generation=...)`` from
         ever applying a superseded pass late.

    ``replica_set`` is anything exposing ``.replicas`` (a
    ``rollout.ReplicaSet``) or an iterable of objects with ``replica_id``,
    ``server`` and optional ``engine`` attributes.
    """

    def __init__(self, replica_set: "object", ref_quantiles: np.ndarray,
                 policy: RefreshPolicy | None = None,
                 publish_timeout: float = 60.0) -> None:
        super().__init__(None, ref_quantiles, policy)
        self.replica_set = replica_set
        self.publish_timeout = publish_timeout
        self._fleet_generation = 0
        # cumulative content of the fleet plane: every map ever published,
        # newest per predictor.  Broadcasting the UNION each pass (and on
        # ``align``) makes a generation's CONTENT fleet-consistent, not just
        # its stamp: a healed straggler or a freshly surged replica receives
        # the maps it missed, so the audit ledger's (generation, predictor)
        # -> parameters relation holds across every replica (the replay
        # contract in ``serving/audit.py`` depends on this).
        self._published: dict[str, QuantileMap] = {}

    # ----------------------------------------------------------------- fleet
    def _iter_replicas(self) -> list["object"]:
        reps = getattr(self.replica_set, "replicas", self.replica_set)
        return list(reps)

    def fleet_generation(self) -> int:
        """Highest generation the fleet plane has published or observed."""
        gen = self._fleet_generation
        for rep in self._iter_replicas():
            try:
                gen = max(gen, rep.server.bank_generation)
            except Exception:  # noqa: BLE001 — unreachable replica
                continue
        return gen

    # ------------------------------------------------------------ pull/merge
    def _pull_merged(self) -> tuple[
            dict[tuple[str, str], StreamingQuantileEstimator],
            tuple[ReplicaPullFailure, ...], float]:
        """Steps 1–2: pull every replica's checkpoints, merge per stream."""
        t0 = time.perf_counter()
        parts: dict[tuple[str, str], list[tuple[dict, dict]]] = {}
        failures: list[ReplicaPullFailure] = []
        for rep in self._iter_replicas():
            try:
                snap = rep.server.snapshot_estimator_checkpoints()
            except Exception as e:  # noqa: BLE001 — structured, not raised
                failures.append(ReplicaPullFailure(
                    str(getattr(rep, "replica_id", rep)),
                    f"{type(e).__name__}: {e}"))
                continue
            for key, ckpt in snap.items():
                parts.setdefault(key, []).append(ckpt)
        merged = {key: StreamingQuantileEstimator.merge_checkpoints(ps)
                  for key, ps in parts.items()}
        return merged, tuple(failures), time.perf_counter() - t0

    def scan(self) -> dict[tuple[str, str], "object"]:
        """Step 1 fleet-wide: the MERGED per-stream estimators."""
        merged, _, _ = self._pull_merged()
        return merged

    # -------------------------------------------------------------- publish
    def _publish_to(self, rep: "object", updates: dict[str, QuantileMap],
                    target: int) -> int:
        """Fenced publish of ``updates`` to one replica at ``target``.

        Filters to the replica's live predictors (an empty filtered set is
        a pure generation fast-forward).  Engine-backed replicas apply the
        swap at a stage boundary so no in-flight window straddles it.
        """
        live = set(rep.server.predictors)
        filtered = {p: m for p, m in updates.items() if p in live}
        engine = getattr(rep, "engine", None)
        if engine is not None and hasattr(engine, "schedule_control"):
            fut = engine.schedule_control(
                lambda srv=rep.server: srv.publish_quantile_maps(
                    filtered, generation=target))
            return fut.result(timeout=self.publish_timeout)
        return rep.server.publish_quantile_maps(filtered, generation=target)

    def align(self, rep: "object") -> int:
        """Fast-forward one (new/surged) replica to the fleet generation.

        A fenced publish of the plane's RETAINED maps (everything the fleet
        has ever published, newest per predictor): the replica's banks land
        on the current fleet generation with the same CONTENT its siblings
        serve, so the fenced ``ReplicaSet.dispatch`` can route generation-
        pinned streams to it immediately and a response stamped with
        generation *g* means the same transform parameters on every
        replica.  No-op if the replica is already at or above the fleet
        generation.
        """
        target = self.fleet_generation()
        if rep.server.bank_generation >= target:
            return rep.server.bank_generation
        return self._publish_to(rep, dict(self._published), target)

    # --------------------------------------------------------------- refresh
    def refresh_fleet(self, only: "set[tuple[str, str]] | None" = None,
                      *, epoch: int = -1) -> FleetRefreshResult:
        """One fleet pass: pull, merge, gate, refit, validate, broadcast.

        Never raises on per-replica failure: pull failures surface in
        ``result.pull_failures``, publish failures in ``result.nacked``.
        The fleet generation advances iff at least one replica acked the
        fenced broadcast; a fully failed (or updateless) pass leaves it
        unchanged.
        """
        merged, pull_failures, merge_s = self._pull_merged()
        snaps, failures = self._snapshot(merged, only)
        updates, reports, refit_s, validate_s = self._plan(snaps)

        t0 = time.perf_counter()
        acked: list[str] = []
        nacked: list[str] = []
        if updates:
            failed_ids = {f.replica_id for f in pull_failures}
            replicas = [r for r in self._iter_replicas()
                        if str(getattr(r, "replica_id", r)) not in failed_ids]
            # Fence strictly above everything served anywhere in the fleet:
            # a replica that raced ahead (e.g. a local publish) cannot force
            # a sibling to accept a non-monotone stamp.
            target = self._fleet_generation
            for rep in replicas:
                target = max(target, rep.server.bank_generation)
            target += 1
            # broadcast the cumulative plane content (retained maps +
            # this pass's updates): a replica that nacked an earlier pass
            # heals to full content on its next ack, keeping (generation ->
            # parameters) fleet-consistent for the audit replay contract.
            broadcast = {**self._published, **updates}
            for rep in replicas:
                rid = str(getattr(rep, "replica_id", rep))
                try:
                    self._publish_to(rep, broadcast, target)
                except Exception as e:  # noqa: BLE001 — straggler/stale
                    nacked.append(rid)
                    reports.append(CandidateReport(
                        f"replica:{rid}", "*", 0, "pull_failed",
                        reasons=(f"publish:{type(e).__name__}",)))
                else:
                    acked.append(rid)
                    # tiered replicas: promote freshly admitted tenants now
                    # that the fenced broadcast landed on this replica
                    rebalance = getattr(rep.server, "rebalance_tiers", None)
                    if rebalance is not None:
                        try:
                            rebalance()
                        except Exception:  # noqa: BLE001 — best-effort
                            pass
            if acked:
                self._fleet_generation = target
                self._published = broadcast
        publish_s = time.perf_counter() - t0

        result = FleetRefreshResult(
            generation=self._fleet_generation,
            reports=tuple(failures + reports),
            refit_seconds=refit_s, validate_seconds=validate_s,
            publish_seconds=publish_s, epoch=epoch,
            fleet_generation=self._fleet_generation,
            acked=tuple(acked), nacked=tuple(nacked),
            pull_failures=pull_failures, merged_streams=len(snaps),
            merge_seconds=merge_s)
        self.history.append(result)
        return result
