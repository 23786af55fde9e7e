"""Closed-loop distribution-drift monitoring + automated calibration refresh.

Implements the paper's FIRST roadmap item (Sec. 5): "automatically trigger
background re-fitting of the Quantile Mapping, based on a closed-loop
distribution drift monitoring, ensuring stability between model retrains."

Mechanism:
  * every served (tenant, predictor) score stream feeds a rolling window;
  * drift of the *post-T^Q* distribution against the reference R is measured
    with PSI (population stability index — the industry-standard banking
    drift score) and JSD;
  * when PSI exceeds the alarm threshold AND the Eq.-5 sample-size gate for
    the raw-score stream is open, the controller re-fits the tenant's source
    quantiles from live raw scores and hot-swaps T^Q — no deployment event
    needed, closing the loop the paper leaves open.

PSI interpretation (standard): < 0.1 stable, 0.1-0.25 moderate, > 0.25 action.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np


def psi(observed: np.ndarray, expected: np.ndarray, eps: float = 1e-6) -> float:
    """Population Stability Index between two discrete distributions."""
    o = np.asarray(observed, np.float64) + eps
    e = np.asarray(expected, np.float64) + eps
    o /= o.sum()
    e /= e.sum()
    return float(np.sum((o - e) * np.log(o / e)))


def reference_bin_masses(ref_quantiles: np.ndarray, edges: np.ndarray,
                         levels: np.ndarray | None = None) -> np.ndarray:
    """Expected bin masses of the reference distribution R at ``edges``."""
    tq = np.asarray(ref_quantiles, np.float64)
    if levels is None:
        levels = np.linspace(0.0, 1.0, len(tq))
    cdf = np.interp(edges, tq, levels, left=0.0, right=1.0)
    return np.diff(cdf)


def transformed_stream_psi(transformed_scores: np.ndarray,
                           ref_quantiles: np.ndarray,
                           n_bins: int = 10) -> float:
    """PSI of an (already T^Q-mapped) score sample against the reference R.

    The calibration controller's candidate-validation bound: a refreshed
    T^Q applied to the very stream it was fitted on must land close to R —
    a large PSI here means the fit is untrustworthy (degenerate support,
    poisoned stream), and the candidate must not be published.
    """
    s = np.asarray(transformed_scores, np.float64).ravel()
    if len(s) == 0:
        return float("inf")
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    expected = reference_bin_masses(ref_quantiles, edges)
    counts, _ = np.histogram(np.clip(s, 0.0, 1.0), bins=edges)
    return psi(counts / len(s), expected)


def realized_alert_rate(transformed_scores: np.ndarray,
                        ref_quantiles: np.ndarray,
                        target_alert_rate: float,
                        levels: np.ndarray | None = None) -> float:
    """Fraction of scores above the reference alert threshold.

    The client threshold tau is the (1 - a) quantile of R (a = target alert
    rate); the paper's headline invariant is that a calibration refresh keeps
    the realized rate at tau within the Eq.-5 error band of a.
    """
    tq = np.asarray(ref_quantiles, np.float64)
    if levels is None:
        levels = np.linspace(0.0, 1.0, len(tq))
    tau = float(np.interp(1.0 - target_alert_rate, levels, tq))
    s = np.asarray(transformed_scores, np.float64).ravel()
    if len(s) == 0:
        return float("nan")
    return float(np.mean(s >= tau))


@dataclasses.dataclass
class DriftMonitor:
    """Rolling-window drift detector for one (tenant, predictor) stream."""

    ref_quantiles: np.ndarray
    window: int = 20_000
    n_bins: int = 10
    psi_alarm: float = 0.25

    def __post_init__(self) -> None:
        self._buf = np.empty(self.window, np.float64)
        self._n = 0
        self._total = 0
        self.edges = np.linspace(0.0, 1.0, self.n_bins + 1)
        self.expected = reference_bin_masses(self.ref_quantiles, self.edges)

    def update(self, served_scores: np.ndarray) -> None:
        s = np.asarray(served_scores, np.float64).ravel()
        for v in s:  # ring buffer
            self._buf[self._total % self.window] = v
            self._total += 1
        self._n = min(self._total, self.window)

    @property
    def count(self) -> int:
        return self._total

    def current_psi(self) -> float:
        if self._n < self.n_bins * 20:  # too little data to bin
            return 0.0
        counts, _ = np.histogram(self._buf[: self._n], bins=self.edges)
        return psi(counts / self._n, self.expected)

    def drifted(self) -> bool:
        return self.current_psi() > self.psi_alarm


@dataclasses.dataclass
class CalibrationRefreshController:
    """The closed loop: monitor drift -> gate on Eq. 5 -> refresh T^Q.

    Wire into a MuseServer with ``attach``; afterwards every ``score_batch``
    feeds the monitors and ``tick`` applies any due refreshes.
    """

    # MuseServer; may be None when ``fleet`` is set (the fleet plane then
    # supplies both the Eq.-5 gate and the refresh machinery)
    server: "object | None"
    ref_quantiles: np.ndarray
    psi_alarm: float = 0.25
    window: int = 20_000
    # ticks an alarmed-but-rejected stream sits out before the next refresh
    # attempt — a persistently poisoned stream must not re-run the pooled
    # refit + validation of its whole predictor on every tick
    reject_cooldown: int = 5
    refreshes: list[tuple[str, str, float]] = dataclasses.field(
        default_factory=list)
    # rejected/vetoed attempts, for operators: (tenant, predictor, reasons)
    rejections: list[tuple[str, str, tuple[str, ...]]] = dataclasses.field(
        default_factory=list)
    # optional calibration.FleetCalibrationController: when set, tick()
    # routes due refreshes through the fleet plane (merged sketches, one
    # fenced broadcast) instead of a single-server CalibrationController
    fleet: "object | None" = None

    def __post_init__(self) -> None:
        self._monitors: dict[tuple[str, str], DriftMonitor] = {}
        self._cooldown: dict[tuple[str, str], int] = {}

    def observe(self, tenant: str, predictor: str,
                served_scores: np.ndarray) -> None:
        key = (tenant, predictor)
        mon = self._monitors.get(key)
        if mon is None:
            mon = DriftMonitor(self.ref_quantiles, window=self.window,
                               psi_alarm=self.psi_alarm)
            self._monitors[key] = mon
        mon.update(served_scores)

    def attach(self) -> None:
        """Wrap server.score_batch so served scores feed the monitors."""
        inner = self.server.score_batch

        def wrapped(requests):
            responses = inner(requests)
            by_key: dict[tuple[str, str], list[float]] = {}
            for req, resp in zip(requests, responses):
                by_key.setdefault((req.intent.tenant, resp.predictor),
                                  []).append(resp.score)
            for (tenant, pred), scores in by_key.items():
                self.observe(tenant, pred, np.asarray(scores))
            return responses

        self.server.score_batch = wrapped

    def tick(self) -> list[tuple[str, str, float]]:
        """Run one control-loop pass; returns refreshes performed.

        Drift-alarmed streams past the Eq.-5 gate are refreshed through
        ``CalibrationController.refresh_fleet(only=...)`` — the SAME
        gate/validate/atomic-publish machinery as the fleet-wide pass, so a
        poisoned or degenerate stream that trips the drift alarm can never
        ship an unvalidated T^Q, and all due refreshes land as ONE bank
        generation instead of a swap per stream.
        """
        for key in list(self._cooldown):
            self._cooldown[key] -= 1
            if self._cooldown[key] <= 0:
                del self._cooldown[key]
        alarmed = {(t, p): mon.current_psi()
                   for (t, p), mon in self._monitors.items()
                   if mon.drifted() and (t, p) not in self._cooldown}
        if not alarmed:
            return []
        if self.fleet is not None:
            # fleet mode: the Eq.-5 gate must see what the FLEET saw, not
            # any single replica — replicas come and go across rolling
            # updates, and each holds only its shard of a tenant's events.
            # Gate on the merged per-stream estimators (the same view the
            # refresh itself will fit on); ``server`` may be None here.
            pol = self.fleet.policy
            merged = self.fleet.scan()
            due = {}
            for key, psi_val in alarmed.items():
                est = merged.get(key)
                if est is not None and est.ready(pol.alert_rate,
                                                 pol.rel_error, pol.z):
                    due[key] = psi_val
        else:
            due = {key: psi_val for key, psi_val in alarmed.items()
                   if self.server.calibration_ready(*key)}
        if not due:
            return []
        if self.fleet is not None:
            # fleet path: same gate/validate machinery, but on merged
            # replica sketches, published as one fenced fleet generation
            result = self.fleet.refresh_fleet(only=set(due))
        else:
            # local import: calibration.py imports this module's validators
            from repro_torch.serving.calibration import (
                CalibrationController,
                RefreshPolicy,
            )
            cfg = self.server.config
            ctrl = CalibrationController(
                self.server, self.ref_quantiles,
                RefreshPolicy(alert_rate=cfg.refresh_alert_rate,
                              rel_error=cfg.refresh_rel_error,
                              psi_bound=self.psi_alarm))
            result = ctrl.refresh_fleet(only=set(due))
        refreshed_keys = {(r.tenant, r.predictor) for r in result.refreshed}
        for rep in result.rejected:
            self.rejections.append((rep.tenant, rep.predictor, rep.reasons))
        for key in due:
            if key not in refreshed_keys:   # rejected or vetoed: back off
                self._cooldown[key] = self.reject_cooldown
        done = []
        for rep in result.refreshed:
            key = (rep.tenant, rep.predictor)
            # refresh_fleet widens to predictor granularity, so peers of an
            # alarmed tenant may be refreshed without an alarm of their own:
            # report their current (sub-alarm) PSI
            psi_val = due.get(key)
            if psi_val is None:
                mon = self._monitors.get(key)
                psi_val = mon.current_psi() if mon is not None else 0.0
            # reset the window so the new transformation is judged fresh
            self._monitors[key] = DriftMonitor(
                self.ref_quantiles, window=self.window,
                psi_alarm=self.psi_alarm)
            done.append((rep.tenant, rep.predictor, psi_val))
        self.refreshes.extend(done)
        return done
