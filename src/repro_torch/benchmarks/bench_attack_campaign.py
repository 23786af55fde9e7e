"""Dispatch latency under adversarial attack traffic, with the whole client
stack on.

The port's counterpart of the reference's
``benchmarks/bench_attack_campaign.py`` at its sizes and seeds.  Every
served window (128 events) runs the whole production path — the fenced
``ReplicaSet.dispatch`` over two replicas (tracking included, the banked
kernel ``csrc/score_pipeline_banked.cu`` on the card), the client
``DecisionLoop``, hash-chained ``AuditLog`` appends, and the drift
controller's ``observe`` / ``tick`` — and the benchmark compares the
dispatch latency of a window (host wall time) between

  * **quiet** — stationary benign traffic (day 0, no wave active), and
  * **attack** — an ``AttackWave`` burst on the measured tenant (fraud
    share x24, malicious mass drifted toward the boundary), which also
    makes the drift controller alarm and refresh mid-measurement.

120 measured windows a regime after 8 warm ones (30 after 4 with
``--quick``).  Beyond the reference, after each regime every audited
decision is replayed through the banked kernel from the parameters a
``GenerationLedger`` archived for its generation (each generation is
archived when a replica first serves it): the replayed score must equal
the recorded one bit for bit (the run raises otherwise).  The reference
archives the replicas' generations only at the end, and its
``ledger_generations`` are those; ``audit_generations`` are all of them.

It writes nothing unless ``--out`` names a file.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_attack_campaign \\
        [--quick] [--device cpu] [--out PATH]
"""
from __future__ import annotations

import itertools
import sys
import time

import numpy as np
import torch

from repro_torch.benchmarks import cli, paper
from repro_torch.core.predictor import PredictorSpec
from repro_torch.core.routing import Condition, Intent, RoutingTable, ScoringRule
from repro_torch.core.transforms import QuantileMap
from repro_torch.device import resolve_device
from repro_torch.experiments.fraud_world import AttackCampaign, AttackWave
from repro_torch.kernels import ops
from repro_torch.serving import (AuditLog, DecisionLoop, DecisionPolicy,
                                 FleetCalibrationController, GenerationLedger,
                                 MuseServer, RefreshPolicy, Replica,
                                 ReplicaSet, ServerConfig)
from repro_torch.serving.drift import CalibrationRefreshController
from repro_torch.serving.types import ScoringRequest
from repro_torch.training.data import TenantProfile

DIM = 8
ALERT_RATE = 0.05
REF = np.linspace(0.0, 1.0, 64)
TENANTS = ("t0", "t1")
WINDOW = 128


def _campaign() -> AttackCampaign:
    wave = AttackWave(name="burst", targets=("t0",), start_day=1,
                      duration=30, fraud_multiplier=24.0,
                      separation_scale=0.6, drift_per_day=0.02,
                      boundary_mass=0.25, boundary_scale=0.55)
    tenants = {t: TenantProfile(t, fraud_rate=0.01,
                                feature_shift=0.25 + 0.05 * i, seed=900 + i)
               for i, t in enumerate(TENANTS)}
    return AttackCampaign(tenants=tenants, waves=(wave,), promotion_days=(),
                          n_days=31, dim=DIM, seed=7)


def _expert(direction: np.ndarray, dev: torch.device):
    w = np.asarray(direction, np.float32)

    def score(x):
        # the reference's host logistic, its float32 scores on the device
        x = np.asarray(x, np.float32)
        return torch.as_tensor(
            np.asarray(1.0 / (1.0 + np.exp(-(x @ w))), np.float32),
            device=dev)

    return score


def _server(campaign: AttackCampaign, dev: torch.device) -> MuseServer:
    factories = {f"e{i}": (lambda d=campaign._direction(t): _expert(d, dev))
                 for i, t in enumerate(TENANTS)}
    rules = tuple(ScoringRule(Condition(tenants=(t,)), f"p{i}")
                  for i, t in enumerate(TENANTS)) + \
        (ScoringRule(Condition(), "p0"),)
    server = MuseServer(
        RoutingTable(rules, version="v1"),
        ServerConfig(quantile_capacity=8192, recent_capacity=512,
                     refresh_alert_rate=ALERT_RATE, refresh_rel_error=0.5),
        device=dev)
    for i, t in enumerate(TENANTS):
        server.deploy(PredictorSpec(f"p{i}", (f"e{i}",), (0.2,), (1.0,),
                                    QuantileMap.identity(64)), factories)
    return server


def _measure(campaign: AttackCampaign, days: range, n_windows: int,
             warm_windows: int, dev: torch.device) -> dict:
    """Serve ``n_windows`` of traffic drawn from ``days``; full stack ON;
    then replay every audited decision through the banked kernel."""
    reps = [Replica(i, _server(campaign, dev), "v1", ready=True)
            for i in range(2)]
    rs = ReplicaSet(reps)
    fleet = FleetCalibrationController(
        rs, REF, RefreshPolicy(alert_rate=ALERT_RATE, rel_error=0.5,
                               n_levels=64, fit_window="recent"))
    ctrl = CalibrationRefreshController(None, REF, psi_alarm=0.08,
                                        window=768, reject_cooldown=2,
                                        fleet=fleet)
    audit, ledger = AuditLog(), GenerationLedger(device=dev)
    loop = DecisionLoop(DecisionPolicy(alert_rate=ALERT_RATE,
                                       block_rate=0.001), REF, audit=audit)
    archived: set[tuple[int, int]] = set()

    def archive() -> None:
        """Archive what each ready replica serves, once a generation."""
        for rep in rs.ready_replicas:
            key = (rep.replica_id, rep.server.bank_generation)
            if key not in archived:
                ledger.record_server(rep.server)
                archived.add(key)

    rid = itertools.count()
    day_cycle = itertools.cycle(days)
    lat_ms: list[float] = []
    audit_s = 0.0
    for w in range(warm_windows + n_windows):
        day = next(day_cycle)
        for ti, t in enumerate(TENANTS):
            x, _ = campaign.sample(t, day, WINDOW)
            reqs = [ScoringRequest(intent=Intent(tenant=t), features=f,
                                   request_id=next(rid)) for f in x]
            archive()
            t0 = time.perf_counter()
            resps = rs.dispatch(reqs, stream=t)
            dt = time.perf_counter() - t0
            ta = time.perf_counter()
            loop.process(reqs, resps)
            audit_s += time.perf_counter() - ta
            ctrl.observe(t, resps[0].predictor,
                         np.asarray([r.score for r in resps]))
            ctrl.tick()
            if w >= warm_windows and ti == 0:   # measure the attacked tenant
                lat_ms.append(dt * 1e3)
        if w == 0:
            fleet.refresh_fleet()
    final = ledger.record_replicas(rs)

    launches = ops.LAUNCHES["score_pipeline_banked"]
    t0 = time.perf_counter()
    verdict = audit.verify(ledger, expected_head=audit.head(),
                           expected_length=len(audit), fused=True)
    replay_s = time.perf_counter() - t0
    if not verdict.ok or verdict.replayed != len(audit):
        raise RuntimeError(
            f"audit replay: {verdict.replayed} of {len(audit)} replayed, "
            f"{len(verdict.failures)} failures, first "
            f"{verdict.failures[:3]}")
    lat = np.asarray(lat_ms)
    return {
        "windows": len(lat_ms),
        "p50_ms": float(np.percentile(lat, 50)),
        "p99_ms": float(np.percentile(lat, 99)),
        "us_per_event": float(lat.mean() * 1e3 / WINDOW),
        "audit_us_per_event": float(
            audit_s * 1e6 / max(len(audit), 1)),
        "audit_entries": len(audit),
        "refreshes": len(ctrl.refreshes),
        "ledger_generations": sorted(final),
        "audit_generations": sorted(ledger.generations()),
        "audit_replayed_bitwise": verdict.replayed,
        "audit_replay_launches":
            ops.LAUNCHES["score_pipeline_banked"] - launches,
        "audit_replay_us_per_entry": replay_s * 1e6 / max(len(audit), 1),
    }


def run(quick: bool = False, device: torch.device | str | None = None
        ) -> dict:
    dev = resolve_device(device)
    before = dict(ops.LAUNCHES)
    campaign = _campaign()
    n_windows = 30 if quick else 120
    warm = 4 if quick else 8
    quiet = _measure(campaign, range(0, 1), n_windows, warm, dev)
    attack = _measure(campaign, range(1, campaign.n_days), n_windows, warm,
                      dev)
    return {
        "window": WINDOW,
        "tenants": list(TENANTS),
        "quiet": quiet,
        "attack": attack,
        "p99_ms_quiet": quiet["p99_ms"],
        "p99_ms_attack": attack["p99_ms"],
        "p99_ratio_attack_vs_quiet": attack["p99_ms"] /
        max(quiet["p99_ms"], 1e-9),
        "us_per_event_attack": attack["us_per_event"],
        "audit_us_per_event": attack["audit_us_per_event"],
        "attack_refreshes": attack["refreshes"],
        **paper.stamp(dev, quick, before)}


def main(argv: list[str] | None = None) -> int:
    return cli.main(run, __doc__, argv)


if __name__ == "__main__":
    sys.exit(main())
