"""Fleet calibration plane: merged fit and fenced broadcast against fleet
size.

The port's counterpart of the reference's
``benchmarks/bench_fleet_refresh.py`` at its sizes and seed: 8 tenants (4
with ``--quick``), 2 / 4 / 8 / 16 replicas (2 / 4 / 8), four times the
Eq.-5 gate (a = 5%, delta = 50%) of events a stream split over the
replicas' estimators (capacity 8,192).  One ``FleetCalibrationController``
pass pulls every replica's estimator checkpoint, merges them per (tenant,
predictor), refits and validates once over the merged view, and
broadcasts the tables under one fenced fleet generation, which each
replica publishes into its banked transform store on the device.  Wall
time splits into merge, refit, validate and publish; the accuracy proxy is
the published tables' worst rank error against the concatenated stream,
beside ``merge_rank_error_bound``.  After each pass, untimed, every
replica serves one request a tenant through the banked kernel
(``csrc/score_pipeline_banked.cu`` on the card), and each response must
carry the new fleet generation (the run raises otherwise).

It writes nothing unless ``--out`` names a file.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_fleet_refresh \\
        [--quick] [--device cpu] [--out PATH]
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from repro_torch.benchmarks import cli, paper
from repro_torch.core.predictor import PredictorSpec
from repro_torch.core.quantiles import (StreamingQuantileEstimator,
                                        merge_rank_error_bound,
                                        required_sample_size)
from repro_torch.core.routing import (Condition, Intent, RoutingTable,
                                      ScoringRule)
from repro_torch.core.transforms import QuantileMap
from repro_torch.device import resolve_device, to_numpy
from repro_torch.kernels import ops
from repro_torch.serving import (FleetCalibrationController, MuseServer,
                                 RefreshPolicy, Replica, ReplicaSet,
                                 ServerConfig)
from repro_torch.serving.types import ScoringRequest

DIM = 16
CAP = 8192


def _model(seed: int, dev: torch.device):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 1, DIM).astype(np.float32)

    def score(x):
        # the reference's host logistic, its float32 scores on the device
        x = np.asarray(x, np.float32)
        return torch.as_tensor(1.0 / (1.0 + np.exp(-(x @ w))), device=dev)

    return score


def _server(n_tenants: int, dev: torch.device) -> MuseServer:
    factories = {"m1": lambda: _model(1, dev), "m2": lambda: _model(2, dev)}
    rules = tuple(ScoringRule(Condition(tenants=(f"t{i}",)), f"p{i}")
                  for i in range(n_tenants))
    server = MuseServer(RoutingTable(rules, version="v1"),
                        ServerConfig(refresh_alert_rate=0.05,
                                     refresh_rel_error=0.5), device=dev)
    for i in range(n_tenants):
        server.deploy(PredictorSpec(f"p{i}", ("m1", "m2"), (0.2, 0.4),
                                    (1.0, 1.0), QuantileMap.identity(64)),
                      factories)
    return server


def run(quick: bool = False, device: torch.device | str | None = None
        ) -> dict:
    dev = resolve_device(device)
    before = dict(ops.LAUNCHES)
    n_tenants = 4 if quick else 8
    replica_counts = (2, 4, 8) if quick else (2, 4, 8, 16)
    gate = required_sample_size(0.05, 0.5)
    per_stream = 4 * gate                     # fleet-total events per stream
    policy = RefreshPolicy(alert_rate=0.05, rel_error=0.5, n_levels=64)
    ref = np.linspace(0.0, 1.0, 64) ** 2
    rng = np.random.default_rng(0)
    streams = {i: rng.normal(0.5, 0.15, per_stream).clip(0, 1)
               for i in range(n_tenants)}

    rows: list[dict] = []
    for n_replicas in replica_counts:
        reps = [Replica(r, _server(n_tenants, dev), "v1", ready=True)
                for r in range(n_replicas)]
        per_rep = per_stream // n_replicas
        for r, rep in enumerate(reps):
            for i, data in streams.items():
                est = StreamingQuantileEstimator(
                    capacity=CAP, seed=31 * r + i, recent_capacity=256)
                est.update(data[r * per_rep:(r + 1) * per_rep])
                rep.server._estimators[(f"t{i}", f"p{i}")] = est
        fleet = FleetCalibrationController(ReplicaSet(reps), ref, policy)

        t0 = time.perf_counter()
        res = fleet.refresh_fleet()
        wall_s = time.perf_counter() - t0
        if len(res.refreshed) != n_tenants:
            raise RuntimeError(f"{len(res.refreshed)} of {n_tenants} streams "
                               f"refreshed: {[r.reasons for r in res.reports]}")
        if len(res.acked) != n_replicas or res.nacked:
            raise RuntimeError(f"{len(res.acked)} of {n_replicas} replicas "
                               f"acked, nacked {res.nacked}")

        # the broadcast reached every replica's data plane: one request a
        # tenant through each replica is served under the fleet generation
        # (untimed; the reference's servers serve nothing here)
        probe = [ScoringRequest(intent=Intent(tenant=f"t{i}"),
                                features=np.full(DIM, 0.1, np.float32))
                 for i in range(n_tenants)]
        for rep in reps:
            gens = {r.bank_generation for r in rep.server.score_batch(probe)}
            if gens != {res.fleet_generation}:
                raise RuntimeError(f"replica {rep.replica_id} served "
                                   f"generations {gens}, fleet "
                                   f"{res.fleet_generation}")

        # accuracy proxy: worst published-table rank error vs ground truth
        worst = 0.0
        for i, data in streams.items():
            q = to_numpy(reps[0].server.predictors[f"p{i}"]
                         .pipeline.src_quantiles)
            levels = np.linspace(0.0, 1.0, len(q))
            ranks = np.searchsorted(np.sort(data), q,
                                    side="right") / len(data)
            worst = max(worst, float(
                np.max(np.abs(ranks - levels)[2:-2])))
        rows.append({
            "replicas": n_replicas,
            "streams": n_tenants,
            "events_per_stream": per_stream,
            "wall_ms": wall_s * 1e3,
            "merge_ms": res.merge_seconds * 1e3,
            "refit_ms": res.refit_seconds * 1e3,
            "validate_ms": res.validate_seconds * 1e3,
            "publish_ms": res.publish_seconds * 1e3,
            "publish_ms_per_replica": res.publish_seconds * 1e3 / n_replicas,
            "fleet_generation": res.fleet_generation,
            "worst_rank_error": worst,
            "rank_error_bound": merge_rank_error_bound(CAP, CAP),
        })

    first, last = rows[0], rows[-1]
    return {
        "tenants": n_tenants,
        "replica_counts": list(replica_counts),
        "estimator_capacity": CAP,
        "rows": rows,
        "max_replicas": last["replicas"],
        "wall_ms_at_max": last["wall_ms"],
        "merge_ms_at_max": last["merge_ms"],
        "publish_ms_at_max": last["publish_ms"],
        # fit cost must be ~flat in fleet size (it runs on the MERGED view)
        "refit_ratio_max_vs_min": last["refit_ms"] / max(first["refit_ms"],
                                                         1e-9),
        "all_within_bound": all(r["worst_rank_error"]
                                <= max(r["rank_error_bound"], 0.02)
                                for r in rows),
        **paper.stamp(dev, quick, before)}


def main(argv: list[str] | None = None) -> int:
    return cli.main(run, __doc__, argv,
                    ok=lambda result: result["all_within_bound"])


if __name__ == "__main__":
    sys.exit(main())
