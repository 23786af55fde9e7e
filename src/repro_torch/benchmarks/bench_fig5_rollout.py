"""Fig. 5: operational stability during a rolling transformation update
(T^Q_v0 -> T^Q_v1).

The port's counterpart of the reference's
``benchmarks/bench_fig5_rollout.py`` at its sizes and seeds
(``FraudWorld.build(seed=4)``): the Kubernetes-style rolling update over 3
replicas, each warmed up at batch 16 before it turns ready, while windows
of 16 live requests keep flowing (4 a transition with ``--quick``, else
8).  Every replica is a ``MuseServer`` on the device, so each window runs
the banked kernel (``csrc/score_pipeline_banked.cu``) on the card.  It
reports the pod-count timeline and latency percentiles (host wall time of
a window), and the invariants the reference's ``main`` checks: the pod
count surges by one and returns to its baseline, no fewer replicas than
the baseline are ever ready, and the fleet ends on v1.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_fig5_rollout \\
        [--quick] [--device cpu] [--out PATH]
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from repro_torch.benchmarks import cli, paper
from repro_torch.core.routing import Condition, Intent, RoutingTable, ScoringRule
from repro_torch.core.transforms import QuantileMap
from repro_torch.device import resolve_device
from repro_torch.experiments.fraud_world import DIM, FraudWorld
from repro_torch.kernels import ops
from repro_torch.serving.rollout import Replica, ReplicaSet, RollingUpdate
from repro_torch.serving.server import MuseServer
from repro_torch.serving.types import ScoringRequest
from repro_torch.serving.warmup import warm_up

ENSEMBLE = ("m1", "m2", "m3")


def _make_server(world: FraudWorld, qm: QuantileMap, version: str,
                 dev: torch.device) -> MuseServer:
    table = RoutingTable(
        (ScoringRule(Condition(), "bank1-predictor"),), version=version
    )
    server = MuseServer(table, device=dev)
    spec = world.predictor_spec("bank1-predictor", ENSEMBLE, qm)
    server.deploy(spec, world.model_factories(dev))
    return server


def invariants_hold(res: dict) -> bool:
    """The reference's rolling-update invariants: surge of one,
    maxUnavailable of zero, full promotion."""
    return (res["pod_peak"] == res["pod_baseline"] + 1
            and res["pod_final"] == res["pod_baseline"]
            and res["min_ready"] >= res["pod_baseline"]
            and res["final_version"] == "v1")


def run(quick: bool = False, device: torch.device | str | None = None
        ) -> dict:
    dev = resolve_device(device)
    before = dict(ops.LAUNCHES)
    world = FraudWorld.build(seed=4)
    x_fit, _ = world.client.sample(50_000)
    qm_v0 = world.coldstart_quantile_map(ENSEMBLE, n_trials=1)
    qm_v1 = world.custom_quantile_map(ENSEMBLE, x_fit)

    n_replicas = 3
    replicas = []
    for i in range(n_replicas):
        srv = _make_server(world, qm_v0, "v0", dev)
        warm_up(srv, DIM, batch_sizes=(16,))
        replicas.append(Replica(i, srv, "v0", ready=True))
    rs = ReplicaSet(replicas)

    update = RollingUpdate(
        rs, lambda: _make_server(world, qm_v1, "v1", dev), "v1",
        schema_dim=DIM, warmup_batch_sizes=(16,),
    )

    rng = np.random.default_rng(0)

    def traffic():
        while True:
            feats = rng.normal(0, 1, (16, DIM)).astype(np.float32)
            yield [ScoringRequest(intent=Intent(tenant="bank1"), features=f)
                   for f in feats]

    batches = 4 if quick else 8
    timeline = update.run_with_traffic(traffic(), batches_per_transition=batches)

    lats = np.array([t["latency_ms"] for t in timeline])
    pods = [t["pod_count"] for t in timeline]
    warmups = [r.warmup_seconds for r in rs.replicas]
    result = {
        "samples": len(timeline),
        "pod_baseline": n_replicas,
        "pod_peak": max(pods),
        "pod_final": pods[-1],
        "latency_p50_ms": float(np.percentile(lats, 50)),
        "latency_p99_ms": float(np.percentile(lats, 99)),
        "latency_max_ms": float(lats.max()),
        "min_ready": min(t["ready_count"] for t in timeline),
        "final_version": timeline[-1]["version"],
        "warmup_seconds_per_replica": [round(w, 3) for w in warmups],
        "versions_seen": sorted({t["version"] for t in timeline}),
    }
    result["invariants_ok"] = invariants_hold(result)
    return {**result, **paper.stamp(dev, quick, before)}


def main(argv: list[str] | None = None) -> int:
    return cli.main(run, __doc__, argv, ok=invariants_hold)


if __name__ == "__main__":
    sys.exit(main())
