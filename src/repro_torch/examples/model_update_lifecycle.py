"""The full Fig.-3 model lifecycle, end to end:

  train experts -> deploy {m1,m2} live -> deploy {m1,m2,m3} in SHADOW ->
  validate on live traffic (distribution alignment + discriminative power)
  -> refresh T^Q for the candidate -> rolling promotion -> decommission.

Everything happens server-side; the "client" sends the same intent from the
first request to the last.  The servers, experts and transforms run on one
torch device: the card unless ``--device`` names another.

  PYTHONPATH=src python -m repro_torch.examples.model_update_lifecycle \
      [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.metrics import bin_relative_error, recall_at_fpr
from repro_torch.core.routing import (Condition, Intent, RoutingTable,
                                      ScoringRule, ShadowRule)
from repro_torch.core.transforms import QuantileMap
from repro_torch.device import resolve_device, to_numpy
from repro_torch.experiments.fraud_world import DIM, FraudWorld, train_expert
from repro_torch.serving.rollout import Replica, ReplicaSet, RollingUpdate
from repro_torch.serving.server import MuseServer
from repro_torch.serving.types import ScoringRequest
from repro_torch.training.data import FraudEventStream, TenantProfile

OLD, NEW = ("m1", "m2"), ("m1", "m2", "m3")


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    device = resolve_device(parser.parse_args(argv).device)

    world = FraudWorld.build(n_experts=2, betas=(0.18, 0.18), seed=11)
    world.client = FraudEventStream(
        TenantProfile("train-pool", fraud_rate=0.008, feature_shift=0.3,
                      seed=77))
    world.experts["m3"] = train_expert(
        FraudEventStream(TenantProfile("train-pool", fraud_rate=0.01,
                                       feature_shift=0.3, seed=78)),
        "m3", beta=0.02, mask_seed=5)
    factories = world.model_factories(device)

    # ---- 1. live {m1,m2} + shadow {m1,m2,m3} -----------------------------
    x_hist, _ = world.client.sample(60_000)
    qm_v1 = world.custom_quantile_map(OLD, x_hist)
    table = RoutingTable(
        (ScoringRule(Condition(tenants=("bank1",)), "p1"),
         ScoringRule(Condition(), "p1")),
        (ShadowRule(Condition(tenants=("bank1",)), ("p2-candidate",)),),
        version="v1",
    )
    server = MuseServer(table, device=device)
    server.deploy(world.predictor_spec("p1", OLD, qm_v1), factories)
    server.deploy(world.predictor_spec("p2-candidate", NEW, qm_v1), factories)
    print(f"[deploy] 2 predictors, {server.pool.provision_events} models "
          "provisioned (m1,m2 shared; only m3 new)")

    # ---- 2. live traffic; shadow records accumulate -----------------------
    x_live, y_live = world.client.sample(40_000)
    for i in range(0, len(x_live), 512):
        reqs = [ScoringRequest(intent=Intent(tenant="bank1"), features=f)
                for f in x_live[i: i + 512].astype(np.float32)]
        server.score_batch(reqs)
    print(f"[shadow] {len(server.sink)} candidate evaluations recorded")

    # ---- 3. offline validation from the data lake -------------------------
    def on_device(qm: QuantileMap) -> QuantileMap:
        return QuantileMap(qm.src_quantiles.to(device),
                           qm.ref_quantiles.to(device))

    def mapped(qm: QuantileMap, names: tuple[str, ...]) -> np.ndarray:
        agg = torch.as_tensor(world.ensemble_aggregated(names, x_live),
                              dtype=torch.float32, device=device)
        return to_numpy(on_device(qm)(agg))

    qm_v2 = world.custom_quantile_map(NEW, x_live)  # refreshed transformation
    cand_scores = mapped(qm_v2, NEW)
    live_scores = mapped(qm_v1, OLD)
    err_cand = bin_relative_error(cand_scores, world.ref_quantiles)["rel_err"]
    r_old = recall_at_fpr(live_scores, y_live, 0.01)
    r_new = recall_at_fpr(cand_scores, y_live, 0.01)
    print(f"[validate] candidate max |bin err| = "
          f"{np.nanmax(np.abs(err_cand)):.2%}; recall@1%FPR "
          f"{r_old:.3f} -> {r_new:.3f}")

    # ---- 4. rolling promotion (surge 1, maxUnavailable 0) -----------------
    def make_v2_server():
        s = MuseServer(RoutingTable(
            (ScoringRule(Condition(), "p2"),), version="v2"), device=device)
        s.deploy(world.predictor_spec("p2", NEW, qm_v2), factories)
        return s

    replicas = [Replica(i, server, "v1", ready=True) for i in range(2)]
    rs = ReplicaSet(replicas)
    update = RollingUpdate(rs, make_v2_server, "v2", schema_dim=DIM,
                           warmup_batch_sizes=(16,))

    def traffic():
        rng = np.random.default_rng(1)
        while True:
            yield [ScoringRequest(intent=Intent(tenant="bank1"),
                                  features=rng.normal(0, 1, DIM).astype(
                                      np.float32))
                   for _ in range(16)]

    timeline = update.run_with_traffic(traffic(), batches_per_transition=3)
    print(f"[rollout] pods {min(t['pod_count'] for t in timeline)}->"
          f"{max(t['pod_count'] for t in timeline)}->"
          f"{timeline[-1]['pod_count']}, "
          f"min ready={min(t['ready_count'] for t in timeline)}, "
          f"final version={timeline[-1]['version']}")
    print("[done] client intent never changed; v1 decommissioned")


if __name__ == "__main__":
    main()
