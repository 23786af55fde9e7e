"""Quickstart: the MUSE core in five minutes.

Builds two tiny expert models, composes the paper's Eq.-2 predictor
(posterior correction -> aggregation -> quantile mapping), routes an intent
to it, and performs a zero-downtime transformation swap.  The server scores
on one torch device, through the banked kernel on the card: the card
unless ``--device`` names another.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import (Intent, PredictorSpec, QuantileMap,
                              RoutingTable)
from repro_torch.core.routing import Condition, ScoringRule, ShadowRule
from repro_torch.core.transforms import (fraud_reference_quantiles,
                                         uniform_reference_quantiles)
from repro_torch.device import resolve_device
from repro_torch.serving.server import MuseServer
from repro_torch.serving.types import ScoringRequest

DIM = 8


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    device = resolve_device(parser.parse_args(argv).device)
    rng = np.random.default_rng(0)

    # -- 1. two "expert models" (stand-ins for anything that scores) -------
    w1, w2 = rng.normal(0, 1, DIM), rng.normal(0, 1, DIM)

    def expert(w):
        return lambda x: torch.as_tensor(
            1 / (1 + np.exp(-(np.asarray(x) @ w))), dtype=torch.float32,
            device=device)

    # -- 2. routing: clients send intents, never model names ---------------
    table = RoutingTable(
        scoring_rules=(
            ScoringRule(Condition(tenants=("bank1",)), "bank1-predictor-v1",
                        description="Custom DAG for bank1"),
            ScoringRule(Condition(), "global-predictor",
                        description="catch-all"),
        ),
        shadow_rules=(
            ShadowRule(Condition(tenants=("bank1",)), ("bank1-predictor-v2",),
                       description="evaluate v2 in shadow"),
        ),
        version="v1",
    )
    server = MuseServer(table, device=device)

    # -- 3. predictors: ensemble with per-expert posterior correction ------
    grid = uniform_reference_quantiles(128)
    ref_q = fraud_reference_quantiles(128)          # the stable reference R
    qm = QuantileMap(grid, ref_q)
    factories = {"m1": lambda: expert(w1), "m2": lambda: expert(w2)}

    server.deploy(PredictorSpec(
        "bank1-predictor-v1", ("m1", "m2"),
        betas=(0.18, 0.02),      # each expert's training undersampling ratio
        weights=(1.0, 1.0), quantile_map=qm,
    ), factories)
    server.deploy(PredictorSpec.single("global-predictor", "m1", qm),
                  factories)
    server.deploy(PredictorSpec(
        "bank1-predictor-v2", ("m1", "m2"), (0.18, 0.02), (1.0, 3.0), qm,
    ), factories)
    print(f"models provisioned: {server.pool.provision_events} "
          "(3 predictors share 2 physical models)")

    # -- 4. score: live + shadow -------------------------------------------
    req = ScoringRequest(intent=Intent(tenant="bank1"),
                         features=rng.normal(0, 1, DIM).astype(np.float32))
    resp = server.score(req)
    print(f"live score via {resp.predictor}: {resp.score:.4f} "
          f"(raw expert scores: {[round(s, 3) for s in resp.raw_scores]})")
    print(f"shadow records written: {len(server.sink)}")

    # -- 5. seamless update: swap T^Q without touching models --------------
    server.swap_transformation("bank1-predictor-v1",
                               QuantileMap(grid, grid ** 2))
    resp2 = server.score(req)
    print(f"after T^Q swap (no model re-provisioning): {resp2.score:.4f}")

    # -- 6. transparent model switching: one routing-table update ----------
    server.publish_routing(table.with_rule_update(
        "bank1-predictor-v1", "bank1-predictor-v2", version="v2"))
    resp3 = server.score(req)
    print(f"after promotion, same intent now served by {resp3.predictor} "
          f"(routing {resp3.routing_version}): {resp3.score:.4f}")


if __name__ == "__main__":
    main()
