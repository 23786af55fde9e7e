"""End-to-end serving driver (the paper's kind: Score-as-a-Service).

Serves REAL transformer experts (the reference example's reduced
same-family configs) behind the full MUSE stack with batched requests:

  token events -> intent routing -> predictor (2-transformer ensemble,
  T^C -> A -> T^Q) -> business-ready scores,  with shadow scoring of a
  candidate 3-model ensemble that adds an MoE expert (olmoe-1b-7b),
  streaming quantile tracking, an Eq.-5 readiness gate, and a live
  calibration refresh — the full model lifecycle of Fig. 3, no client
  changes anywhere.

The experts and the server run on one torch device, the card unless
``--device`` names another; on the card every window's T^C -> A -> T^Q is
one launch of the banked kernel (``csrc/score_pipeline_banked.cu``).

  PYTHONPATH=src python -m repro_torch.examples.serve_e2e \\
      [--batches 30] [--batch 32] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.convert import model_from_numpy
from repro_torch.core.predictor import PredictorSpec
from repro_torch.core.routing import (Condition, Intent, RoutingTable,
                                      ScoringRule, ShadowRule)
from repro_torch.core.transforms import (QuantileMap, _unit_grid,
                                         fraud_reference_quantiles)
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.serving.server import MuseServer, ServerConfig
from repro_torch.serving.types import ScoringRequest
from repro_torch.serving.warmup import warm_up


def make_transformer_expert(arch: str, seed: int, seq_len: int = 32, *,
                            device: torch.device, params=None):
    """A real transformer with a risk-score head, serving on ``device``.

    Its weights are drawn from ``seed``, or are ``params``: the reference's
    ``Model(cfg).init(...)`` parameters as numpy arrays, carried over by
    ``convert.model_from_numpy``.  Features arriving from the client are
    hashed into token ids — the 'schema' of this toy deployment.  Compute
    is bfloat16 through the chunked reference attention, as the reference
    example's jitted forward runs it.
    """
    cfg = get_smoke_config(arch)
    if params is None:
        model = Model(cfg, device=device, seed=seed)
    else:
        model = model_from_numpy(cfg, params, device=device)
    vocab = cfg.vocab_size

    def score_fn(features):
        feats = np.asarray(features, np.float32)
        tokens = (np.abs(feats[..., :seq_len] * 1000).astype(np.int64)
                  % vocab)
        if tokens.shape[-1] < seq_len:
            tokens = np.pad(tokens,
                            ((0, 0), (0, seq_len - tokens.shape[-1])))
        out = model(torch.as_tensor(tokens, device=device),
                    logits_mode="last")
        return out.risk_score

    return score_fn, cfg


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=30)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    dim = 32
    ref_q = fraud_reference_quantiles(128)
    qm0 = QuantileMap(_unit_grid(128), ref_q)

    table = RoutingTable(
        scoring_rules=(
            ScoringRule(Condition(tenants=("bank1",)), "bank1-ensemble-v1"),
            ScoringRule(Condition(), "global-v1"),
        ),
        shadow_rules=(
            ShadowRule(Condition(tenants=("bank1",)), ("bank1-ensemble-v2",)),
        ),
        version="v1",
    )
    server = MuseServer(table, ServerConfig(
        refresh_alert_rate=0.05, refresh_rel_error=0.5), device=device)

    def expert(arch, seed):
        return lambda: make_transformer_expert(arch, seed,
                                               device=device)[0]

    factories = {
        "internlm2-expert": expert("internlm2-1.8b", 0),
        "qwen3-expert": expert("qwen3-8b", 1),
        "olmoe-expert": expert("olmoe-1b-7b", 2),
    }
    t0 = time.perf_counter()
    server.deploy(PredictorSpec(
        "bank1-ensemble-v1", ("internlm2-expert", "qwen3-expert"),
        betas=(0.18, 0.18), weights=(1.0, 1.0), quantile_map=qm0,
    ), factories)
    server.deploy(PredictorSpec.single("global-v1", "internlm2-expert", qm0),
                  factories)
    # candidate: adds an MoE expert — dedup provisions only the new model
    server.deploy(PredictorSpec(
        "bank1-ensemble-v2",
        ("internlm2-expert", "qwen3-expert", "olmoe-expert"),
        betas=(0.18, 0.18, 0.02), weights=(1.0, 1.0, 1.0), quantile_map=qm0,
    ), factories)
    print(f"deployed 3 predictors over {server.pool.provision_events} "
          f"physical models in {time.perf_counter() - t0:.1f}s "
          "(ensemble-v2 provisioned only the MoE expert)")

    t0 = time.perf_counter()
    # the first call of every predictor at every batch shape the tenant
    # grouping can produce, before live traffic (the paper's readiness
    # rule; here it loads the card's kernels and sizes its allocator)
    warm_up(server, dim, batch_sizes=(1, args.batch // 4, args.batch // 2,
                                      args.batch))
    print(f"warm-up (first call of every predictor at serving shapes): "
          f"{time.perf_counter() - t0:.1f}s")

    rng = np.random.default_rng(0)
    tenants = ["bank1", "bank1", "bank2", "fintechX"]
    lat = []
    t0 = time.perf_counter()
    for _ in range(args.batches):
        reqs = [
            ScoringRequest(
                intent=Intent(tenant=tenants[j % len(tenants)]),
                features=rng.normal(0, 1, dim).astype(np.float32),
            )
            for j in range(args.batch)
        ]
        t1 = time.perf_counter()
        resps = server.score_batch(reqs)
        lat.append((time.perf_counter() - t1) * 1e3)
        if not all(0.0 <= r.score <= 1.0 for r in resps):
            raise RuntimeError("a served score left [0, 1]")
    total = args.batches * args.batch
    dt = time.perf_counter() - t0
    print(f"served {total} events in {dt:.2f}s "
          f"({total / dt:.0f} events/s); latency "
          f"p50={np.percentile(lat, 50):.1f}ms "
          f"p99={np.percentile(lat, 99):.1f}ms per batch of {args.batch}")
    print(f"shadow evaluations recorded: {len(server.sink)} "
          f"(candidate ensemble scored on live bank1 traffic)")

    # calibration refresh once the Eq.-5 gate opens
    ready = server.calibration_ready("bank1", "bank1-ensemble-v1")
    print(f"calibration refresh gate (Eq. 5) open: {ready}")
    if ready:
        qm1 = server.fit_custom_quantile_map("bank1", "bank1-ensemble-v1",
                                             ref_q.numpy())
        server.swap_transformation("bank1-ensemble-v1", qm1)
        r = server.score(ScoringRequest(
            intent=Intent(tenant="bank1"),
            features=rng.normal(0, 1, dim).astype(np.float32)))
        print(f"after live T^Q refresh: score={r.score:.4f} "
              f"via {r.predictor}")

    # promote the shadow candidate — pure routing change
    server.publish_routing(server.routing.with_rule_update(
        "bank1-ensemble-v1", "bank1-ensemble-v2", "v2"))
    r = server.score(ScoringRequest(
        intent=Intent(tenant="bank1"),
        features=rng.normal(0, 1, dim).astype(np.float32)))
    print(f"after promotion: bank1 served by {r.predictor} "
          f"(routing {r.routing_version}) — client unchanged")


if __name__ == "__main__":
    main()
