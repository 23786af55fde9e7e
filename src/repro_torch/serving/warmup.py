"""Replica warm-up (paper Sec. 3.1.2).

The paper's Java replicas suffer JIT-compilation latency on first requests;
MUSE exercises the real code path with synthetic traffic before marking the
pod ready.  The JAX analogue is exact: the first call through a predictor
triggers XLA compilation (tens-to-hundreds of ms), so a cold replica would
blow the latency SLO on live traffic.  ``warm_up`` pushes synthetic batches
through every predictor the routing table can reach, forcing compilation of
every (predictor, batch-shape) executable before readiness.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core.routing import Intent
from repro_torch.serving.types import ScoringRequest


def synthetic_requests(schema_dim: int, batch: int, tenant: str = "__warmup__",
                       seed: int = 0) -> list[ScoringRequest]:
    rng = np.random.default_rng(seed)
    return [
        ScoringRequest(
            intent=Intent(tenant=tenant),
            features=rng.normal(0, 1, schema_dim).astype(np.float32),
        )
        for _ in range(batch)
    ]


def warm_up(server, schema_dim: int, *, batch_sizes: tuple[int, ...] = (1, 8, 64),
            calls_per_shape: int = 2) -> dict[str, float]:
    """Exercise every deployed predictor at every serving batch shape.

    Returns {predictor: seconds_spent} — the Fig.-5 warm-up spike data.
    Bypasses routing (calls predictors directly) so catch-all rules do not
    hide predictors from the warm-up pass.
    """
    timings: dict[str, float] = {}
    for name, pred in server.predictors.items():
        t0 = time.perf_counter()
        for bs in batch_sizes:
            feats = np.random.default_rng(0).normal(0, 1, (bs, schema_dim)).astype(
                np.float32
            )
            for _ in range(calls_per_shape):
                pred(feats)
        timings[name] = time.perf_counter() - t0
    return timings
