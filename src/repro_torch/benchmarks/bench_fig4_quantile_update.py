"""Fig. 4: the quantile-transformation update of a cold-start client.

The port's counterpart of the reference's
``benchmarks/bench_fig4_quantile_update.py`` at its sizes and seeds.  Three
predictors over the same 8-model ensemble (``FraudWorld.build(seed=2)``),
evaluated on 400,000 live client events (120,000 with ``--quick``) against
the reference distribution, per score bin:

  * raw — no T^Q (scores collapse near 0);
  * v0  — the cold-start T^Q_v0 (Beta-mixture prior on training scores);
  * v1  — a T^Q_v1 fitted on the first half of the live traffic, scored on
          the second half.

Each T^Q runs on the device through ``kernels/ops.py::quantile_map``: the
hand-written kernel (``csrc/quantile_map.cu``) on the card, the plain
version on the CPU; ``tq_vs_plain`` holds each launch against the plain
version on the same tensors (:func:`repro_torch.benchmarks.paper.
apply_quantile_map`).

:func:`run_refresh` times the fleet-wide refresh: a ``CalibrationController``
refits every ready (tenant, predictor) stream of a server with 4 / 16 / 64
/ 128 tenants (4 / 16 / 64 with ``--quick``) and publishes one bank
generation.  The servers score on the device, through the banked kernel.
The command line runs both, as the reference's ``main`` does.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_fig4_quantile_update \\
        [--quick] [--device cpu] [--out PATH]
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from repro_torch.benchmarks import cli, paper
from repro_torch.core.metrics import bin_relative_error
from repro_torch.core.predictor import PredictorSpec
from repro_torch.core.quantiles import StreamingQuantileEstimator
from repro_torch.core.routing import Condition, Intent, RoutingTable, ScoringRule
from repro_torch.core.transforms import QuantileMap, fraud_reference_quantiles
from repro_torch.device import resolve_device
from repro_torch.experiments.fraud_world import FraudWorld
from repro_torch.kernels import ops
from repro_torch.serving import (CalibrationController, MuseServer,
                                 RefreshPolicy, ServerConfig)
from repro_torch.serving.types import ScoringRequest

ENSEMBLE = tuple(f"m{i+1}" for i in range(8))


def _fleet_server(n_tenants: int, n_samples: int, rng: np.random.Generator,
                  dev: torch.device):
    """A server with one predictor per tenant (shared 2-model group), a
    warm T-row transform bank, and injected per-tenant live streams."""
    dim = 8
    weights = [rng.normal(0, 1, dim).astype(np.float32) for _ in range(2)]

    def _model(w):
        # the reference's host logistic, its float32 scores on the device
        return lambda x: torch.as_tensor(
            1.0 / (1.0 + np.exp(-(np.asarray(x, np.float32) @ w))),
            device=dev)

    rules = tuple(ScoringRule(Condition(tenants=(f"t{i}",)), f"p{i}")
                  for i in range(n_tenants))
    server = MuseServer(RoutingTable(rules, version="v1"),
                        ServerConfig(track_quantiles=False), device=dev)
    factories = {"m1": lambda: _model(weights[0]),
                 "m2": lambda: _model(weights[1])}
    for i in range(n_tenants):
        server.deploy(PredictorSpec(f"p{i}", ("m1", "m2"), (0.2, 0.3),
                                    (1.0, 1.0), QuantileMap.identity(256)),
                      factories)
    # one mixed batch spanning every tenant warms the T-row bank
    server.score_batch([
        ScoringRequest(intent=Intent(tenant=f"t{i}"),
                       features=rng.normal(0, 1, dim).astype(np.float32))
        for i in range(n_tenants)
    ])
    # per-tenant live streams: shifted Beta draws (distinct distributions)
    for i in range(n_tenants):
        est = StreamingQuantileEstimator(capacity=131072, seed=i)
        est.update(rng.beta(0.6 + 0.02 * (i % 8), 6.0 + 0.5 * (i % 5),
                            n_samples))
        server._estimators[(f"t{i}", f"p{i}")] = est
    return server


def run_refresh(quick: bool = False,
                device: torch.device | str | None = None) -> dict:
    """refresh_fleet() wall time vs tenant count (refit + validate + publish)."""
    dev = resolve_device(device)
    before = dict(ops.LAUNCHES)
    tenant_counts = (4, 16, 64) if quick else (4, 16, 64, 128)
    # Eq.-5 gate: a=1%, delta=50% (quick) needs ~1.5k samples, delta=20%
    # needs ~9.5k — streams are injected just past the gate.
    rel_error = 0.5 if quick else 0.2
    n_samples = 2_000 if quick else 10_000
    ref = fraud_reference_quantiles(256).numpy()
    rows = []
    for t in tenant_counts:
        rng = np.random.default_rng(t)
        server = _fleet_server(t, n_samples, rng, dev)
        ctrl = CalibrationController(
            server, ref, RefreshPolicy(alert_rate=0.01, rel_error=rel_error))
        t0 = time.perf_counter()
        res = ctrl.refresh_fleet()
        wall_ms = (time.perf_counter() - t0) * 1000.0
        if len(res.refreshed) != t:
            raise RuntimeError(
                f"expected {t} refreshed streams, got {len(res.refreshed)} "
                f"(rejected: {[r.reasons for r in res.rejected]})")
        if not server.bank_generation == res.generation > 0:
            raise RuntimeError(f"bank generation {server.bank_generation}, "
                               f"refresh generation {res.generation}")
        rows.append({
            "tenants": t,
            "samples_per_stream": n_samples,
            "wall_ms": wall_ms,
            "refit_ms": res.refit_seconds * 1000.0,
            "validate_ms": res.validate_seconds * 1000.0,
            "publish_ms": res.publish_seconds * 1000.0,
            "us_per_tenant": wall_ms * 1000.0 / t,
            "generation": res.generation,
        })
    largest = rows[-1]
    return {
        "rows": rows,
        "max_tenants": largest["tenants"],
        "wall_ms_at_max": largest["wall_ms"],
        "us_per_tenant_at_max": largest["us_per_tenant"],
        **paper.stamp(dev, quick, before)}


def run(quick: bool = False, device: torch.device | str | None = None
        ) -> dict:
    dev = resolve_device(device)
    before = dict(ops.LAUNCHES)
    n_live = 120_000 if quick else 400_000
    world = FraudWorld.build(
        n_experts=8, betas=(0.18, 0.18, 0.02, 0.1, 0.18, 0.05, 0.18, 0.02),
        client_shift=0.4, seed=2,
    )

    # live client traffic (the 15-day onboarding window)
    x_live, _ = world.client.sample(n_live)
    agg_live = world.ensemble_aggregated(ENSEMBLE, x_live)

    # --- predictor raw: no T^Q
    res_raw = bin_relative_error(agg_live, world.ref_quantiles, n_bins=10)

    # --- predictor v0: cold-start default transformation (training prior)
    qm_v0 = world.coldstart_quantile_map(ENSEMBLE, n_trials=2)
    scores_v0, check_v0 = paper.apply_quantile_map(qm_v0, agg_live, dev)
    res_v0 = bin_relative_error(scores_v0, world.ref_quantiles, n_bins=10)

    # --- predictor v1: custom transformation fit on the first half of live
    # traffic, evaluated on the second half (the paper's week-before /
    # week-after protocol)
    half = n_live // 2
    qm_v1 = world.custom_quantile_map(ENSEMBLE, x_live[:half])
    scores_v1, check_v1 = paper.apply_quantile_map(qm_v1, agg_live[half:],
                                                   dev)
    res_v1 = bin_relative_error(scores_v1, world.ref_quantiles, n_bins=10)

    def _errs(res):
        return [None if np.isnan(v) else float(v) for v in res["rel_err"]]

    # paper-claim scalars
    return {
        "bins": [f"[{i/10:.1f},{(i+1)/10:.1f})" for i in range(10)],
        "raw": _errs(res_raw),
        "v0": _errs(res_v0),
        "v1": _errs(res_v1),
        "raw_mass_in_first_bin": float(res_raw["observed"][0]),
        "v0_max_abs_rel_err_high_bins": float(
            np.nanmax(np.abs(res_v0["rel_err"][5:]))),
        "v1_max_abs_rel_err_mid_bins": float(
            np.nanmax(np.abs(res_v1["rel_err"][5:8]))),
        "tq_vs_plain": {"v0": check_v0, "v1": check_v1},
        **paper.stamp(dev, quick, before)}


def _with_refresh(quick: bool = False,
                  device: torch.device | str | None = None) -> dict:
    """The figure and the fleet refresh, as the reference's ``main``."""
    return {**run(quick, device), "refresh": run_refresh(quick, device)}


def main(argv: list[str] | None = None) -> int:
    return cli.main(_with_refresh, __doc__, argv)


if __name__ == "__main__":
    sys.exit(main())
