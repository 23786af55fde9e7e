"""Fig. 6: the live model update {m1,m2} -> {m1,m2,m3}.

The port's counterpart of the reference's
``benchmarks/bench_fig6_model_update.py`` at its sizes and seeds
(``FraudWorld.build(seed=3)``, 400,000 events a period, 120,000 with
``--quick``):

  p1   — the old ensemble {m1,m2} with its custom T^Q_v1 (aligned);
  p1.5 — the new ensemble {m1,m2,m3} with the OLD T^Q_v1 (the transform
         not refreshed: misaligned, under-alerting);
  p2   — the new ensemble with a refreshed T^Q_v2 (aligned again).

It checks the paper's Sec.-3.2 claims (recall@1%FPR equal for p1.5 and p2,
since T^Q is monotone; p2 >= p1) and the control plane's view: PSI drift
and the realized alert rate at the client's fixed threshold.  The three
T^Q applications run on the device through ``kernels/ops.py::
quantile_map`` (the hand-written kernel on the card), each held against
the plain version on the same tensors (``tq_vs_plain``).

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_fig6_model_update \\
        [--quick] [--device cpu] [--out PATH]
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from repro_torch.benchmarks import cli, paper
from repro_torch.core.metrics import bin_relative_error, recall_at_fpr
from repro_torch.device import resolve_device
from repro_torch.experiments.fraud_world import FraudWorld, train_expert
from repro_torch.kernels import ops
from repro_torch.serving.drift import (realized_alert_rate,
                                       transformed_stream_psi)
from repro_torch.training.data import FraudEventStream, TenantProfile


def run(quick: bool = False, device: torch.device | str | None = None
        ) -> dict:
    dev = resolve_device(device)
    before = dict(ops.LAUNCHES)
    n_live = 120_000 if quick else 400_000
    world = FraudWorld.build(n_experts=2, betas=(0.18, 0.18),
                             client_shift=0.3, seed=3)
    # This client sees the SAME fraud pattern family as the training pool
    # (same generative direction) with a moderate covariate shift, so the
    # legacy experts retain most of their signal — the paper's setting where
    # the update brings an incremental (+1.1pp) recall gain.
    world.client = FraudEventStream(
        TenantProfile("train-pool", fraud_rate=0.008, feature_shift=0.35,
                      seed=9000)
    )
    # m3: new expert trained on the client's current distribution at
    # aggressive undersampling (beta = 2%) — the paper's new fraud pattern
    # specialist.
    recent = FraudEventStream(
        TenantProfile("train-pool", fraud_rate=0.01, feature_shift=0.35,
                      seed=303)
    )
    world.experts["m3"] = train_expert(recent, "m3", 0.02, mask_seed=33)

    old, new = ("m1", "m2"), ("m1", "m2", "m3")

    x_pre, y_pre = world.client.sample(n_live)     # pre-deployment period
    x_post, y_post = world.client.sample(n_live)   # post-deployment period

    # p1: old ensemble + its custom transformation (fit pre-deployment)
    qm_v1 = world.custom_quantile_map(old, x_pre)
    agg_old_pre = world.ensemble_aggregated(old, x_pre)
    p1_scores, check_p1 = paper.apply_quantile_map(qm_v1, agg_old_pre, dev)
    res_p1 = bin_relative_error(p1_scores, world.ref_quantiles, n_bins=10)

    # p1.5: NEW ensemble + OLD transformation, post-deployment
    agg_new_post = world.ensemble_aggregated(new, x_post)
    p15_scores, check_p15 = paper.apply_quantile_map(qm_v1, agg_new_post,
                                                     dev)
    res_p15 = bin_relative_error(p15_scores, world.ref_quantiles, n_bins=10)

    # p2: NEW ensemble + refreshed transformation (fit on recent data)
    qm_v2 = world.custom_quantile_map(new, x_post)
    p2_scores, check_p2 = paper.apply_quantile_map(qm_v2, agg_new_post, dev)
    res_p2 = bin_relative_error(p2_scores, world.ref_quantiles, n_bins=10)

    # Sec.-3.2 claims
    r_p1 = recall_at_fpr(p1_scores, y_pre, 0.01)
    r_p15 = recall_at_fpr(p15_scores, y_post, 0.01)
    r_p2 = recall_at_fpr(p2_scores, y_post, 0.01)

    # The control-plane validation view (serving/calibration.py step 4):
    # PSI drift + realized alert rate at the fixed client threshold tau.
    # p1.5 (stale T^Q across the model update) drifts and shifts the alert
    # rate; p2 (refreshed T^Q) must sit back inside the drift/rate bounds —
    # the quantitative form of "the update is invisible to client thresholds".
    target_a = 0.01
    alert_p1 = realized_alert_rate(p1_scores, world.ref_quantiles, target_a)
    alert_p15 = realized_alert_rate(p15_scores, world.ref_quantiles, target_a)
    alert_p2 = realized_alert_rate(p2_scores, world.ref_quantiles, target_a)
    psi_p15 = transformed_stream_psi(p15_scores, world.ref_quantiles)
    psi_p2 = transformed_stream_psi(p2_scores, world.ref_quantiles)

    def _errs(res):
        return [None if np.isnan(v) else float(v) for v in res["rel_err"]]

    return {
        "bins": [f"[{i/10:.1f},{(i+1)/10:.1f})" for i in range(10)],
        "p1": _errs(res_p1), "p1.5": _errs(res_p15), "p2": _errs(res_p2),
        "recall_p1": r_p1, "recall_p1.5": r_p15, "recall_p2": r_p2,
        "recall_gain_pct_points": 100.0 * (r_p2 - r_p1),
        "p15_max_abs_err": float(np.nanmax(np.abs(res_p15["rel_err"]))),
        "p2_max_abs_err": float(np.nanmax(np.abs(res_p2["rel_err"][:8]))),
        "target_alert_rate": target_a,
        "alert_rate_p1": alert_p1,
        "alert_rate_p1.5": alert_p15,
        "alert_rate_p2": alert_p2,
        "psi_p1.5": psi_p15,
        "psi_p2": psi_p2,
        "tq_vs_plain": {"p1": check_p1, "p1.5": check_p15, "p2": check_p2},
        **paper.stamp(dev, quick, before)}


def main(argv: list[str] | None = None) -> int:
    return cli.main(run, __doc__, argv)


if __name__ == "__main__":
    sys.exit(main())
