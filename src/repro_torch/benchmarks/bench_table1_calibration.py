"""Table 1: ECE_SWEEP^EM and Brier with and without Posterior Correction,
per expert (beta in {18%, 2%}) on in-distribution validation data and on
out-of-distribution live client data, plus the calibrated ensemble.

The port's counterpart of the reference's
``benchmarks/bench_table1_calibration.py`` at its sizes and seed:
``FraudWorld.build(seed=1)``, 250,000 events a row (80,000 with
``--quick``).  T^C (Eq. 3) runs on the device, on a float32 tensor of the
expert's raw scores; the world, the experts and the metrics are host
numpy, as the reference's.  The result has the reference's keys, plus the
device, the card and the kernel launches (none: T^C is elementwise
PyTorch).

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_table1_calibration \\
        [--quick] [--device cpu] [--out PATH]
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from repro_torch.benchmarks import cli, paper
from repro_torch.core.metrics import brier_score, ece_sweep_em
from repro_torch.core.transforms import posterior_correction
from repro_torch.device import resolve_device, to_numpy
from repro_torch.experiments.fraud_world import FraudWorld
from repro_torch.kernels import ops


def _row(tag, scores, labels, beta, dev):
    corrected = to_numpy(posterior_correction(
        torch.as_tensor(np.asarray(scores, np.float32), device=dev), beta))
    ece0 = ece_sweep_em(scores, labels)
    ece1 = ece_sweep_em(corrected, labels)
    b0 = brier_score(scores, labels)
    b1 = brier_score(corrected, labels)
    return {
        "dataset_predictor": tag, "beta": beta,
        "ece_without": ece0, "ece_with": ece1,
        "ece_change_pct": 100.0 * (ece1 - ece0) / ece0 if ece0 else 0.0,
        "brier_without": b0, "brier_with": b1,
        "brier_change_pct": 100.0 * (b1 - b0) / b0 if b0 else 0.0,
    }


def run(quick: bool = False, device: torch.device | str | None = None
        ) -> dict:
    dev = resolve_device(device)
    before = dict(ops.LAUNCHES)
    n_val = 80_000 if quick else 250_000
    world = FraudWorld.build(seed=1)
    rows = []

    # -- in-distribution: each expert on training-pool validation data
    for name, expert in world.experts.items():
        x, y = world.train_tenant.sample(n_val)
        raw = expert.score(x)
        rows.append(_row(f"validation/{name}", raw, y, expert.beta, dev))

    # -- out-of-distribution: live client data
    x_live, y_live = world.client.sample(n_val)
    for name, expert in world.experts.items():
        raw = expert.score(x_live)
        rows.append(_row(f"live/{name}", raw, y_live, expert.beta, dev))

    # -- ensemble p2 = {m1, m2, m3} on live data: aggregate of corrected vs raw
    names = ("m1", "m2", "m3")
    agg_raw = world.ensemble_aggregated(names, x_live, corrected=False)
    agg_pc = world.ensemble_aggregated(names, x_live, corrected=True)
    ens = {
        "dataset_predictor": "live/p2-ensemble", "beta": None,
        "ece_without": ece_sweep_em(agg_raw, y_live),
        "ece_with": ece_sweep_em(agg_pc, y_live),
        "brier_without": brier_score(agg_raw, y_live),
        "brier_with": brier_score(agg_pc, y_live),
    }
    ens["ece_change_pct"] = 100.0 * (ens["ece_with"] - ens["ece_without"]) \
        / ens["ece_without"]
    ens["brier_change_pct"] = 100.0 * (ens["brier_with"]
                                       - ens["brier_without"]) \
        / ens["brier_without"]
    rows.append(ens)

    # paper claim checks (Table 1): large ECE reductions from PC
    expert_rows = [r for r in rows if r["beta"] is not None]
    return {
        "rows": rows,
        "mean_expert_ece_change_pct": float(np.mean(
            [r["ece_change_pct"] for r in expert_rows])),
        "ensemble_ece_change_pct": ens["ece_change_pct"],
        "ensemble_brier_change_pct": ens["brier_change_pct"],
        **paper.stamp(dev, quick, before)}


def main(argv: list[str] | None = None) -> int:
    return cli.main(run, __doc__, argv)


if __name__ == "__main__":
    sys.exit(main())
