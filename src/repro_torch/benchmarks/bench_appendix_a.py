"""Appendix A: the sample-size bound n = z^2 (1-a) / (delta^2 a) (Eq. 5).

The port's counterpart of the reference's ``benchmarks/bench_appendix_a.py``
at its sizes and seed (``default_rng(0)``, 400 trials a row, 120 with
``--quick``).  Monte Carlo: draw the n scores Eq. 5 asks for, take the
(1-a)-quantile threshold, and read the realized alert rate; its relative
deviation should stay within delta with about 95% coverage (z = 1.96), and
fall short at n / 4.  This is host numpy only: it launches no kernel.
``--device`` follows the port's rule (without it the run needs a card, as
every entry point of the port does) and names no device of the
computation: the result's ``device`` is the host's CPU.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_appendix_a \\
        [--quick] [--device cpu] [--out PATH]
"""
from __future__ import annotations

import sys

import numpy as np

from repro_torch.benchmarks import cli
from repro_torch.core.quantiles import required_sample_size
from repro_torch.device import resolve_device


def _coverage(a: float, delta: float, n: int, trials: int, rng) -> float:
    """Fit scores are Uniform(0,1) (probability integral transform — exactly
    the Appendix-A setting), so the realized alert rate at threshold thr is
    exactly 1 - thr: no evaluation-side Monte-Carlo noise."""
    hits = 0
    for _ in range(trials):
        fit = rng.random(n)
        thr = np.quantile(fit, 1.0 - a)
        realized = 1.0 - thr
        if abs(realized - a) <= delta * a:
            hits += 1
    return hits / trials


def run(quick: bool = False, device=None) -> dict:
    """``device`` follows the port's rule (none: the card, or raise), and
    names no device of the computation: the benchmark is host numpy."""
    resolve_device(device)
    rng = np.random.default_rng(0)
    trials = 120 if quick else 400
    rows = []
    for a in (0.001, 0.005, 0.01, 0.05):
        for delta in (0.1, 0.2):
            n = required_sample_size(a, delta)
            if n > 3_000_000 and quick:
                continue
            cov = _coverage(a, delta, n, trials, rng)
            # a quarter of n should break coverage noticeably below nominal
            cov_quarter = _coverage(a, delta, max(n // 4, 10), trials, rng)
            rows.append({
                "alert_rate": a, "delta": delta, "n_required": n,
                "coverage_at_n": cov, "coverage_at_n_over_4": cov_quarter,
            })
    return {"rows": rows, "nominal": 0.95,
            "device": "cpu", "nvidia_smi": None, "quick": quick}


def main(argv: list[str] | None = None) -> int:
    return cli.main(run, __doc__, argv)


if __name__ == "__main__":
    sys.exit(main())
