"""Calibration / evaluation metrics used by the paper's evaluation (Sec. 3).

* Brier score (MSE of probabilities vs labels).
* ECE_SWEEP^EM  (Roelofs et al. 2022): equal-mass binning, sweeping the number
  of bins upward while the per-bin empirical positive rate stays monotone —
  the least-biased standard ECE estimator, the one the paper uses (Table 1).
* recall @ FPR (Sec. 3.2's "Recall at 1% FPR").
* Wilson score intervals (Fig. 4 error bars).
* Per-bin relative error against a target distribution (Figs. 4 and 6).
"""
from __future__ import annotations

import numpy as np


def brier_score(scores: np.ndarray, labels: np.ndarray) -> float:
    scores = np.asarray(scores, dtype=np.float64).ravel()
    labels = np.asarray(labels, dtype=np.float64).ravel()
    return float(np.mean((scores - labels) ** 2))


def _ece_equal_mass(scores_sorted: np.ndarray, labels_sorted: np.ndarray,
                    n_bins: int) -> tuple[float, bool]:
    """ECE with equal-mass bins on pre-sorted data.

    Returns (ece, monotone) where monotone indicates whether per-bin empirical
    positive rates are non-decreasing with confidence.
    """
    n = len(scores_sorted)
    edges = (np.arange(1, n_bins) * n) // n_bins
    score_bins = np.split(scores_sorted, edges)
    label_bins = np.split(labels_sorted, edges)
    ece = 0.0
    prev = -np.inf
    monotone = True
    for sb, lb in zip(score_bins, label_bins):
        if len(sb) == 0:
            continue
        conf = float(np.mean(sb))
        acc = float(np.mean(lb))
        ece += (len(sb) / n) * abs(conf - acc)
        if acc < prev - 1e-12:
            monotone = False
        prev = acc
    return ece, monotone


def ece_sweep_em(scores: np.ndarray, labels: np.ndarray, max_bins: int | None = None) -> float:
    """ECE_SWEEP^EM: the largest equal-mass bin count preserving monotonicity.

    Sweeps b = 1, 2, ... while the binned empirical positive rate remains
    non-decreasing in confidence; returns the ECE at the largest monotone b
    (Roelofs et al., 2022, "Mitigating Bias in Calibration Error Estimation").
    """
    scores = np.asarray(scores, dtype=np.float64).ravel()
    labels = np.asarray(labels, dtype=np.float64).ravel()
    order = np.argsort(scores, kind="stable")
    s, l = scores[order], labels[order]
    n = len(s)
    if max_bins is None:
        max_bins = n
    best_ece = abs(float(np.mean(s)) - float(np.mean(l)))  # b = 1
    for b in range(2, max_bins + 1):
        ece, monotone = _ece_equal_mass(s, l, b)
        if not monotone:
            break
        best_ece = ece
    return best_ece


def recall_at_fpr(scores: np.ndarray, labels: np.ndarray, fpr: float = 0.01) -> float:
    """Recall at the threshold whose false-positive rate is ``fpr``."""
    scores = np.asarray(scores, dtype=np.float64).ravel()
    labels = np.asarray(labels, dtype=np.int64).ravel()
    neg = np.sort(scores[labels == 0])
    if len(neg) == 0:
        return float("nan")
    # threshold = (1-fpr) quantile of negative scores
    thr = np.quantile(neg, 1.0 - fpr)
    pos = scores[labels == 1]
    if len(pos) == 0:
        return float("nan")
    return float(np.mean(pos > thr))


def wilson_interval(successes: int, total: int, z: float = 1.96) -> tuple[float, float]:
    """Wilson score interval for a binomial proportion (Fig. 4 error bars)."""
    if total == 0:
        return (0.0, 1.0)
    p = successes / total
    denom = 1.0 + z * z / total
    center = (p + z * z / (2 * total)) / denom
    half = (z / denom) * np.sqrt(p * (1 - p) / total + z * z / (4 * total * total))
    return (max(0.0, center - half), min(1.0, center + half))


def bin_relative_error(
    scores: np.ndarray,
    target_quantiles: np.ndarray,
    n_bins: int = 10,
    *,
    levels: np.ndarray | None = None,
) -> dict[str, np.ndarray]:
    """Figs. 4/6 metric: per-score-bin relative error vs the target distribution.

    The target bin mass is derived from the reference quantile table
    (CDF of R); observed mass is the empirical histogram of served scores.
    relative error = (observed - expected) / expected, per bin [i/n, (i+1)/n).
    Also returns Wilson interval half-widths on the observed proportions.
    """
    scores = np.asarray(scores, dtype=np.float64).ravel()
    tq = np.asarray(target_quantiles, dtype=np.float64)
    if levels is None:
        levels = np.linspace(0.0, 1.0, len(tq))
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    # CDF of R at bin edges: invert quantile table (levels as function of value)
    cdf_at_edges = np.interp(edges, tq, levels, left=0.0, right=1.0)
    expected = np.diff(cdf_at_edges)
    counts, _ = np.histogram(scores, bins=edges)
    n = len(scores)
    observed = counts / max(n, 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        rel_err = np.where(expected > 0, (observed - expected) / expected, np.nan)
    lo = np.empty(n_bins)
    hi = np.empty(n_bins)
    for i, c in enumerate(counts):
        lo[i], hi[i] = wilson_interval(int(c), n)
    return {
        "edges": edges,
        "expected": expected,
        "observed": observed,
        "rel_err": rel_err,
        "wilson_lo": lo,
        "wilson_hi": hi,
        "counts": counts,
    }


def expected_calibration_error_fixed(scores: np.ndarray, labels: np.ndarray,
                                     n_bins: int = 15) -> float:
    """Plain fixed-width ECE (for cross-checks against ECE_SWEEP^EM)."""
    scores = np.asarray(scores, dtype=np.float64).ravel()
    labels = np.asarray(labels, dtype=np.float64).ravel()
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    idx = np.clip(np.digitize(scores, edges) - 1, 0, n_bins - 1)
    ece = 0.0
    n = len(scores)
    for b in range(n_bins):
        mask = idx == b
        if not mask.any():
            continue
        ece += (mask.sum() / n) * abs(scores[mask].mean() - labels[mask].mean())
    return float(ece)
