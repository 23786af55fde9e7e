"""Cold-start default transformation (paper Sec. 2.4).

With no client history, the source score distribution S is replaced by a
smooth bimodal Beta mixture fit to the predictor's score distribution on its
experts' combined *training* data:

    f_S(y) = (1-w)·Beta(y; a0, b0) + w·Beta(y; a1, b1)        (Eq. 6)

Shape parameters minimize the moment-matching loss

    L = sum_{r=1..4} ((mu_r - ybar_r)^2)^(1/r)                 (Eq. 7)

via a stochastic search (differential evolution, Storn & Price — the paper's
citation [40]); the best of N_trial runs by Jensen–Shannon divergence against
the empirical distribution is kept (Eq. 8).  The fitted mixture's CDF then
yields the default source quantiles for ``T^Q_{v0}``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.transforms import QuantileMap
from repro_torch.device import to_numpy

# scipy is an OFFLINE-fitting dependency only: serving-only deployments (and
# the tier-1 test lane) import this module for BetaMixtureFit / the fitted
# prior's quantiles — pure numpy — without ever touching the DE optimizer.
# The import is therefore lazy, guarded inside the functions that fit or
# evaluate the mixture densities.


def _scipy_stats():
    from scipy import stats  # lazy: offline fitting path only

    return stats


def beta_mixture_pdf(y: np.ndarray, w: float, a0: float, b0: float,
                     a1: float, b1: float) -> np.ndarray:
    stats = _scipy_stats()
    return (1.0 - w) * stats.beta.pdf(y, a0, b0) + w * stats.beta.pdf(y, a1, b1)


def beta_mixture_cdf(y: np.ndarray, w: float, a0: float, b0: float,
                     a1: float, b1: float) -> np.ndarray:
    stats = _scipy_stats()
    return (1.0 - w) * stats.beta.cdf(y, a0, b0) + w * stats.beta.cdf(y, a1, b1)


def _beta_raw_moment(a: float | np.ndarray, b: float | np.ndarray, r: int):
    """E[X^r] for Beta(a,b) = prod_{j<r} (a+j)/(a+b+j)."""
    m = 1.0
    for j in range(r):
        m = m * (a + j) / (a + b + j)
    return m


def mixture_raw_moments(w: float, a0, b0, a1, b1, r_max: int = 4) -> np.ndarray:
    return np.array(
        [
            (1.0 - w) * _beta_raw_moment(a0, b0, r) + w * _beta_raw_moment(a1, b1, r)
            for r in range(1, r_max + 1)
        ]
    )


def moment_loss(params: np.ndarray, w: float, empirical_moments: np.ndarray) -> float:
    """Eq. 7 — r-th-rooted squared moment discrepancies, summed over r=1..4."""
    a0, b0, a1, b1 = params
    mu = mixture_raw_moments(w, a0, b0, a1, b1, r_max=len(empirical_moments))
    total = 0.0
    for r, (m, e) in enumerate(zip(mu, empirical_moments), start=1):
        total += float(((m - e) ** 2) ** (1.0 / r))
    return total


def jensen_shannon_divergence(p: np.ndarray, q: np.ndarray, eps: float = 1e-12) -> float:
    """JSD between two discrete distributions (natural log)."""
    p = np.asarray(p, dtype=np.float64) + eps
    q = np.asarray(q, dtype=np.float64) + eps
    p /= p.sum()
    q /= q.sum()
    m = 0.5 * (p + q)
    kl_pm = np.sum(p * np.log(p / m))
    kl_qm = np.sum(q * np.log(q / m))
    return float(0.5 * kl_pm + 0.5 * kl_qm)


@dataclasses.dataclass(frozen=True)
class BetaMixtureFit:
    w: float
    a0: float
    b0: float
    a1: float
    b1: float
    jsd: float
    moment_loss: float

    def pdf(self, y: np.ndarray) -> np.ndarray:
        return beta_mixture_pdf(y, self.w, self.a0, self.b0, self.a1, self.b1)

    def cdf(self, y: np.ndarray) -> np.ndarray:
        return beta_mixture_cdf(y, self.w, self.a0, self.b0, self.a1, self.b1)

    def quantiles(self, levels: np.ndarray) -> np.ndarray:
        """Invert the mixture CDF numerically on a dense grid."""
        grid = np.linspace(1e-6, 1.0 - 1e-6, 65537)
        cdf = self.cdf(grid)
        cdf = np.maximum.accumulate(cdf)
        q = np.interp(np.asarray(levels), cdf, grid, left=0.0, right=1.0)
        return np.maximum.accumulate(q)


def fit_beta_mixture(
    train_scores: np.ndarray,
    fraud_prior: float,
    *,
    n_trials: int = 4,
    n_bins: int = 64,
    seed: int = 0,
    maxiter: int = 200,
) -> BetaMixtureFit:
    """Eqs. 6–8: DE moment-matching, best-of-N_trial by JSD vs empirical hist.

    ``fraud_prior`` is w = P(y=1) on the combined training data; the two Beta
    components approximate the class-conditional densities.
    """
    from scipy import optimize  # lazy: offline fitting path only

    y = np.clip(np.asarray(train_scores, dtype=np.float64).ravel(), 1e-6, 1 - 1e-6)
    emp_moments = np.array([np.mean(y**r) for r in range(1, 5)])
    hist, edges = np.histogram(y, bins=n_bins, range=(0.0, 1.0), density=True)
    centers = 0.5 * (edges[:-1] + edges[1:])

    bounds = [(0.05, 200.0)] * 4
    best: BetaMixtureFit | None = None
    for trial in range(n_trials):
        res = optimize.differential_evolution(
            moment_loss,
            bounds=bounds,
            args=(fraud_prior, emp_moments),
            seed=seed + trial,
            maxiter=maxiter,
            tol=1e-10,
            polish=True,
            updating="deferred",
        )
        a0, b0, a1, b1 = res.x
        model_pdf = beta_mixture_pdf(centers, fraud_prior, a0, b0, a1, b1)
        jsd = jensen_shannon_divergence(hist, model_pdf)
        cand = BetaMixtureFit(fraud_prior, a0, b0, a1, b1, jsd, float(res.fun))
        if best is None or cand.jsd < best.jsd:
            best = cand
    assert best is not None
    return best


def default_quantile_map(
    fit: BetaMixtureFit,
    ref_quantiles,
    levels: np.ndarray | None = None,
) -> QuantileMap:
    """Build ``T^Q_{v0}`` from the fitted prior f_S (no client data needed).

    The tables land on the device of ``ref_quantiles`` when it is a tensor,
    else on the CPU."""
    device = ref_quantiles.device \
        if isinstance(ref_quantiles, torch.Tensor) else None
    ref_q = to_numpy(ref_quantiles).astype(np.float64)
    if levels is None:
        levels = np.linspace(0.0, 1.0, ref_q.shape[-1])
    src = fit.quantiles(levels)
    return QuantileMap(
        src_quantiles=torch.tensor(src, dtype=torch.float32, device=device),
        ref_quantiles=torch.tensor(ref_q, dtype=torch.float32, device=device),
    )
