"""Synthetic data pipelines.

Two streams feed the framework:

1. **Fraud-event stream** — the MUSE evaluation substrate.  A documented
   generative process produces (features, label, score-relevant structure)
   with realistic class imbalance (0.2–2% fraud), per-tenant distribution
   shift, and configurable *undersampling* of the majority class (ratio
   ``beta``) so Posterior Correction has a known ground truth to undo.

2. **Token stream** — next-token LM batches for the architecture zoo's
   training path (deterministic PRNG; infinite iterator of (tokens, labels)).

Both are numpy-side (host) generators, double-buffered into device arrays by
the train loop — the usual host-bound pipeline shape.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


# ---------------------------------------------------------------------------
# Fraud events
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TenantProfile:
    """Per-tenant generative parameters (drives cross-tenant score shift)."""

    name: str
    fraud_rate: float = 0.005
    # class-conditional feature means are drawn from N(0, spread) per tenant
    feature_shift: float = 0.0
    amount_scale: float = 100.0
    seed: int = 0


@dataclasses.dataclass
class FraudEventStream:
    """Synthetic fraud-detection events.

    Features: d-dim Gaussian mixture; fraud events are shifted by a direction
    vector, so a linear-logit "model" has known Bayes posterior — this lets
    tests verify Posterior Correction against closed-form truth.
    """

    profile: TenantProfile
    dim: int = 16
    _rng: np.random.Generator = dataclasses.field(init=False)

    def __post_init__(self) -> None:
        self._rng = np.random.default_rng(self.profile.seed)
        # stable hash: hash() is PYTHONHASHSEED-randomized per process, which
        # would make tenant fraud directions (and every downstream number)
        # non-reproducible across runs
        import zlib
        base_rng = np.random.default_rng(zlib.crc32(self.profile.name.encode()))
        self.direction = base_rng.normal(0, 1, self.dim)
        self.direction /= np.linalg.norm(self.direction)
        self.separation = 2.2  # class separation along `direction`

    def sample(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        """Returns (features (n, dim), labels (n,))."""
        p = self.profile
        y = (self._rng.random(n) < p.fraud_rate).astype(np.int64)
        x = self._rng.normal(0, 1, (n, self.dim)) + p.feature_shift
        x += y[:, None] * self.separation * self.direction[None, :]
        return x.astype(np.float32), y

    def sample_undersampled(self, n_target: int, beta: float
                            ) -> tuple[np.ndarray, np.ndarray]:
        """Training set with the majority (negative) class undersampled at
        ratio ``beta`` = P(keep negative) — the paper's Sec. 2.3.1 setup."""
        xs, ys = [], []
        total = 0
        while total < n_target:
            x, y = self.sample(4 * n_target)
            keep = (y == 1) | (self._rng.random(len(y)) < beta)
            xs.append(x[keep])
            ys.append(y[keep])
            total += int(keep.sum())
        x = np.concatenate(xs)[:n_target]
        y = np.concatenate(ys)[:n_target]
        return x, y

    def bayes_posterior(self, x: np.ndarray) -> np.ndarray:
        """Closed-form P(y=1 | x) for this generative process."""
        p = self.profile
        proj = x @ self.direction
        mu0 = p.feature_shift * self.direction.sum()
        # log-likelihood ratio of the two unit-variance Gaussians along `direction`
        llr = self.separation * (proj - mu0) - 0.5 * self.separation**2
        prior = np.log(p.fraud_rate / (1 - p.fraud_rate))
        return 1.0 / (1.0 + np.exp(-(llr + prior)))


def logistic_expert_scores(x: np.ndarray, w: np.ndarray, b: float) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-(x @ w + b)))


def fit_logistic_expert(x: np.ndarray, y: np.ndarray, *, steps: int = 300,
                        lr: float = 0.5, seed: int = 0
                        ) -> tuple[np.ndarray, float]:
    """Tiny logistic-regression 'expert model' trained by full-batch GD.

    Trained on *undersampled* data it learns the biased posterior — exactly
    the bias T^C must remove.
    """
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.01, x.shape[1])
    b = 0.0
    for _ in range(steps):
        p = 1.0 / (1.0 + np.exp(-(x @ w + b)))
        g = p - y
        w -= lr * (x.T @ g / len(y) + 1e-4 * w)
        b -= lr * float(g.mean())
    return w, b


# ---------------------------------------------------------------------------
# LM token stream
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TokenStream:
    """Deterministic synthetic LM batches: (tokens, next-token labels).

    A Zipfian unigram mixed with short-range induction patterns so the loss
    has learnable structure (models improve measurably within ~100 steps).
    """

    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        rng = np.random.default_rng(self.seed)
        ranks = np.arange(1, self.vocab_size + 1)
        probs = 1.0 / ranks**1.1
        probs /= probs.sum()
        while True:
            toks = rng.choice(self.vocab_size, size=(self.batch_size,
                                                     self.seq_len + 1), p=probs)
            # induction: repeat a random earlier span in 30% of rows
            for i in range(self.batch_size):
                if rng.random() < 0.3:
                    span = rng.integers(4, max(5, self.seq_len // 4))
                    start = rng.integers(0, self.seq_len // 2)
                    dest = rng.integers(self.seq_len // 2,
                                        self.seq_len + 1 - span)
                    toks[i, dest : dest + span] = toks[i, start : start + span]
            yield toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)
