"""Label-based ensemble adaptation (paper Sec. 2.3.2 + roadmap item 2).

Sec. 2.3.2: "this design enables a lightweight but effective form of model
adaptation ... MUSE supports rapid, low-cost optimization of ensemble
behavior once labeled data becomes available, while preserving the benefits
of expert reuse."  The paper leaves the fitting procedure unspecified and
names *generalized posterior correction* as future work; both are
implemented here:

* :func:`fit_aggregation_weights` — convex log-loss fit of the aggregation
  weights over posterior-corrected expert scores (simplex-constrained so the
  aggregate stays a probability), mirroring the paper's weighted average.
* :func:`generalized_correction_betas` — per-expert *effective* beta fit to
  labeled data: instead of trusting the recorded undersampling ratio, find
  the beta whose posterior correction minimizes the expert's log loss
  (handles experts whose bias deviates from the nominal ratio — e.g. drifted
  deployments), the paper's "dynamically balance the experts ... based not
  only on the undersampling rate".

Both fits are full-batch gradient descent in float32 on one torch device
(``device``: ``None`` is the card, or it raises), with gradients from
``torch.autograd``; numpy in, numpy out.  The loss, its op order and the
step rule are the reference's, so the fitted values agree with it to float32
rounding.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.transforms import posterior_correction
from repro_torch.device import resolve_device, to_numpy


def _log_loss(p: torch.Tensor, y: torch.Tensor, eps: float = 1e-7
              ) -> torch.Tensor:
    p = torch.clamp(p, eps, 1 - eps)
    return -torch.mean(y * torch.log(p) + (1 - y) * torch.log1p(-p))


def _descend(loss, start: torch.Tensor, steps: int, lr: float
             ) -> torch.Tensor:
    """``steps`` plain gradient steps ``x <- x - lr * grad(loss)(x)``."""
    x = start
    for _ in range(steps):
        x = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(loss(x), x)
        x = x.detach() - lr * g
    return x.detach()


def fit_aggregation_weights(
    corrected_scores: np.ndarray,
    labels: np.ndarray,
    *,
    steps: int = 400,
    lr: float = 0.5,
    device: torch.device | str | None = None,
) -> np.ndarray:
    """Fit simplex weights w minimizing log loss of  w · scores.

    ``corrected_scores``: (n, K) posterior-corrected expert scores.
    Parameterized through a softmax so the constraint w >= 0, sum w = 1 is
    structural; optimized by full-batch gradient descent (closed, convex-ish
    problem at MUSE's K <= 10 scale — sub-second).
    """
    dev = resolve_device(device)
    s = torch.as_tensor(np.asarray(corrected_scores), dtype=torch.float32,
                        device=dev)
    y = torch.as_tensor(np.asarray(labels), dtype=torch.float32, device=dev)
    k = s.shape[-1]

    def loss(theta):
        w = torch.softmax(theta, dim=-1)
        return _log_loss(s @ w, y)

    theta = _descend(loss, torch.zeros((k,), dtype=torch.float32,
                                       device=dev), steps, lr)
    return to_numpy(torch.softmax(theta, dim=-1))


def generalized_correction_betas(
    raw_scores: np.ndarray,
    labels: np.ndarray,
    *,
    nominal_betas: np.ndarray | None = None,
    steps: int = 300,
    lr: float = 0.3,
    device: torch.device | str | None = None,
) -> np.ndarray:
    """Per-expert effective undersampling ratio from labeled data.

    Optimizes log-beta (positivity structural) of Eq. 3 per expert by log
    loss.  With perfectly recorded training ratios this recovers them; when
    an expert's real-world bias drifts, the fitted beta compensates.
    """
    dev = resolve_device(device)
    s = torch.as_tensor(np.asarray(raw_scores), dtype=torch.float32,
                        device=dev)
    y = torch.as_tensor(np.asarray(labels), dtype=torch.float32, device=dev)
    k = s.shape[-1]
    init = (np.log(nominal_betas) if nominal_betas is not None
            else np.zeros(k))
    log_beta = torch.as_tensor(init, dtype=torch.float32, device=dev)

    def loss(lb):
        beta = torch.exp(lb)
        corrected = posterior_correction(s, beta[None, :])
        # independent per-expert losses, summed (no cross terms)
        return sum(_log_loss(corrected[:, i], y) for i in range(k))

    log_beta = _descend(loss, log_beta, steps, lr)
    return to_numpy(torch.clamp(torch.exp(log_beta), 1e-4, 1.0))
