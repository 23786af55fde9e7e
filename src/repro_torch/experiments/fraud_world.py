"""Shared experimental substrate for the paper's evaluation scenarios.

Builds a miniature Feedzai-world with known ground truth:

  * tenants with distinct data distributions (feature shift, fraud rate);
  * expert models = logistic scorers trained on *undersampled* tenant data
    (undersampling ratio beta per expert — the bias T^C must undo);
  * ensembles + transformation pipelines wired through the MUSE core.

Training and sampling are numpy with the reference's PCG64 streams, so a
world built from one seed has bitwise the same expert weights in both
packages.  Serving runs the experts on a torch device
(:meth:`Expert.score_fn`).  The adversarial ``AttackCampaign`` is not ported
yet (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.coldstart import default_quantile_map, fit_beta_mixture
from repro_torch.core.predictor import PredictorSpec
from repro_torch.core.transforms import (
    QuantileMap,
    fraud_reference_quantiles,
    posterior_correction,
)
from repro_torch.device import resolve_device
from repro_torch.training.data import (
    FraudEventStream,
    TenantProfile,
    fit_logistic_expert,
    logistic_expert_scores,
)

DIM = 16


@dataclasses.dataclass
class Expert:
    name: str
    beta: float                  # undersampling ratio used in training
    w: np.ndarray
    b: float
    feature_mask: np.ndarray     # which features this expert sees

    def score(self, x: np.ndarray) -> np.ndarray:
        return logistic_expert_scores(x * self.feature_mask, self.w, self.b)

    def score_fn(self, device: torch.device | str | None = None):
        """The expert as a scoring function on ``device`` (default: the
        card): ``sigmoid((x*mask) @ w + b)`` in float64, as the numpy
        reference computes it, returned as float32."""
        dev = resolve_device(device)
        mask = torch.as_tensor(self.feature_mask, dtype=torch.float64,
                               device=dev)
        w = torch.as_tensor(self.w, dtype=torch.float64, device=dev)
        b = float(self.b)

        def fn(x):
            x = torch.as_tensor(x, device=dev).to(torch.float32)
            z = (x.double() * mask) @ w + b
            return (1.0 / (1.0 + torch.exp(-z))).to(torch.float32)

        return fn


def train_expert(stream: FraudEventStream, name: str, beta: float,
                 *, n_train: int = 60_000, mask_seed: int = 0,
                 mask_keep: float = 1.0) -> Expert:
    """Train a logistic expert on beta-undersampled data from ``stream``."""
    rng = np.random.default_rng(mask_seed)
    mask = (rng.random(DIM) < mask_keep).astype(np.float64)
    if mask.sum() == 0:
        mask[:] = 1.0
    x, y = stream.sample_undersampled(n_train, beta=beta)
    w, b = fit_logistic_expert(x * mask, y, seed=mask_seed)
    return Expert(name=name, beta=beta, w=w, b=b, feature_mask=mask)


@dataclasses.dataclass
class FraudWorld:
    """The cross-experiment fixture."""

    train_tenant: FraudEventStream
    client: FraudEventStream          # live client with shifted distribution
    experts: dict[str, Expert]
    ref_quantiles: np.ndarray         # shared reference distribution R

    @staticmethod
    def build(*, n_experts: int = 3, betas: tuple[float, ...] = (0.18, 0.18, 0.02),
              client_shift: float = 0.35, client_fraud_rate: float = 0.008,
              seed: int = 0, n_ref: int = 256) -> "FraudWorld":
        train_tenant = FraudEventStream(
            TenantProfile("train-pool", fraud_rate=0.01, seed=seed)
        )
        client = FraudEventStream(
            TenantProfile("bank1", fraud_rate=client_fraud_rate,
                          feature_shift=client_shift, seed=seed + 100)
        )
        experts = {}
        for i in range(n_experts):
            beta = betas[i % len(betas)]
            experts[f"m{i + 1}"] = train_expert(
                train_tenant, f"m{i + 1}", beta,
                mask_seed=seed + i, mask_keep=1.0 if i == 0 else 0.8,
            )
        ref = fraud_reference_quantiles(n_ref).numpy()
        return FraudWorld(train_tenant, client, experts, ref)

    # ------------------------------------------------------------------
    def ensemble_raw_scores(self, names: tuple[str, ...], x: np.ndarray
                            ) -> np.ndarray:
        """(n, K) raw expert scores."""
        return np.stack([self.experts[n].score(x) for n in names], axis=-1)

    def ensemble_aggregated(self, names: tuple[str, ...], x: np.ndarray,
                            *, corrected: bool = True) -> np.ndarray:
        """Posterior-corrected (optional) equal-weight aggregation.

        The correction runs in float32 on the host, as the reference's
        (whose arrays are float32 with JAX's 64-bit types off)."""
        raw = self.ensemble_raw_scores(names, x)
        if corrected:
            betas = np.array([self.experts[n].beta for n in names])
            raw = posterior_correction(
                torch.as_tensor(raw, dtype=torch.float32),
                torch.as_tensor(betas, dtype=torch.float32)).numpy()
        return raw.mean(axis=-1)

    def coldstart_quantile_map(self, names: tuple[str, ...],
                               *, n_scores: int = 60_000, seed: int = 7,
                               n_trials: int = 3) -> QuantileMap:
        """T^Q_v0: Beta-mixture prior fit on TRAINING-pool ensemble scores."""
        x, y = self.train_tenant.sample(n_scores)
        agg = self.ensemble_aggregated(names, x)
        fit = fit_beta_mixture(agg, fraud_prior=float(np.mean(y)),
                               n_trials=n_trials, seed=seed)
        return default_quantile_map(fit, self.ref_quantiles)

    def custom_quantile_map(self, names: tuple[str, ...], x_client: np.ndarray
                            ) -> QuantileMap:
        """T^Q_v1: fitted on (unlabeled) client traffic through the ensemble."""
        agg = self.ensemble_aggregated(names, x_client)
        return QuantileMap.fit(
            agg, torch.as_tensor(self.ref_quantiles, dtype=torch.float32))

    def predictor_spec(self, name: str, names: tuple[str, ...],
                       qm: QuantileMap) -> PredictorSpec:
        betas = tuple(self.experts[n].beta for n in names)
        weights = (1.0,) * len(names)
        return PredictorSpec(name, names, betas, weights, qm)

    def model_factories(self, device: torch.device | str | None = None):
        """Model name -> factory of the expert's scoring fn on ``device``
        (default: the card)."""
        dev = resolve_device(device)
        return {n: (lambda e=e: e.score_fn(dev))
                for n, e in self.experts.items()}
