"""Shared experimental substrate for the paper's evaluation scenarios.

Builds a miniature Feedzai-world with known ground truth:

  * tenants with distinct data distributions (feature shift, fraud rate);
  * expert models = logistic scorers trained on *undersampled* tenant data
    (undersampling ratio beta per expert — the bias T^C must undo);
  * ensembles + transformation pipelines wired through the MUSE core.

Training and sampling are numpy with the reference's PCG64 streams, so a
world built from one seed has bitwise the same expert weights in both
packages.  Serving runs the experts on a torch device
(:meth:`Expert.score_fn`).

Adversarial attack campaigns
----------------------------

MUSE's pitch is resilience against *shifting attacks*; the related work
(Full-range Calibration, arXiv 2607.05481) stresses the regime where the
malicious score distribution drifts FAST while benign stays stable.
:class:`AttackCampaign` models exactly that on top of the fraud world:

  * **benign stays stationary** — every day's legitimate events are drawn
    from the tenant's fixed :class:`~repro_torch.training.data.TenantProfile`
    distribution (same mean, same covariance, same fraud direction);
  * **malicious drifts per wave** — an :class:`AttackWave` targets specific
    tenants for a span of days, multiplying their fraud rate (burstiness)
    and moving the malicious class-conditional mean TOWARD the decision
    boundary: the fraud separation is scaled down per wave and decays
    further each day inside the wave (``drift_per_day``), and a
    ``boundary_mass`` fraction of fraud events is drawn even closer to the
    boundary (mass migration into the region where thresholds live);
  * **scripted multi-day schedules** — ``schedule()`` materializes the
    per-day picture (active waves, effective drift parameters, model
    promotion days) so a replay harness can interleave
    ``RollingUpdate`` promotions with attack waves deterministically.

Sampling is DETERMINISTIC and order-independent: ``sample(tenant, day, n)``
derives a fresh PRNG from ``(seed, tenant, day)``, so identical seeds give
bitwise-identical streams no matter in which order days or tenants are
drawn, and one seed gives the reference package's samples bit for bit
(``tests/test_torch_audit.py``).
"""
from __future__ import annotations

import dataclasses
import zlib

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


# ---------------------------------------------------------------------------
# Adversarial attack campaigns
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttackWave:
    """One bursty, tenant-targeted wave of fast-drifting malicious traffic.

    During the wave the targeted tenants' fraud rate is multiplied by
    ``fraud_multiplier`` (the burst) and the malicious class-conditional
    mean moves toward the decision boundary: fraud events are generated at
    ``separation_scale`` of the world's base class separation, decaying by
    ``drift_per_day`` every day the wave ages (fast intra-wave drift), and
    a ``boundary_mass`` fraction of them is drawn at an additional
    ``boundary_scale`` contraction — the mass migration into the threshold
    region.  Benign events are untouched.
    """

    name: str
    targets: tuple[str, ...]
    start_day: int
    duration: int
    fraud_multiplier: float = 6.0
    separation_scale: float = 0.55
    drift_per_day: float = 0.06
    boundary_mass: float = 0.5
    boundary_scale: float = 0.55
    min_scale: float = 0.08

    def active_on(self, day: int) -> bool:
        return self.start_day <= day < self.start_day + self.duration

    def effective_scale(self, day: int) -> float:
        """Separation scale on ``day`` — drifts down as the wave ages."""
        age = max(day - self.start_day, 0)
        return max(self.separation_scale - self.drift_per_day * age,
                   self.min_scale)


@dataclasses.dataclass(frozen=True)
class CampaignDay:
    """One materialized day of the scripted schedule."""

    day: int
    waves: tuple[str, ...]            # active wave names
    promote: bool                     # a model promotion runs this day
    # per-tenant effective malicious parameters for the day:
    # tenant -> (fraud_multiplier, separation_scale, boundary_mass)
    tenant_params: dict[str, tuple[float, float, float]]


@dataclasses.dataclass
class AttackCampaign:
    """Multi-day adversarial schedule over a set of tenant streams.

    ``tenants`` maps tenant name -> the BENIGN generative profile (held
    stationary for the whole campaign); ``waves`` and ``promotion_days``
    script the adversarial timeline.  ``sample`` is pure in
    ``(seed, tenant, day)`` — see the module docstring.
    """

    tenants: dict[str, TenantProfile]
    waves: tuple[AttackWave, ...]
    promotion_days: tuple[int, ...]
    n_days: int
    dim: int = DIM
    seed: int = 0
    separation: float = 2.2           # FraudEventStream's class separation

    # ------------------------------------------------------------- schedule
    def waves_on(self, day: int, tenant: str) -> list[AttackWave]:
        return [w for w in self.waves
                if w.active_on(day) and tenant in w.targets]

    def day_params(self, day: int, tenant: str
                   ) -> tuple[float, float, float]:
        """Effective (fraud_multiplier, separation_scale, boundary_mass)
        for one tenant-day; quiet days are (1, 1, 0)."""
        active = self.waves_on(day, tenant)
        if not active:
            return 1.0, 1.0, 0.0
        mult = 1.0
        scale = 1.0
        bmass = 0.0
        for w in active:               # overlapping waves compound
            mult *= w.fraud_multiplier
            scale = min(scale, w.effective_scale(day))
            bmass = max(bmass, w.boundary_mass)
        return mult, scale, bmass

    def schedule(self) -> list[CampaignDay]:
        """The scripted multi-day timeline, fully materialized."""
        out = []
        for day in range(self.n_days):
            names = tuple(w.name for w in self.waves if w.active_on(day))
            out.append(CampaignDay(
                day=day, waves=names, promote=day in self.promotion_days,
                tenant_params={t: self.day_params(day, t)
                               for t in self.tenants}))
        return out

    # -------------------------------------------------------------- sampling
    def _direction(self, tenant: str) -> np.ndarray:
        # identical construction to FraudEventStream: crc32-keyed so the
        # campaign's fraud direction matches the tenant's benign stream
        rng = np.random.default_rng(zlib.crc32(tenant.encode()))
        d = rng.normal(0, 1, self.dim)
        return d / np.linalg.norm(d)

    def sample(self, tenant: str, day: int, n: int
               ) -> tuple[np.ndarray, np.ndarray]:
        """(features (n, dim), labels (n,)) for one tenant-day.

        Deterministic in (seed, tenant, day): the PRNG is derived fresh per
        call, so replays are bitwise-identical regardless of draw order.
        """
        profile = self.tenants[tenant]
        rng = np.random.default_rng(
            [self.seed, zlib.crc32(tenant.encode()), day])
        mult, scale, bmass = self.day_params(day, tenant)
        rate = min(profile.fraud_rate * mult, 0.5)
        y = (rng.random(n) < rate).astype(np.int64)
        # benign: STATIONARY — same distribution every day of the campaign
        x = rng.normal(0, 1, (n, self.dim)) + profile.feature_shift
        direction = self._direction(tenant)
        # malicious: per-wave drifted separation; a boundary_mass fraction
        # migrates further toward the decision boundary
        sep = np.full(n, self.separation * scale)
        if bmass > 0.0:
            near = rng.random(n) < bmass
            sep = np.where(near, sep * min(
                w.boundary_scale for w in self.waves_on(day, tenant)), sep)
        x += (y * sep)[:, None] * direction[None, :]
        return x.astype(np.float32), y

    # --------------------------------------------------------------- builder
    @staticmethod
    def build(tenant_names: tuple[str, ...],
              *, n_days: int = 10, n_waves: int = 2,
              promotion_days: tuple[int, ...] = (2, 6),
              fraud_rate: float = 0.01, feature_shift: float = 0.25,
              seed: int = 0, dim: int = DIM) -> "AttackCampaign":
        """Script a deterministic campaign: ``n_waves`` bursty waves with
        staggered starts, each targeting one tenant round-robin, interleaved
        with the given model-promotion days."""
        rng = np.random.default_rng([seed, 0xA77AC4])
        tenants = {
            t: TenantProfile(t, fraud_rate=fraud_rate * (1 + 0.2 * i),
                             feature_shift=feature_shift + 0.05 * i,
                             seed=seed + 900 + i)
            for i, t in enumerate(tenant_names)
        }
        waves = []
        quiet = max((n_days - 2) // max(n_waves, 1), 2)
        for k in range(n_waves):
            start = 2 + k * quiet + int(rng.integers(0, 2))
            waves.append(AttackWave(
                name=f"wave{k}",
                targets=(tenant_names[k % len(tenant_names)],),
                start_day=min(start, n_days - 2),
                duration=int(rng.integers(2, max(quiet, 3))),
                fraud_multiplier=float(rng.uniform(4.0, 8.0)),
                separation_scale=float(rng.uniform(0.45, 0.65)),
                drift_per_day=float(rng.uniform(0.04, 0.10)),
                boundary_mass=float(rng.uniform(0.3, 0.6)),
            ))
        return AttackCampaign(tenants=tenants, waves=tuple(waves),
                              promotion_days=promotion_days, n_days=n_days,
                              dim=dim, seed=seed)
