"""The predictor abstraction (paper Sec. 2.2, Eq. 2).

A predictor is the tuple ``p = <M, A, T^Q>``:

  * ``M``  — subset of expert models, each paired with its posterior
             correction ``T^C_k`` (a beta ratio from its training config);
  * ``A``  — aggregation (weighted average);
  * ``T^Q`` — quantile map to the stable reference distribution.

``PredictorSpec`` is the declarative half (model names + transform params —
what lives in the control plane / routing config).  ``Predictor`` is the bound
half: specs resolved against a :class:`~repro_torch.core.registry.ModelPool`,
with the Eq. 2 pipeline's tensors on one device.  Single-model predictors
skip ``T^C`` and use identity aggregation, per the paper.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import torch

from repro_torch.core import transforms
from repro_torch.core.registry import ModelPool
from repro_torch.core.transforms import QuantileMap
from repro_torch.device import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TransformPipeline:
    """The post-model half of Eq. 2 as one frozen value (swap = model update)."""

    betas: Tensor          # (K,) per-expert undersampling ratios
    weights: Tensor        # (K,) aggregation weights
    src_quantiles: Tensor  # (N,)
    ref_quantiles: Tensor  # (N,)

    def __call__(self, expert_scores: Tensor) -> Tensor:
        """expert_scores: (..., K) raw scores -> (...) business-ready score."""
        return transforms.score_pipeline(
            expert_scores, self.betas, self.weights,
            self.src_quantiles, self.ref_quantiles,
        )

    def pre_quantile(self, expert_scores: Tensor) -> Tensor:
        """The T^Q *input*: posterior-corrected weighted aggregate.

        This is the distribution whose quantiles a refreshed T^Q must be
        fitted on (fitting on raw scores would mismatch the pipeline)."""
        corrected = transforms.posterior_correction(expert_scores, self.betas)
        w = self.weights / torch.sum(self.weights)
        return torch.einsum("...k,k->...", corrected, w)

    @property
    def num_experts(self) -> int:
        return int(self.betas.shape[-1])

    def with_quantile_map(self, qm: QuantileMap) -> "TransformPipeline":
        """New pipeline with ``qm``'s tables, moved to this pipeline's device."""
        device = self.betas.device
        return dataclasses.replace(
            self, src_quantiles=qm.src_quantiles.to(device),
            ref_quantiles=qm.ref_quantiles.to(device)
        )

    def with_weights(self, weights: Tensor) -> "TransformPipeline":
        return dataclasses.replace(self, weights=torch.as_tensor(
            weights, dtype=torch.float32, device=self.betas.device))


@dataclasses.dataclass(frozen=True)
class PredictorSpec:
    """Declarative predictor definition (control-plane object)."""

    name: str
    model_names: tuple[str, ...]
    betas: tuple[float, ...]          # per-model undersampling ratio (1.0 = none)
    weights: tuple[float, ...]        # aggregation weights
    quantile_map: QuantileMap
    metadata: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        k = len(self.model_names)
        if len(self.betas) != k or len(self.weights) != k:
            raise ValueError(
                f"predictor {self.name}: {k} models but "
                f"{len(self.betas)} betas / {len(self.weights)} weights"
            )

    @property
    def is_ensemble(self) -> bool:
        return len(self.model_names) > 1

    def pipeline(self, device: torch.device | str | None = None
                 ) -> TransformPipeline:
        """The bound pipeline, its tensors on ``device`` (default: where the
        spec's quantile map lives)."""
        # Single-model predictors skip posterior correction (Sec. 2.2.2):
        # beta is forced to 1.0 (identity) and aggregation is identity.
        betas = self.betas if self.is_ensemble else (1.0,) * len(self.betas)
        if device is None:
            device = self.quantile_map.src_quantiles.device
        return TransformPipeline(
            betas=torch.tensor(betas, dtype=torch.float32, device=device),
            weights=torch.tensor(self.weights, dtype=torch.float32,
                                 device=device),
            src_quantiles=self.quantile_map.src_quantiles.to(device),
            ref_quantiles=self.quantile_map.ref_quantiles.to(device),
        )

    @staticmethod
    def single(name: str, model_name: str, quantile_map: QuantileMap,
               **metadata: Any) -> "PredictorSpec":
        return PredictorSpec(
            name=name, model_names=(model_name,), betas=(1.0,), weights=(1.0,),
            quantile_map=quantile_map, metadata=metadata,
        )


class Predictor:
    """Spec bound to a model pool and a device; callable on feature batches.

    Scoring (Eq. 2): run every expert, stack raw scores on the last axis on
    the predictor's device, then apply the transformation pipeline.  Raw
    scores are also returned for shadow logging / calibration analysis.
    """

    def __init__(self, spec: PredictorSpec, pool: ModelPool,
                 device: torch.device | str | None = None) -> None:
        self.spec = spec
        self.device = resolve_device(device)
        self._handles = [pool.acquire(n) for n in spec.model_names]
        self.pipeline = spec.pipeline(self.device)

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def model_names(self) -> tuple[str, ...]:
        return self.spec.model_names

    def raw_scores(self, features: Any) -> Tensor:
        """(..., K) stack of raw expert scores on the predictor's device.

        Model outputs may be numpy arrays or tensors.  A float64 output is
        stored as float32, as the reference stores it (JAX there runs with
        64-bit types off)."""
        outs = []
        for h in self._handles:
            out = torch.as_tensor(h.score_fn(features), device=self.device)
            outs.append(out.float() if out.dtype == torch.float64 else out)
        return torch.stack(outs, dim=-1)

    def __call__(self, features: Any) -> Tensor:
        return self.pipeline(self.raw_scores(features))

    def score_with_raw(self, features: Any) -> tuple[Tensor, Tensor]:
        raw = self.raw_scores(features)
        return self.pipeline(raw), raw

    # -- seamless updates ----------------------------------------------------
    def with_updated_pipeline(self, pipeline: TransformPipeline) -> "Predictor":
        """Hot-swap the transformation pipeline (e.g. T^Q_v0 -> T^Q_v1).

        Returns a new predictor sharing the same model handles — no model
        re-provisioning, which is exactly the paper's cheap-update path.
        """
        clone = object.__new__(Predictor)
        clone.spec = self.spec
        clone.device = self.device
        clone._handles = self._handles
        clone.pipeline = pipeline
        return clone

    def release(self, pool: ModelPool) -> None:
        for n in self.spec.model_names:
            pool.release(n)


def deploy_predictor(spec: PredictorSpec, pool: ModelPool,
                     model_factories: Mapping[str, Callable[[], Any]],
                     model_costs: Mapping[str, float] | None = None,
                     *, device: torch.device | str | None = None) -> Predictor:
    """Deploy a predictor, provisioning only the models the pool lacks.

    ``model_factories`` maps model name -> zero-arg callable building the
    scoring fn (expensive: loads weights).  The factory is invoked only for
    models not already in the pool — Sec. 2.2.1's marginal-cost deployment.
    ``device`` is where the predictor's pipeline lives (default: the card).
    """
    costs = dict(model_costs or {})
    for name in spec.model_names:
        if name not in pool:
            pool.deploy(name, model_factories[name](),
                        resource_cost=costs.get(name, 1.0))
    return Predictor(spec, pool, device)
