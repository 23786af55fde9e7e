"""MUSE core in PyTorch: the paper's primary contribution.

Sub-modules:
  transforms  — T^C (posterior correction), A (aggregation), T^Q (quantile map)
  coldstart   — Beta-mixture default transformation (Sec. 2.4)
  quantiles   — quantile estimation + Appendix-A sample-size bound
  predictor   — the p = <M, A, T^Q> abstraction (Eq. 2)
  routing     — intent-based routing tables (Sec. 2.5)
  registry    — deduplicated model pool (Sec. 2.2.1)
  metrics     — ECE_SWEEP^EM, Brier, recall@FPR, Wilson intervals
  adaptation  — label-based weight and beta fits (Sec. 2.3.2)
"""
from repro_torch.core.transforms import (
    Aggregation,
    PosteriorCorrection,
    QuantileMap,
    ShardedTransformBank,
    TENANT_AXIS,
    TransformBank,
    banked_score_pipeline,
    posterior_correction,
    posterior_correction_inverse,
    quantile_map,
    score_pipeline,
)
from repro_torch.core.predictor import Predictor, PredictorSpec, TransformPipeline, deploy_predictor
from repro_torch.core.routing import Condition, Intent, Resolution, RoutingTable, ScoringRule, ShadowRule
from repro_torch.core.registry import ModelPool

__all__ = [
    "Aggregation", "PosteriorCorrection", "QuantileMap",
    "ShardedTransformBank", "TENANT_AXIS", "TransformBank",
    "banked_score_pipeline", "posterior_correction",
    "posterior_correction_inverse", "quantile_map",
    "score_pipeline",
    "Predictor", "PredictorSpec", "TransformPipeline", "deploy_predictor",
    "Condition", "Intent", "Resolution", "RoutingTable", "ScoringRule", "ShadowRule",
    "ModelPool",
]
