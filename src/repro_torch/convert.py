"""Build the port's objects from the reference package's parameters.

The inputs are plain numpy arrays (``np.asarray`` of the reference's
arrays), so this module needs neither JAX nor the reference package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.transforms import QuantileMap, TransformBank
from repro_torch.experiments.fraud_world import Expert


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32), device=device)


def bank_from_numpy(betas, weights, src, ref, *, generation: int,
                    device: torch.device | str) -> TransformBank:
    """(T, K), (T, K), (T, N), (T, N) arrays -> a bank on ``device``."""
    return TransformBank(
        betas=_f32(betas, device), weights=_f32(weights, device),
        src_quantiles=_f32(src, device), ref_quantiles=_f32(ref, device),
        generation=generation)


def quantile_map_from_numpy(src, ref, device: torch.device | str
                            ) -> QuantileMap:
    """(N,), (N,) arrays -> a ``QuantileMap`` on ``device``."""
    return QuantileMap(src_quantiles=_f32(src, device),
                       ref_quantiles=_f32(ref, device))


def expert_from_numpy(name: str, beta: float, w, b: float,
                      feature_mask) -> Expert:
    """A FraudWorld expert from its weights (kept in float64, as trained)."""
    return Expert(name=name, beta=float(beta),
                  w=np.array(w, np.float64), b=float(b),
                  feature_mask=np.array(feature_mask, np.float64))
