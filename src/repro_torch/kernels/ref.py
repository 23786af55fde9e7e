"""Plain PyTorch versions of the port's kernels (the allclose reference).

The CPU path of ``kernels/ops.py`` runs these, and the on-card checks hold
each CUDA kernel against them on the same inputs.
"""
from __future__ import annotations

from repro_torch.core.transforms import banked_score_pipeline

# Banked Eq. 2: gathers by ``index_select``, the bucket as
# ``(a[:, None] >= qs).sum(-1)``, the four knots by ``gather``, the guard
# and clip by ``torch.where``/``clamp``.
score_pipeline_banked = banked_score_pipeline

__all__ = ["score_pipeline_banked"]
