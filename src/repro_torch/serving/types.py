"""Serving-layer value objects."""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Mapping

import numpy as np

from repro_torch.core.routing import Intent

_req_counter = itertools.count()


class StaleGenerationError(RuntimeError):
    """A fenced publish arrived with a generation ≤ the one already served.

    The fleet publish protocol stamps every broadcast with the fleet's
    target generation; a replica that already serves an equal-or-newer
    generation MUST reject the publish (a late ack from a superseded fleet
    pass can otherwise roll a replica's transformations backwards).  The
    tiered bank store (``serving/tiering.py``) enforces the same fence on
    its ``apply_updates``/``rebalance`` control operations, so it lives
    here rather than in ``server.py`` (which re-exports it).
    """

    def __init__(self, requested: int, current: int) -> None:
        super().__init__(
            f"fenced publish at generation {requested} rejected: replica "
            f"already serves generation {current}")
        self.requested = requested
        self.current = current


@dataclasses.dataclass(frozen=True)
class ScoringRequest:
    intent: Intent
    features: np.ndarray                      # (dim,) raw client payload
    request_id: int = dataclasses.field(default_factory=lambda: next(_req_counter))
    metadata: Mapping[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class ScoringResponse:
    request_id: int
    score: float                              # business-ready (post T^Q)
    predictor: str
    routing_version: str
    latency_ms: float
    raw_scores: tuple[float, ...] = ()        # per-expert raw scores (debug)
    # generation of the TransformBank this response was scored under — the
    # calibration-provenance stamp (every row of a window shares exactly one)
    bank_generation: int = -1


@dataclasses.dataclass(frozen=True)
class ShadowRecord:
    """What lands in the data lake for each shadow evaluation."""

    request_id: int
    tenant: str
    predictor: str
    score: float
    raw_scores: tuple[float, ...]
    routing_version: str
