"""Serving runtime: the dense MUSE data plane.

A mixed-tenant window flows through three stages
(``MuseServer.run_models`` -> ``MuseServer.apply_transforms`` ->
``MuseServer.track``); ``ServerBatcher`` runs them back-to-back on the
caller's thread.  Every control-plane publish swaps one immutable
``_ControlPlane`` (predictors + transform banks + generation), so every
response is consistent with exactly one bank generation
(``ScoringResponse.bank_generation``).
"""
from repro_torch.serving.batching import MicroBatcher, ServerBatcher
from repro_torch.serving.server import (
    FeatureStore,
    MuseServer,
    ServerConfig,
    StaleGenerationError,
)
from repro_torch.serving.shadow import ShadowSink
from repro_torch.serving.types import ScoringRequest, ScoringResponse, ShadowRecord

__all__ = [
    "MicroBatcher", "ServerBatcher", "FeatureStore", "MuseServer",
    "ServerConfig", "StaleGenerationError", "ShadowSink",
    "ScoringRequest", "ScoringResponse", "ShadowRecord",
]
