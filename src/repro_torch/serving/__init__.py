"""Serving runtime: the dense MUSE data plane and its model-update control
plane.

A mixed-tenant window flows through three stages
(``MuseServer.run_models`` -> ``MuseServer.apply_transforms`` ->
``MuseServer.track``); ``ServerBatcher`` runs them back-to-back on the
caller's thread, and :class:`AsyncDispatchEngine` pipelines them across
windows on three stage threads (window *N*'s experts run while window
*N−1* runs the banked kernel and window *N−2*'s estimators update), all on
the device's default stream.  ``ServerConfig(tiering=TieringConfig(...))``
bounds device residency by configuration (``serving/tiering.py``: hot
rows on the device, cold rows paged from a :class:`HostBankStore`, the
cold-start prior for un-gated tenants); the engine prefetches pending
windows' cold rows before their transform stage.  Every control-plane
publish swaps one immutable ``_ControlPlane`` (predictors + transform
banks + generation), so every response is consistent with exactly one
bank generation (``ScoringResponse.bank_generation``).

Around the server sits the model-update lifecycle (paper Fig. 3):

* **calibration** — :class:`CalibrationController` refits T^Q from the
  live streams behind the Eq.-5 gate, validates each candidate and
  publishes atomically; :class:`FleetCalibrationController` pulls and
  merges every replica's estimator checkpoints, fits once and broadcasts
  under one fenced fleet generation (``StaleGenerationError`` refuses a
  non-newer one); ``serving/drift.py`` triggers it from a PSI alarm.
* **rollout** — :class:`ReplicaSet` balances ready replicas with
  generation-fenced session routing; :class:`RollingUpdate` promotes a new
  model version (surge, warm-up, align, fleet refresh, drain).
* **client decisions and audit** — :class:`DecisionLoop` holds fixed
  per-tenant thresholds over the transformed scores; :class:`AuditLog`
  chains every decision, and its ``verify`` replays each one bit for bit
  through the banked kernel from the parameters a
  :class:`GenerationLedger` archived for its generation.
"""
from repro_torch.serving.audit import (
    AuditEntry,
    AuditFailure,
    AuditLog,
    AuditVerification,
    GenerationLedger,
)
from repro_torch.serving.batching import MicroBatcher, ServerBatcher
from repro_torch.serving.calibration import (
    CalibrationController,
    CandidateReport,
    FleetCalibrationController,
    FleetRefreshResult,
    RefreshPolicy,
    RefreshResult,
    ReplicaPullFailure,
)
from repro_torch.serving.decision_loop import (
    Decision,
    DecisionLoop,
    DecisionPolicy,
    decide,
)
from repro_torch.serving.engine import AsyncDispatchEngine
from repro_torch.serving.rollout import (
    FleetGenerationAudit,
    Replica,
    ReplicaSet,
    RollingUpdate,
)
from repro_torch.serving.server import (
    FeatureStore,
    MuseServer,
    ServerConfig,
    StaleGenerationError,
)
from repro_torch.serving.shadow import ShadowSink
from repro_torch.serving.tiering import (
    HostBankStore,
    TieredBankStore,
    TieringConfig,
    prior_bank_row,
)
from repro_torch.serving.types import ScoringRequest, ScoringResponse, ShadowRecord

__all__ = [
    "AsyncDispatchEngine", "AuditEntry", "AuditFailure", "AuditLog", "AuditVerification",
    "GenerationLedger",
    "MicroBatcher", "ServerBatcher",
    "CalibrationController", "CandidateReport", "FleetCalibrationController",
    "FleetRefreshResult", "RefreshPolicy", "RefreshResult",
    "ReplicaPullFailure",
    "Decision", "DecisionLoop", "DecisionPolicy", "decide",
    "FleetGenerationAudit", "Replica", "ReplicaSet", "RollingUpdate",
    "FeatureStore", "MuseServer", "ServerConfig", "StaleGenerationError",
    "ShadowSink", "ScoringRequest", "ScoringResponse", "ShadowRecord",
    "HostBankStore", "TieredBankStore", "TieringConfig", "prior_bank_row",
]
