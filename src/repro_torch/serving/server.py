"""MuseServer: the scoring data plane (paper Fig. 1), dense topology.

Request path:  intent -> routing (live + shadows) -> feature enrichment ->
expert models -> T^C -> A -> T^Q -> response; shadow scores go to the sink.

A mixed-tenant micro-batch is grouped by *model group* (the predictor's
expert-model set): one model call produces raw scores for the whole group,
and one tenant-indexed banked kernel launch
(:func:`repro_torch.kernels.ops.score_pipeline_banked`) applies every
predictor's T^C/A/T^Q — no per-predictor Python loop.

The banked dispatch is split into three stages:

  * :meth:`MuseServer.run_models`       — expert-model execution (raw scores)
  * :meth:`MuseServer.apply_transforms` — ONE banked T^C/A/T^Q kernel launch
  * :meth:`MuseServer.track`            — quantile-estimator reservoir updates

Each stage reads served state through a :class:`_ControlPlane` snapshot —
ONE attribute read yields a mutually consistent (predictors, banks,
generation) triple, because every control-plane operation (deploy,
decommission, calibration publish) swaps the whole plane in a single
reference assignment.  A stage that snapshotted the old plane finishes on
the old generation; the next stage pickup sees the complete new one.

The server holds its predictors' pipelines and banks on one torch device
(the card unless the caller asks for the CPU).  Between stages a window
moves as numpy on the host, as in the reference.  The sharded and tiered
topologies and fused device tracking are not ported yet: their
configurations raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import zlib
from typing import Any, Callable, Mapping

import numpy as np
import torch

from repro_torch.core.predictor import Predictor, PredictorSpec, deploy_predictor
from repro_torch.core.quantiles import StreamingQuantileEstimator
from repro_torch.core.registry import ModelPool
from repro_torch.core.routing import Intent, RoutingTable
from repro_torch.core.transforms import QuantileMap, TransformBank
from repro_torch.device import resolve_device, to_numpy
from repro_torch.kernels import ops
from repro_torch.serving.shadow import ShadowSink
from repro_torch.serving.types import (
    ScoringRequest,
    ScoringResponse,
    ShadowRecord,
    StaleGenerationError,
)

__all__ = [
    "FeatureStore", "MuseServer", "ServerConfig",
    "StaleGenerationError",  # canonical home is serving/types.py
]


class FeatureStore:
    """Per-tenant derived-feature lookup (paper's 'Easy Feature Evolution').

    Models may require wider feature vectors than the client payload carries;
    the store supplies the model-specific derived features so new model
    versions deploy without client payload changes.
    """

    def __init__(self) -> None:
        self._store: dict[str, np.ndarray] = {}

    def put(self, tenant: str, derived: np.ndarray) -> None:
        self._store[tenant] = np.asarray(derived, np.float32)

    def enrich(self, intent: Intent, features: np.ndarray, target_dim: int
               ) -> np.ndarray:
        features = np.asarray(features, np.float32)
        if features.shape[-1] >= target_dim:
            return features[..., :target_dim]
        derived = self._store.get(intent.tenant)
        pad_width = target_dim - features.shape[-1]
        if derived is None:
            pad = np.zeros(features.shape[:-1] + (pad_width,), np.float32)
        else:
            reps = -(-pad_width // len(derived))
            pad = np.tile(derived, reps)[:pad_width]
            pad = np.broadcast_to(pad, features.shape[:-1] + (pad_width,))
        return np.concatenate([features, pad], axis=-1)


def stream_seed(key: tuple[str, str]) -> int:
    """Deterministic RNG seed for a (tenant, predictor) estimator stream.

    ``"/".join(key)`` is injective when no component contains the
    separator, so that case hashes the join (the legacy digest).  Ambiguous
    keys (a "/" inside a component) switch to length-prefix framing, led by
    a ``0xff`` byte: 0xff never occurs in UTF-8 output, so the framed
    namespace is disjoint from every legacy payload and the combined map is
    injective."""
    if any("/" in part for part in key):
        payload = b"\xff" + b"".join(
            len(part := p.encode()).to_bytes(4, "big") + part for p in key)
    else:
        payload = "/".join(key).encode()
    return zlib.crc32(payload)


@dataclasses.dataclass
class ServerConfig:
    track_quantiles: bool = True
    quantile_capacity: int = 131072
    # newest-samples ring per estimator stream: sized so a "recent"-window
    # refresh sees roughly the drift timescale of interest, not the
    # all-time reservoir
    recent_capacity: int = 4096
    refresh_alert_rate: float = 0.01   # Eq. 5 gating for auto-refresh readiness
    refresh_rel_error: float = 0.2
    # fused tenant-indexed kernel launch; False runs the plain banked
    # version (TransformBank.__call__: same semantics, no hand-written kernel)
    fused_kernel: bool = True
    # not ported yet: only the dense defaults are accepted
    # (tenant_shards > 1: ROADMAP Queue 1 item 11; tiering: item 10;
    # track_device: item 6)
    tenant_shards: int = 1
    tiering: Any = None
    track_device: bool = False


def _shape_bucket(n: int) -> int:
    """Next power of two >= n: serving batches are padded up to a bucket so
    the set of batch shapes the models and the kernel see stays bounded
    (one per bucket, not one per arbitrary window length)."""
    b = 1
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass(frozen=True)
class _BankEntry:
    """A cached model-group bank pinned to the pipelines it was built from.

    ``pipelines`` is the identity witness: a ``publish_quantile_maps`` /
    redeploy replaces pipeline objects, so a stale entry fails the identity
    check and is rebuilt.  The bank itself carries the generation it was
    published under (see :class:`~repro_torch.core.transforms.TransformBank`).
    """

    pipelines: tuple[Any, ...]
    bank: TransformBank


@dataclasses.dataclass(frozen=True)
class _ControlPlane:
    """One immutable view of everything a dispatch stage reads.

    ``predictors`` and ``banks`` are plain dicts, but the PLANE object is
    what gets swapped: every control-plane mutation builds fresh dicts and
    replaces ``MuseServer._plane`` in a single reference assignment, so a
    stage that reads ``server.plane`` once can never observe predictors of
    one generation with banks of another.  ``banks`` doubles as the lazy
    bank-build cache; inserting a missing entry is idempotent and therefore
    safe to do from a dispatch stage (a concurrently swapped-out plane just
    drops the cached entry — never serves stale parameters).
    """

    predictors: dict[str, Predictor]
    banks: dict[tuple[str, ...], _BankEntry]
    generation: int


def _check_config(config: ServerConfig) -> None:
    if config.tenant_shards > 1:
        raise NotImplementedError(
            "tenant-sharded banks are not ported yet (ROADMAP Queue 1 item 11)")
    if config.tiering is not None:
        raise NotImplementedError(
            "the tiered bank store is not ported yet (ROADMAP Queue 1 item 10)")
    if config.track_device:
        raise NotImplementedError(
            "fused device tracking is not ported yet (ROADMAP Queue 1 item 6)")


class MuseServer:
    def __init__(self, routing: RoutingTable,
                 config: ServerConfig | None = None,
                 device: torch.device | str | None = None) -> None:
        self.config = config or ServerConfig()
        _check_config(self.config)
        # where predictors' pipelines and the transform banks live
        self.device = resolve_device(device)
        self.pool = ModelPool()
        self.routing = routing
        self.sink = ShadowSink()
        self.features = FeatureStore()
        # per (tenant, predictor) streaming estimators for calibration refresh
        self._estimators: dict[tuple[str, str], StreamingQuantileEstimator] = {}
        # estimator MUTATION (track stage) vs reads of whole estimator state
        # must not interleave
        self._estimator_lock = threading.Lock()
        # THE served control-plane state: swapped wholesale on every deploy /
        # decommission / calibration publish (never mutated across a publish).
        self._plane = _ControlPlane(predictors={}, banks={}, generation=0)
        self.metrics: dict[str, float] = {
            "requests": 0, "shadow_evals": 0, "kernel_dispatches": 0,
            "model_group_calls": 0, "model_calls": 0, "bank_generation": 0,
            "shard_dispatches": 0, "tier_dispatches": 0,
            # share of pow-2 row blocks holding one tenant only, over all
            # fused dispatches (the reference's skip-rate report, same
            # blocking, so the counters agree across packages)
            "skip_blocks_uniform": 0, "skip_blocks_total": 0,
            "track_staged_windows": 0}
        # dict `+=` is load/add/store — racy once stages run on several
        # threads; serialize the bumps
        self._metrics_lock = threading.Lock()
        # control-plane mutations are read-modify-writes of _plane; every
        # mutator holds this lock across its RMW.  Dispatch stages never
        # take it — they only snapshot the reference.
        self._control_lock = threading.Lock()

    def bump_metric(self, key: str, n: float = 1) -> None:
        with self._metrics_lock:
            self.metrics[key] += n

    # ------------------------------------------------------------ plane views
    @property
    def plane(self) -> _ControlPlane:
        """The current control-plane snapshot (ONE consistent read)."""
        return self._plane

    @property
    def predictors(self) -> dict[str, Predictor]:
        return self._plane.predictors

    @property
    def _banks(self) -> dict[tuple[str, ...], _BankEntry]:
        return self._plane.banks

    @property
    def bank_generation(self) -> int:
        """Monotone counter of atomic calibration publishes."""
        return self._plane.generation

    # ------------------------------------------------------------------ control
    def deploy(self, spec: PredictorSpec,
               model_factories: Mapping[str, Callable[[], Any]],
               model_costs: Mapping[str, float] | None = None) -> Predictor:
        pred = deploy_predictor(spec, self.pool, model_factories, model_costs,
                                device=self.device)
        with self._control_lock:
            plane = self._plane
            # an in-place redeploy changes served parameters under an
            # existing name, so it must bump the generation; first-time
            # deploys leave the counter alone.  (Cached banks pinned to the
            # dead pipeline fail the identity check and rebuild lazily.)
            gen = plane.generation + (1 if spec.name in plane.predictors
                                      else 0)
            predictors = dict(plane.predictors)
            predictors[spec.name] = pred
            self._plane = dataclasses.replace(plane, predictors=predictors,
                                              generation=gen)
            self.metrics["bank_generation"] = gen
        return pred

    def decommission(self, name: str) -> None:
        with self._control_lock:
            plane = self._plane
            predictors = dict(plane.predictors)
            pred = predictors.pop(name)
            # drop cached banks referencing the dead predictor's pipeline;
            # dict() first: a concurrent dispatch stage may lazily insert a
            # cache entry mid-iteration.  The generation bumps so a later
            # deploy under the same name cannot reuse an already-used stamp.
            banks = {k: v for k, v in dict(plane.banks).items()
                     if name not in k}
            gen = plane.generation + 1
            self._plane = dataclasses.replace(plane, predictors=predictors,
                                              banks=banks, generation=gen)
            self.metrics["bank_generation"] = gen
        pred.release(self.pool)
        # and its estimator streams: a predictor redeployed under the same
        # name has a different score distribution
        with self._estimator_lock:
            self._estimators = {k: v for k, v in self._estimators.items()
                                if k[1] != name}

    def publish_routing(self, table: RoutingTable) -> None:
        """Atomic routing swap — the transparent model switching primitive."""
        missing = [n for n in table.referenced_predictors()
                   if n not in self.predictors]
        if missing:
            raise KeyError(f"routing references undeployed predictors: {missing}")
        self.routing = table

    def swap_transformation(self, predictor_name: str, qm: QuantileMap) -> None:
        """T^Q_v0 -> T^Q_v1 without touching models (Sec. 3.1)."""
        self.publish_quantile_maps({predictor_name: qm})

    def publish_quantile_maps(self, updates: Mapping[str, QuantileMap],
                              *, generation: int | None = None) -> int:
        """Atomically publish refreshed T^Q maps for MANY predictors at once.

        Every updated predictor pipeline AND every affected model-group bank
        is rebuilt first, then the whole control plane is swapped in one
        reference assignment under a bumped generation.  A dispatch stage
        that already snapshotted the old plane finishes on the old
        parameters; the next stage sees the complete new generation.

        ``generation`` is the fleet fencing hook: when given, the publish
        lands under exactly that generation and is REJECTED with
        :class:`StaleGenerationError` unless it is strictly newer than the
        current one.  A fenced publish also re-stamps every cached bank
        (touched or not) to the fleet generation, and an EMPTY fenced
        publish fast-forwards a lagging replica without changing maps.

        Returns the new bank generation.
        """
        with self._control_lock:
            return self._publish_quantile_maps_locked(updates, generation)

    def _publish_quantile_maps_locked(self, updates: Mapping[str, QuantileMap],
                                      generation: int | None = None) -> int:
        plane = self._plane
        missing = [n for n in updates if n not in plane.predictors]
        if missing:
            raise KeyError(f"unknown predictors: {missing}")
        if generation is None:
            if not updates:
                return plane.generation
            gen = plane.generation + 1
        else:
            # generation fencing: only strictly-forward fleet publishes land
            if generation <= plane.generation:
                raise StaleGenerationError(generation, plane.generation)
            gen = generation

        new_predictors = dict(plane.predictors)
        for name, qm in updates.items():
            pred = new_predictors[name]
            new_predictors[name] = pred.with_updated_pipeline(
                pred.pipeline.with_quantile_map(qm))

        new_banks: dict[tuple[str, ...], _BankEntry] = {}
        # dict() first: a dispatch stage on another thread may lazily insert
        # a bank-cache entry mid-iteration
        for key, entry in dict(plane.banks).items():
            touched = {i: updates[n] for i, n in enumerate(key) if n in updates}
            if not touched:
                if generation is None:
                    new_banks[key] = entry
                else:
                    # fenced publish: even untouched banks re-stamp to the
                    # fleet generation
                    new_banks[key] = _BankEntry(
                        entry.pipelines,
                        entry.bank.with_rows({}, generation=gen))
                continue
            pipelines = tuple(new_predictors[n].pipeline for n in key)
            # the with_rows fast path (scatter only the refreshed T^Q rows)
            # is sound only if the cached bank was built from the predictors'
            # CURRENT pipelines; a predictor redeployed in place leaves a
            # stale entry whose other rows carry the dead pipeline's T^C/A
            entry_fresh = len(entry.pipelines) == len(key) and all(
                ep is plane.predictors[n].pipeline
                for ep, n in zip(entry.pipelines, key))
            bank = None
            if entry_fresh:
                try:
                    bank = entry.bank.with_rows(touched, generation=gen)
                except ValueError:
                    bank = None  # a table wider than the bank: rebuild
            if bank is None:
                bank = TransformBank.from_params(
                    [(p.betas, p.weights, p.src_quantiles, p.ref_quantiles)
                     for p in pipelines], generation=gen, device=self.device)
            new_banks[key] = _BankEntry(pipelines, bank)

        # the publish point: ONE whole-plane swap, never in-place edits
        self._plane = _ControlPlane(new_predictors, new_banks, gen)
        self.metrics["bank_generation"] = gen
        return gen

    # ------------------------------------------------------------------- data
    def _model_dim(self, pred: Predictor) -> int:
        dims = [h.metadata.get("feature_dim") for h in pred._handles]
        dims = [d for d in dims if d]
        return max(dims) if dims else 0

    def batch_key(self, intent: Intent) -> str:
        """Micro-batching key: the resolved predictor's model group.

        Requests from different tenants/predictors that share the same
        expert-model set batch together — one model call plus one banked
        kernel launch serves the whole window."""
        return self.group_key(self.routing.resolve(intent))

    def group_key(self, resolution) -> str:
        """``batch_key`` for an already-resolved intent."""
        return "+".join(self.predictors[resolution.live].model_names)

    def build_responses(self, requests, idxs: list[int],
                        pred_names: list[str], scores: np.ndarray,
                        raws: np.ndarray, bank: TransformBank,
                        routing_version: str, latency_ms: float
                        ) -> list[ScoringResponse]:
        """Assemble one window's responses.  Row ``j`` answers request
        ``requests[idxs[j]]``."""
        score_list = scores.tolist()
        raw_rows = np.atleast_2d(raws).tolist()
        return [
            ScoringResponse(
                request_id=requests[i].request_id,
                score=score_list[j],
                predictor=pred_names[j],
                routing_version=routing_version,
                latency_ms=latency_ms,
                raw_scores=tuple(raw_rows[j]),
                bank_generation=bank.generation,
            )
            for j, i in enumerate(idxs)
        ]

    def write_shadow_records(self, requests, idxs: list[int],
                             shadow_names: list[str], scores: np.ndarray,
                             raws: np.ndarray, routing_version: str) -> None:
        """Sink one shadow window's records."""
        score_list = scores.tolist()
        raw_rows = np.atleast_2d(raws).tolist()
        for j, i in enumerate(idxs):
            self.sink.write(ShadowRecord(
                request_id=requests[i].request_id,
                tenant=requests[i].intent.tenant,
                predictor=shadow_names[j],
                score=score_list[j],
                raw_scores=tuple(raw_rows[j]),
                routing_version=routing_version,
            ))
            self.bump_metric("shadow_evals")

    def _bank_for(self, names: tuple[str, ...],
                  plane: _ControlPlane | None = None) -> _BankEntry:
        """Build (or fetch) the stacked transform bank for these predictors.

        Cache entries pin the source pipelines; a ``publish_quantile_maps`` /
        redeploy replaces the pipeline object, failing the identity check
        and rebuilding the bank — banks never serve stale parameters.
        ``plane`` is the stage-time snapshot; lookups go through it so a
        concurrent publish can't produce a torn read."""
        plane = self._plane if plane is None else plane
        pipelines = tuple(plane.predictors[n].pipeline for n in names)
        cached = plane.banks.get(names)
        if cached is not None and len(cached.pipelines) == len(pipelines) \
                and all(a is b for a, b in zip(cached.pipelines, pipelines)):
            return cached
        bank = TransformBank.from_params(
            [(p.betas, p.weights, p.src_quantiles, p.ref_quantiles)
             for p in pipelines], generation=plane.generation,
            device=self.device)
        entry = _BankEntry(pipelines, bank)
        plane.banks[names] = entry
        return entry

    def score(self, request: ScoringRequest) -> ScoringResponse:
        return self.score_batch([request])[0]

    # ----------------------------------------------------- dispatch stages
    def run_models(self, requests: list[ScoringRequest], idxs: list[int],
                   pred_names: list[str],
                   raw_cache: dict[tuple[tuple[str, ...], int], np.ndarray]
                   | None = None,
                   plane: _ControlPlane | None = None) -> np.ndarray:
        """Stage 1 of a banked dispatch: execute the window's expert models.

        One model call per expert produces raw scores for the whole
        (possibly multi-predictor) window; ``pred_names[j]`` is the predictor
        for row ``j``.  ``raw_cache`` carries (model group, request index)
        -> raw-score rows across dispatches of one batch, so live and shadow
        windows sharing a model group run the experts once (shadow dedup).
        Returns the (B, K) raw-score matrix on the host.
        """
        plane = self._plane if plane is None else plane
        bank_names = tuple(sorted(set(pred_names)))
        pred0 = plane.predictors[bank_names[0]]
        group = pred0.model_names
        dim = self._model_dim(pred0) or len(requests[idxs[0]].features)
        rows: list[np.ndarray | None] = [None] * len(idxs)
        fresh = list(range(len(idxs)))
        if raw_cache is not None:
            fresh = []
            for j, i in enumerate(idxs):
                hit = raw_cache.get((group, i))
                if hit is None:
                    fresh.append(j)
                else:
                    rows[j] = hit
        if fresh:
            feats = self._window_features(requests, idxs, fresh, dim)
            pad = _shape_bucket(len(fresh)) - len(fresh)
            if pad:  # bucketed batch shape
                feats = np.concatenate(
                    [feats, np.zeros((pad,) + feats.shape[1:], np.float32)])
            computed = to_numpy(pred0.raw_scores(feats))[:len(fresh)]
            with self._metrics_lock:
                self.metrics["model_group_calls"] += 1
                self.metrics["model_calls"] += len(group)
            for r, j in enumerate(fresh):
                rows[j] = computed[r]
                if raw_cache is not None:
                    raw_cache[(group, idxs[j])] = computed[r]
        return np.stack(rows)                                # (B, K)

    def _window_features(self, requests, idxs: list[int], fresh: list[int],
                         dim: int) -> np.ndarray:
        """Assemble the (len(fresh), dim) model-input matrix.

        Fast path: when every row already carries >= dim features of the
        right dtype, ONE stack+slice replaces the per-row enrich calls.
        """
        try:
            feats = np.stack([requests[idxs[j]].features for j in fresh])
            if feats.dtype == np.float32 and feats.ndim == 2 \
                    and feats.shape[1] >= dim:
                return feats[:, :dim]
        except ValueError:
            pass  # ragged rows: fall through to per-row enrichment
        return np.stack([
            self.features.enrich(requests[idxs[j]].intent,
                                 requests[idxs[j]].features, dim)
            for j in fresh
        ])

    def _to_device(self, raws: np.ndarray, tenant_idx: np.ndarray
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """A window's (B, K) float32 scores and (B,) int32 ids on the device."""
        scores = torch.from_numpy(np.ascontiguousarray(raws, np.float32))
        idx = torch.from_numpy(np.ascontiguousarray(tenant_idx, np.int32))
        return scores.to(self.device), idx.to(self.device)

    def apply_transforms(self, raws: np.ndarray, pred_names: list[str],
                         plane: _ControlPlane | None = None
                         ) -> tuple[np.ndarray, TransformBank, np.ndarray]:
        """Stage 2: the whole window through ONE banked T^C/A/T^Q kernel.

        The bank is resolved from the stage-time ``plane`` snapshot — a
        calibration publish landing between stage 1 and stage 2 is picked up
        here wholesale (raw expert scores are generation-independent), and
        every row of the window scores under exactly one bank generation.
        Returns (scores, bank, tenant_idx); the bank's ``generation`` is the
        window's provenance stamp.
        """
        plane = self._plane if plane is None else plane
        bank_names = tuple(sorted(set(pred_names)))  # canonical cache key
        bank = self._bank_for(bank_names, plane).bank
        row_of = {n: r for r, n in enumerate(bank_names)}
        tenant_idx = np.asarray([row_of[n] for n in pred_names], np.int32)
        b = len(tenant_idx)
        pad = _shape_bucket(b) - b
        if pad:  # bucketed kernel shape, same reasoning as run_models
            kraws = np.concatenate(
                [raws, np.zeros((pad,) + raws.shape[1:], raws.dtype)])
            # edge-pad the tenant vector so an otherwise-uniform tail block
            # stays uniform (padded rows are sliced off)
            kidx = np.concatenate(
                [tenant_idx, np.full(pad, tenant_idx[-1], np.int32)])
        else:
            kraws, kidx = raws, tenant_idx
        scores_d, idx_d = self._to_device(kraws, kidx)
        if self.config.fused_kernel:
            scores = ops.score_pipeline_banked(
                scores_d, idx_d, bank.betas, bank.weights,
                bank.src_quantiles, bank.ref_quantiles)
            # skip-rate accounting on the UNPADDED tenant vector, with the
            # reference's blocking (see banked_skip_stats)
            stats = ops.banked_skip_stats(tenant_idx)
            with self._metrics_lock:
                self.metrics["skip_blocks_uniform"] += stats["uniform_blocks"]
                self.metrics["skip_blocks_total"] += stats["blocks"]
        else:
            scores = bank(scores_d, idx_d)
        self.bump_metric("kernel_dispatches")
        return to_numpy(scores)[:b], bank, tenant_idx

    def track(self, requests: list[ScoringRequest], idxs: list[int],
              pred_names: list[str], raws: np.ndarray, bank: TransformBank,
              tenant_idx: np.ndarray) -> None:
        """Stage 3: batched per-(tenant, predictor) reservoir updates.

        Tracks the T^Q INPUT distribution — the posterior-corrected weighted
        aggregate through the window's OWN bank snapshot; fitting a refreshed
        T^Q on raw means would mismatch the pipeline (the bug class the
        paper's Sec.-3.1 update avoids).
        """
        if not self.config.track_quantiles:
            return
        keys = [(requests[i].intent.tenant, pred_names[j])
                for j, i in enumerate(idxs)]
        agg = to_numpy(bank.pre_quantile(*self._to_device(raws, tenant_idx)))
        # one batched reservoir update per (tenant, predictor) stream
        with self._estimator_lock:
            self._update_streams(keys, agg)

    def _update_streams(self, keys: list[tuple[str, str]],
                        agg: np.ndarray) -> None:
        """Eager host tracking (caller holds ``_estimator_lock``): one
        batched reservoir update per stream present in the window."""
        by_stream: dict[tuple[str, str], list[int]] = {}
        for j, key in enumerate(keys):
            by_stream.setdefault(key, []).append(j)
        for key, rows in by_stream.items():
            self._stream_estimator(key).update(agg[rows])

    def _stream_estimator(self, key: tuple[str, str]
                          ) -> StreamingQuantileEstimator:
        """Get-or-create under ``_estimator_lock``."""
        est = self._estimators.get(key)
        if est is None:
            est = StreamingQuantileEstimator(
                self.config.quantile_capacity, seed=stream_seed(key),
                recent_capacity=self.config.recent_capacity)
            self._estimators[key] = est
        return est

    # -------------------------------------------------------- sync data path
    def score_batch(self, requests: list[ScoringRequest]) -> list[ScoringResponse]:
        """Scores a mixed-tenant batch: requests are grouped by model group
        (shared expert-model set); each group costs one model call per
        expert plus ONE tenant-indexed banked kernel launch, whatever mix of
        tenants and predictors the group contains.

        The three dispatch stages run back-to-back per group against ONE
        plane snapshot for the whole batch (live + shadows), so even a
        refresh landing mid-flight from another thread cannot mix
        generations.
        """
        plane = self._plane  # dispatch-time snapshot
        resolutions = [self.routing.resolve(r.intent) for r in requests]
        by_group: dict[tuple[str, ...], list[int]] = {}
        for i, res in enumerate(resolutions):
            key = plane.predictors[res.live].model_names
            by_group.setdefault(key, []).append(i)

        # per-call raw-score cache: (model group, request index) -> (K,) row.
        # Live and shadow dispatches sharing a model group reuse expert
        # outputs instead of re-running the models (shadow dedup).
        raw_cache: dict[tuple[tuple[str, ...], int], np.ndarray] = {}
        responses: list[ScoringResponse | None] = [None] * len(requests)
        for idxs in by_group.values():
            t0 = time.perf_counter()  # per-dispatch latency, not cumulative
            pred_names = [resolutions[i].live for i in idxs]
            raws = self.run_models(requests, idxs, pred_names, raw_cache,
                                   plane)
            scores, bank, tenant_idx = self.apply_transforms(
                raws, pred_names, plane)
            latency_ms = (time.perf_counter() - t0) * 1000.0
            built = self.build_responses(requests, idxs, pred_names, scores,
                                         raws, bank, self.routing.version,
                                         latency_ms)
            for i, resp in zip(idxs, built):
                responses[i] = resp
            self.track(requests, idxs, pred_names, raws, bank, tenant_idx)

        # shadow evaluations (never affect the response)
        self._run_shadows(requests, resolutions, raw_cache, plane)
        self.bump_metric("requests", len(requests))
        return responses  # type: ignore[return-value]

    def _run_shadows(self, requests, resolutions,
                     raw_cache: dict | None = None,
                     plane: _ControlPlane | None = None) -> None:
        # shadow rows are (request, shadow-predictor) pairs, grouped by the
        # shadow's model group and dispatched through the same staged path.
        # ``raw_cache`` carries the live dispatches' expert outputs: a shadow
        # sharing its request's live model group reuses them (no re-run).
        plane = self._plane if plane is None else plane
        by_group: dict[tuple[str, ...], tuple[list[int], list[str]]] = {}
        for i, res in enumerate(resolutions):
            for s in res.shadows:
                key = plane.predictors[s].model_names
                idxs, names = by_group.setdefault(key, ([], []))
                idxs.append(i)
                names.append(s)
        for idxs, shadow_names in by_group.values():
            raws = self.run_models(requests, idxs, shadow_names, raw_cache,
                                   plane)
            scores, _, _ = self.apply_transforms(raws, shadow_names, plane)
            self.write_shadow_records(requests, idxs, shadow_names, scores,
                                      raws, self.routing.version)

    # --------------------------------------------------------------- refresh
    def estimator_streams(self) -> dict[tuple[str, str],
                                        StreamingQuantileEstimator]:
        """Live (tenant, predictor) -> estimator map (control-plane view).

        Streams whose predictor has since been decommissioned are excluded —
        the calibration controller must never refit a dead pipeline.  The
        scan copies the dict first: the track stage may insert a stream for
        a newly seen (tenant, predictor) from another thread mid-scan."""
        return {k: est for k, est in dict(self._estimators).items()
                if k[1] in self.predictors}

    def calibration_ready(self, tenant: str, predictor: str) -> bool:
        """Eq. 5 gate: enough live events for a trustworthy custom T^Q?"""
        est = self._estimators.get((tenant, predictor))
        return est is not None and est.ready(
            self.config.refresh_alert_rate, self.config.refresh_rel_error
        )

    def fit_custom_quantile_map(self, tenant: str, predictor: str,
                                ref_quantiles, n_levels: int = 256) -> QuantileMap:
        """Refresh path: fit T^Q_v1 from the live (unlabeled) score stream."""
        est = self._estimators[(tenant, predictor)]
        levels = np.linspace(0.0, 1.0, n_levels)
        src = est.quantiles(levels)
        return QuantileMap(
            src_quantiles=torch.tensor(src, dtype=torch.float32,
                                       device=self.device),
            ref_quantiles=torch.tensor(to_numpy(ref_quantiles),
                                       dtype=torch.float32,
                                       device=self.device),
        )
