"""Async banked dispatch engine: stage-pipelined serving (ROADMAP item).

``ServerBatcher`` (the synchronous baseline) flushes a model-group window and
runs the whole banked dispatch — expert models, transform kernel, estimator
tracking — back-to-back on the caller's thread.  On mixed-tenant traffic
that serializes two expensive phases that have no data dependency across
windows: window *N*'s expert models could execute while window *N−1*'s raw
scores run through the banked transform kernel.

:class:`AsyncDispatchEngine` is that overlap made explicit.  It drives the
three stage methods the server exposes (``run_models`` /
``apply_transforms`` / ``track``) on three single-worker stage executors:

    submit ─► MicroBatcher ─► [models] ─► [transforms] ─► [track]
                 window N+1     window N     window N−1      window N−2

Each executor is a one-thread FIFO, so windows flow through every stage in
launch order (per-key response order == submission order) while DIFFERENT
stages of consecutive windows run concurrently — XLA executions release the
GIL, so model execution genuinely overlaps the banked kernel.

Consistency model (the "epoch-safe" part):

* Every stage reads served state through ONE ``server.plane`` snapshot — a
  mutually consistent (predictors, banks, generation) triple, because every
  control-plane operation swaps the whole plane in a single reference
  assignment.  A window whose transform stage snapshotted generation *g*
  scores ALL of its rows under *g*; the next window picks up *g+1* — no
  torn reads, with or without a concurrent publisher thread.
* ``schedule_refresh`` enqueues a ``CalibrationController.refresh_fleet``
  pass on the track executor: it runs BETWEEN stage boundaries, serialized
  with the estimator-reservoir updates it reads, while the model/transform
  stages keep streaming.  Each scheduled control operation bumps the
  engine's ``epoch`` counter, stamped into the returned ``RefreshResult``.
* ``poll()`` is self-scheduling: ``start()`` arms a timer that flushes
  aged-out windows and re-arms itself — no external serving loop needed.
* ``drain()`` is a real barrier: it flushes everything pending, then pushes
  a sentinel through each stage executor in pipeline order, so on return
  every window submitted before the drain has fully cleared all three
  stages (and its futures are resolved).
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable

import numpy as np

from repro_torch.serving.batching import MicroBatcher
from repro_torch.serving.types import ScoringRequest, ScoringResponse


@dataclasses.dataclass
class _Window:
    """One flushed model-group window travelling through the stage pipeline."""

    key: str
    requests: list[ScoringRequest]
    pred_names: list[str]                      # live predictor per row
    shadow_jobs: list[tuple[list[int], list[str]]]
    futures: list[Future | None]     # None for submit_many (drain-collected)
    routing_version: str
    t0: float = 0.0                            # dispatch start (models stage)
    raws: np.ndarray | None = None
    shadow_raws: list[np.ndarray] = dataclasses.field(default_factory=list)
    raw_cache: dict = dataclasses.field(default_factory=dict)
    error: BaseException | None = None


class AsyncDispatchEngine:
    """Event-loop driver pipelining the server's banked dispatch stages.

    Duck-types the server interface the rollout layer needs
    (``score_batch``) so a :class:`~repro_torch.serving.rollout.Replica` can serve
    through an engine transparently.

    ``clock`` feeds the internal :class:`MicroBatcher` (injectable for
    deterministic age-flush tests); ``poll_interval_ms`` defaults to half
    the window age limit.
    """

    def __init__(self, server: Any, *, max_batch: int = 64,
                 max_wait_ms: float = 2.0,
                 poll_interval_ms: float | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 batcher: MicroBatcher | None = None,
                 adaptive_batch_cap: int | None = None,
                 facade_timeout_s: float = 120.0) -> None:
        """``adaptive_batch_cap``: enable dynamic window growth.  When the
        key's model stage is still busy with the previous window, a full
        ``max_batch`` window is NOT dispatched immediately — arrivals keep
        accumulating and the next dispatch takes the whole backlog as ONE
        window (bounded by the cap).  Arrival is decoupled from dispatch —
        the adaptive batching a synchronous batcher cannot do — so a
        backlogged pipeline amortizes per-window model/kernel dispatch
        costs instead of queueing fixed-size windows.  None = fixed-size
        windows (default).

        ``facade_timeout_s`` bounds each future wait inside the
        ``score_batch`` facade — a wedged stage surfaces as a loud timeout
        instead of hanging the caller forever, and slower lanes (the
        8-device sharded CI pass first runs uncompiled shard_map windows)
        can widen it without patching the wait sites."""
        self.server = server
        if adaptive_batch_cap is not None and adaptive_batch_cap < max_batch:
            raise ValueError("adaptive_batch_cap must be >= max_batch")
        self._facade_timeout_s = facade_timeout_s
        self._base_batch = max_batch
        self._adaptive = adaptive_batch_cap is not None
        self._cap = adaptive_batch_cap or max_batch
        self.batcher = batcher if batcher is not None else MicroBatcher(
            max_batch=self._cap, max_wait_ms=max_wait_ms, clock=clock)
        self._inflight_models: dict[str, int] = {}
        self._poll_interval_s = (
            (poll_interval_ms if poll_interval_ms is not None
             else self.batcher.max_wait_ms / 2.0) / 1000.0)
        self._lock = threading.Lock()
        # model stage: ONE single-worker executor PER model group — windows
        # of the same key stay FIFO (ordering guarantee) while independent
        # expert groups overlap on separate cores (their executables share
        # nothing).  Transform + track stay global single-workers: the bank
        # path and the estimator reservoirs are serialized by construction.
        self._models: dict[str, ThreadPoolExecutor] = {}
        self._transforms = ThreadPoolExecutor(
            1, thread_name_prefix="muse-transforms")
        self._track = ThreadPoolExecutor(1, thread_name_prefix="muse-track")
        # submit-time metadata keyed by request identity (FIFO per object,
        # so resubmitting the same request object is still well-defined);
        # the future slot is None for submit_many (drain-collected)
        self._meta: dict[int, list[tuple[Future | None, Any]]] = {}
        self._completed: list[ScoringResponse] = []
        self.completed_dropped = 0   # evictions from an un-drained buffer
        # stage failures, newest-last (windows whose futures carry the same
        # exception; submit_many windows have no futures, so this list is
        # the ONLY place a bulk-ingestion caller can see a dropped window)
        self.errors: list[tuple[str, BaseException]] = []
        # real faults raised by the anti-stall prefetch hook (bad tenant id,
        # torn store ref, ...).  Prefetch is best-effort so these never kill
        # a poll tick or a window, but silently eating them turns a real bug
        # into an invisible throughput cliff (every window pays the cold
        # stall the prefetch was meant to hide) — so they are counted here
        # and appended to ``errors``.  Expected benign races (the window
        # dispatched or the predictor undeployed between collection and
        # prefetch -> KeyError) are NOT counted.
        self.prefetch_errors = 0
        # poll-tick failures (exceptions escaping poll(); the tick chain
        # survives them — see _poll_tick) and track-stage failures (the
        # stage must never kill serving, but a recurring fault would
        # otherwise be an invisible calibration-freshness cliff)
        self.tick_errors = 0
        self.track_errors = 0
        self.window_log: list[dict] = []       # per-window dispatch records
        self._epoch = 0
        self._running = False
        self._closed = False
        self._poll_timer: threading.Timer | None = None
        # tiered-store anti-stall prefetch (serving/tiering.py): servers
        # that page cold bank rows from host memory expose
        # ``prefetch_transforms``; the engine stages pending windows' rows
        # into the victim cache before their transform stage dispatches
        self._prefetchable = bool(getattr(server, "prefetch_enabled", False))

    # ------------------------------------------------------------- lifecycle
    @property
    def epoch(self) -> int:
        """Count of control-plane operations applied at stage boundaries."""
        return self._epoch

    @property
    def pending_count(self) -> int:
        return self.batcher.pending_count

    def start(self) -> "AsyncDispatchEngine":
        """Arm the self-scheduling poll timer (idempotent)."""
        with self._lock:
            if self._running or self._closed:
                return self
            self._running = True
        self._arm_poll()
        return self

    def _arm_poll(self) -> None:
        # armed UNDER the lock: checking _running/_closed outside it raced
        # with close() — close could cancel the already-fired timer and
        # then lose to this re-arm, leaving a live timer polling into
        # shut-down executors.  Holding the lock across check + start makes
        # cancel-then-never-rearm atomic with close's _closed flip.
        with self._lock:
            if not self._running or self._closed:
                return
            t = threading.Timer(self._poll_interval_s, self._poll_tick)
            t.daemon = True
            self._poll_timer = t
            t.start()

    def _poll_tick(self) -> None:
        # try/finally: an exception escaping poll() must not silently kill
        # the re-arm chain (the engine would stop flushing aged windows
        # with no visible signal) — it is counted instead
        try:
            self.poll()
        except BaseException as e:  # noqa: BLE001 — surface via metric
            with self._lock:
                self.tick_errors += 1
                self.errors.append(("poll", e))
                if len(self.errors) > 256:
                    del self.errors[:128]
        finally:
            self._arm_poll()     # poll reschedules itself

    def close(self, timeout: float | None = 30.0) -> list[ScoringResponse]:
        """Stop polling, drain every in-flight window, shut the stages down.

        Returns the responses completed since the last ``take_completed``.
        """
        with self._lock:
            if self._closed:
                return []
            self._closed = True
            self._running = False
            if self._poll_timer is not None:
                self._poll_timer.cancel()
        out = self.drain(timeout=timeout)
        for pool in self._models.values():
            pool.shutdown(wait=True)
        self._transforms.shutdown(wait=True)
        self._track.shutdown(wait=True)
        return out

    def __enter__(self) -> "AsyncDispatchEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # ---------------------------------------------------------------- intake
    def submit(self, request: ScoringRequest) -> Future:
        """Enqueue one request; returns a Future[ScoringResponse].

        The future resolves when the request's window clears the transform
        stage (responses never wait on estimator tracking).
        """
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("engine is closed")
            res = self.server.routing.resolve(request.intent)
            key = self.server.group_key(res)
            self._meta.setdefault(id(request), []).append((fut, res))
            batch = self.batcher.add(key, request) or self._take_ready(key)
            if batch:
                self._launch_locked(self._build_window(key, batch))
        return fut

    def _take_ready(self, key: str) -> list[ScoringRequest]:
        """Adaptive dispatch decision (caller holds the lock): flush once
        the base window size is reached AND the key's model stage is idle;
        while it is busy, keep accumulating (the batcher caps the growth).
        Window sizes are quantized to base·2^k ≤ cap so the serving shapes
        stay bounded (one XLA specialization per growth step, not one per
        arbitrary backlog length)."""
        if not self._adaptive or self._inflight_models.get(key):
            return []
        n = self.batcher.pending_for(key)
        if n < self._base_batch:
            return []
        size = self._base_batch
        while size * 2 <= min(n, self._cap):
            size *= 2
        return self.batcher.take(key, size)

    def submit_many(self, requests: list[ScoringRequest]) -> None:
        """Bulk ingestion: enqueue a request stream without per-request
        futures (responses are collected via ``drain``/``take_completed``).

        One lock acquisition and no Future/metadata churn per request —
        the per-request Python of ``submit`` is what contends with the
        stage threads at high offered load.
        """
        it = iter(requests)
        while True:
            chunk = list(itertools.islice(it, 64))
            if not chunk:
                break
            # chunked lock scope: the stages start consuming while the rest
            # of the stream is still being enqueued
            with self._lock:
                if self._closed:
                    raise RuntimeError("engine is closed")
                resolve = self.server.routing.resolve
                group_key = self.server.group_key
                for request in chunk:
                    res = resolve(request.intent)
                    key = group_key(res)
                    self._meta.setdefault(id(request), []).append((None, res))
                    batch = self.batcher.add(key, request) \
                        or self._take_ready(key)
                    if batch:
                        self._launch_locked(self._build_window(key, batch))

    def poll(self) -> int:
        """Flush aged-out windows into the pipeline; returns windows launched.

        Safe to call manually, but ``start()`` makes it self-scheduling."""
        pending: list[tuple[str, list[str]]] = []
        with self._lock:
            if self._closed:
                # a tick that fired just before close() finished must not
                # launch windows into draining/shut-down executors
                return 0
            n = 0
            for key, batch in self.batcher.expired():
                self._launch_locked(self._build_window(key, batch))
                n += 1
            if self._prefetchable:
                # still-accumulating windows: collect their live predictor
                # names under the lock, prefetch OUTSIDE it (a host->device
                # row copy must not block submitters)
                for key in self.batcher.pending_keys():
                    names = []
                    for req in self.batcher.peek(key):
                        meta = self._meta.get(id(req))
                        if meta:
                            names.append(meta[0][1].live)
                    if names:
                        pending.append((key, names))
        for key, names in pending:
            try:
                # create=False: speculative pending contents only warm
                # stores that already exist (a window may never dispatch
                # with exactly this predictor subset)
                self.server.prefetch_transforms(names, create=False)
            except KeyError:
                # expected race: the window dispatched / the predictor was
                # undeployed between the locked collection above and this
                # call — the names no longer resolve; nothing to warm
                continue
            except Exception as e:  # noqa: BLE001 — must never kill poll
                self._note_prefetch_error(key, e)
        return n

    def flush(self) -> int:
        """Force every pending window (full or not) into the pipeline."""
        with self._lock:
            n = 0
            for key, batch in self.batcher.flush_all():
                self._launch_locked(self._build_window(key, batch))
                n += 1
        return n

    def _launch_locked(self, win: _Window) -> None:
        """Enqueue a window on its key's model lane (caller holds the lock).

        Take-from-batcher and pool-enqueue happen under ONE lock hold: two
        launcher threads (submitter, poll timer, backlog pickup) can never
        invert same-key windows, so the per-key FIFO guarantee is real."""
        pool = self._models.get(win.key)
        if pool is None:
            pool = self._models.setdefault(win.key, ThreadPoolExecutor(
                1, thread_name_prefix=f"muse-models-{len(self._models)}"))
        self._inflight_models[win.key] = \
            self._inflight_models.get(win.key, 0) + 1
        pool.submit(self._model_stage, win)

    def drain(self, timeout: float | None = 30.0) -> list[ScoringResponse]:
        """Flush + barrier: block until all prior windows clear every stage.

        The stage executors are single-worker FIFOs and each stage enqueues
        the next, so sentinels pushed in pipeline order prove quiescence.
        Returns (and clears) the completed-response buffer.
        """
        self.flush()
        pools = list(self._models.values()) + [self._transforms, self._track]
        for pool in pools:
            pool.submit(lambda: None).result(timeout=timeout)
        return self.take_completed()

    def take_completed(self) -> list[ScoringResponse]:
        """Pop responses completed so far (transform-stage completion order)."""
        with self._lock:
            out = self._completed
            self._completed = []
        return out

    def score_batch(self, requests: list[ScoringRequest]
                    ) -> list[ScoringResponse]:
        """Synchronous facade (Replica duck-type): submit, flush, await.

        Windows formed from ``requests`` still pipeline across the stage
        executors; the call returns when every response future resolves.
        NOTE: the flush also releases other callers' partial windows.
        """
        futs = [self.submit(r) for r in requests]
        self.flush()
        responses = [f.result(timeout=self._facade_timeout_s) for f in futs]
        # this call consumed its responses via futures — drop them from the
        # drain buffer, or a long-lived facade-only replica leaks memory
        ids = {r.request_id for r in responses}
        with self._lock:
            self._completed = [r for r in self._completed
                               if r.request_id not in ids]
        return responses

    # ---------------------------------------------------------- control ops
    def schedule_control(self, fn: Callable[[], Any]) -> Future:
        """Run ``fn`` at the next stage boundary; returns Future[fn()].

        The generic control-plane entry point: ``fn`` executes on the track
        executor, serialized with estimator-reservoir updates and between
        windows, while the model/transform stages keep streaming.  Each
        scheduled operation bumps the engine ``epoch``.  The fleet
        calibration plane uses this to land fenced
        ``publish_quantile_maps(..., generation=...)`` swaps on
        engine-backed replicas so no in-flight window straddles the swap.
        """
        fut: Future = Future()

        def op() -> None:
            try:
                with self._lock:
                    self._epoch += 1
                fut.set_result(fn())
            except BaseException as e:  # noqa: BLE001 — surface via future
                fut.set_exception(e)

        self._track.submit(op)
        return fut

    def schedule_refresh(self, controller: Any,
                         only: "set[tuple[str, str]] | None" = None) -> Future:
        """Schedule ``controller.refresh_fleet`` at the next stage boundary.

        A :meth:`schedule_control` wrapper that stamps the engine epoch into
        the refresh: serialized with the estimator-reservoir updates the
        refit reads, while model/transform stages keep streaming.  In-flight
        windows finish on their snapshotted generation; the next transform
        stage picks up the published one.  Returns a Future[RefreshResult].
        """
        fut: Future = Future()

        def op() -> None:
            try:
                with self._lock:
                    self._epoch += 1
                    epoch = self._epoch
                fut.set_result(controller.refresh_fleet(only, epoch=epoch))
            except BaseException as e:  # noqa: BLE001 — surface via future
                fut.set_exception(e)

        self._track.submit(op)
        return fut

    # --------------------------------------------------------------- stages
    def _build_window(self, key: str, batch: list[ScoringRequest]) -> _Window:
        """Assemble a window from a flushed batch (caller holds the lock)."""
        futures, pred_names = [], []
        shadow_groups: dict[tuple[str, ...], tuple[list[int], list[str]]] = {}
        predictors = self.server.predictors
        for i, req in enumerate(batch):
            fut, res = self._meta[id(req)].pop(0)
            if not self._meta[id(req)]:
                del self._meta[id(req)]
            futures.append(fut)
            pred_names.append(res.live)
            for s in res.shadows:
                gkey = predictors[s].model_names
                idxs, names = shadow_groups.setdefault(gkey, ([], []))
                idxs.append(i)
                names.append(s)
        return _Window(
            key=key, requests=batch, pred_names=pred_names,
            shadow_jobs=list(shadow_groups.values()), futures=futures,
            routing_version=self.server.routing.version)

    def _note_prefetch_error(self, key: str, exc: BaseException) -> None:
        """Record a non-race prefetch fault: the window still dispatches
        (it just pays the cold-miss stall the prefetch would have hidden),
        so nothing fails a future — but the fault is counted and kept in
        ``errors`` so a recurring bug is visible instead of a silent
        throughput cliff."""
        with self._lock:
            self.prefetch_errors += 1
            self.errors.append((key, exc))
            if len(self.errors) > 256:
                del self.errors[:128]

    def _fail(self, win: _Window, exc: BaseException) -> None:
        with self._lock:
            self.errors.append((win.key, exc))
            if len(self.errors) > 256:
                del self.errors[:128]
        for fut in win.futures:
            if fut is not None and not fut.done():
                fut.set_exception(exc)

    def _model_stage(self, win: _Window) -> None:
        """Stage 1: expert-model execution (live + shadow groups)."""
        try:
            win.t0 = time.perf_counter()
            plane = self.server.plane           # per-STAGE snapshot
            idxs = list(range(len(win.requests)))
            win.raws = self.server.run_models(
                win.requests, idxs, win.pred_names, win.raw_cache, plane)
            for s_idxs, s_names in win.shadow_jobs:
                win.shadow_raws.append(self.server.run_models(
                    win.requests, s_idxs, s_names, win.raw_cache, plane))
            if self._prefetchable:
                # this window's transform stage is next: stage its cold bank
                # rows NOW, overlapped with the previous window's kernel
                # (create=True — the names-tuple is exactly what the
                # transform stage will dispatch with)
                try:
                    self.server.prefetch_transforms(
                        win.pred_names, plane, create=True)
                except KeyError:
                    # expected race: a predictor in this window was
                    # undeployed after the stage-time plane snapshot —
                    # the transform stage below resolves against a fresh
                    # plane and fails (or serves) on its own terms
                    pass
                except Exception as e:  # noqa: BLE001 — best-effort warm-up
                    self._note_prefetch_error(win.key, e)
        except BaseException as e:  # noqa: BLE001 — deliver via futures
            win.error = e
        self._transforms.submit(self._transform_stage, win)
        # adaptive backlog pickup: the model lane is free again — take the
        # (quantized) backlog accumulated for this key as ONE window
        with self._lock:
            self._inflight_models[win.key] -= 1
            if not self._closed:
                batch = self._take_ready(win.key)
                if batch:
                    self._launch_locked(self._build_window(win.key, batch))

    def _transform_stage(self, win: _Window) -> None:
        """Stage 2: banked kernel + response delivery (live + shadows)."""
        if win.error is not None:
            self._fail(win, win.error)
            return
        try:
            plane = self.server.plane           # fresh per-STAGE snapshot
            scores, bank, tenant_idx = self.server.apply_transforms(
                win.raws, win.pred_names, plane)
            latency_ms = (time.perf_counter() - win.t0) * 1000.0
            responses = self.server.build_responses(
                win.requests, list(range(len(win.requests))), win.pred_names,
                scores, win.raws, bank, win.routing_version, latency_ms)
            for (s_idxs, s_names), s_raws in zip(win.shadow_jobs,
                                                 win.shadow_raws):
                s_scores, _, _ = self.server.apply_transforms(
                    s_raws, s_names, plane)
                self.server.write_shadow_records(
                    win.requests, s_idxs, s_names, s_scores, s_raws,
                    win.routing_version)
            self.server.bump_metric("requests", len(win.requests))
            with self._lock:
                self._completed.extend(responses)
                # bound an un-drained buffer (a futures-only caller that
                # never drains must not leak); evictions are counted
                if len(self._completed) > 65536:
                    drop = len(self._completed) - 65536
                    del self._completed[:drop]
                    self.completed_dropped += drop
                self.window_log.append({
                    "key": win.key, "size": len(win.requests),
                    "latency_ms": latency_ms,
                    "bank_generation": bank.generation})
                if len(self.window_log) > 8192:  # bound long-running growth
                    del self.window_log[:4096]
            for fut, resp in zip(win.futures, responses):
                if fut is not None:
                    fut.set_result(resp)
            self._track.submit(self._track_stage, win, bank, tenant_idx)
        except BaseException as e:  # noqa: BLE001 — deliver via futures
            self._fail(win, e)

    def _track_stage(self, win: _Window, bank, tenant_idx) -> None:
        """Stage 3: estimator-reservoir updates (a stage behind responses)."""
        try:
            self.server.track(win.requests, list(range(len(win.requests))),
                              win.pred_names, win.raws, bank, tenant_idx)
        except BaseException as e:  # noqa: BLE001 — must never kill serving
            # counted + kept in errors: a recurring track fault silently
            # starves calibration of samples (the refresh gate never opens)
            with self._lock:
                self.track_errors += 1
                self.errors.append((win.key, e))
                if len(self.errors) > 256:
                    del self.errors[:128]
