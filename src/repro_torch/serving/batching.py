"""Micro-batching: group in-flight requests per model group.

The serving layer is stateless (paper design principle #1); the batcher is a
per-replica, in-memory accumulation window.  Requests are grouped by the
*model group* of their resolved live predictor (``MuseServer.batch_key``) —
NOT per predictor — so one accumulated window spans every tenant/predictor
that shares an expert-model set, and its flush lands in
``MuseServer.score_batch``'s banked path as a single model executable call
plus a single tenant-indexed kernel dispatch (multi-tenancy & reuse,
principle #2).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable

from repro_torch.serving.types import ScoringRequest, ScoringResponse


@dataclasses.dataclass
class MicroBatcher:
    """Accumulates requests; flushes per-key when size or age limits hit.

    ``clock`` is injectable so ``expired()``-based flushes are testable
    without sleeps; the default is ``time.monotonic`` — wall-clock
    adjustments must never age (or un-age) a window.
    """

    max_batch: int = 64
    max_wait_ms: float = 2.0
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self) -> None:
        self._pending: dict[str, list[ScoringRequest]] = collections.defaultdict(list)
        self._oldest: dict[str, float] = {}

    def add(self, key: str, request: ScoringRequest) -> list[ScoringRequest] | None:
        """Returns a full batch to execute, or None if still accumulating."""
        pending = self._pending[key]
        if not pending:
            self._oldest[key] = self.clock()
        pending.append(request)
        if len(pending) >= self.max_batch:
            return self._take(key)
        return None

    def expired(self) -> list[tuple[str, list[ScoringRequest]]]:
        """All (key, batch) pairs whose window has aged out."""
        now = self.clock()
        out = []
        for key, t0 in list(self._oldest.items()):
            if (now - t0) * 1000.0 >= self.max_wait_ms and self._pending[key]:
                out.append((key, self._take(key)))
        return out

    def flush_all(self) -> list[tuple[str, list[ScoringRequest]]]:
        return [(k, self._take(k)) for k in list(self._pending) if self._pending[k]]

    def pending_for(self, key: str) -> int:
        return len(self._pending.get(key, ()))

    def pending_keys(self) -> list[str]:
        """Keys with a non-empty accumulating window (snapshot)."""
        return [k for k, v in self._pending.items() if v]

    def peek(self, key: str) -> list[ScoringRequest]:
        """Copy of one key's accumulating window WITHOUT flushing it.

        The async engine's prefetch pass reads pending window contents to
        stage cold tenant-bank rows before the window dispatches; peeking
        must not consume the window or touch its age clock."""
        return list(self._pending.get(key, ()))

    def take(self, key: str, n: int | None = None) -> list[ScoringRequest]:
        """Flush one key's pending window, or its first ``n`` requests.

        Used by the async engine's adaptive batching: when the model stage
        is backlogged the engine defers the flush and later takes the
        accumulated backlog in one (size-quantized) window.  A partial take
        keeps the key's age clock unchanged — the remainder is OLDER than a
        fresh window, so it must not be rejuvenated."""
        pending = self._pending.get(key)
        if not pending:
            return []
        if n is None or n >= len(pending):
            return self._take(key)
        batch, self._pending[key] = pending[:n], pending[n:]
        return batch

    def _take(self, key: str) -> list[ScoringRequest]:
        batch = self._pending[key]
        self._pending[key] = []
        self._oldest.pop(key, None)
        return batch

    @property
    def pending_count(self) -> int:
        return sum(len(v) for v in self._pending.values())


@dataclasses.dataclass
class ServerBatcher:
    """Glue between :class:`MicroBatcher` and the server's banked data path.

    Keys every request by ``server.batch_key`` (the resolved predictor's
    model group) and flushes full or aged-out windows straight into
    ``server.score_batch`` — which scores each window with one banked kernel
    dispatch regardless of how many tenants it mixes.

    This is the SYNCHRONOUS driver: a flush runs the whole dispatch (models,
    transform kernel, tracking) on the caller's thread before returning.
    ``serving/engine.py::AsyncDispatchEngine`` pipelines the same stages
    across windows instead — use it when throughput matters.

    ``server`` is any object with ``batch_key(intent)`` and
    ``score_batch(requests)`` (duck-typed to avoid a serving<->server import
    cycle).
    """

    server: Any
    batcher: MicroBatcher = dataclasses.field(default_factory=MicroBatcher)

    def submit(self, request: ScoringRequest) -> list[ScoringResponse] | None:
        """Enqueue; returns responses if this request filled its window."""
        key = self.server.batch_key(request.intent)
        batch = self.batcher.add(key, request)
        if batch is not None:
            return self.server.score_batch(batch)
        return None

    def poll(self) -> list[ScoringResponse]:
        """Flush aged-out windows (call from the serving loop's timer)."""
        out: list[ScoringResponse] = []
        for _, batch in self.batcher.expired():
            out.extend(self.server.score_batch(batch))
        return out

    def drain(self) -> list[ScoringResponse]:
        """Flush everything pending (shutdown / test epilogue)."""
        out: list[ScoringResponse] = []
        for _, batch in self.batcher.flush_all():
            out.extend(self.server.score_batch(batch))
        return out

    @property
    def pending_count(self) -> int:
        return self.batcher.pending_count
