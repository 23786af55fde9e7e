"""Quantile estimation machinery + the Appendix-A sample-size bound.

Two estimation paths:
  * Offline batch fit (``np.quantile``) — used when enough history exists.
  * Streaming reservoir estimator — the serving layer feeds live scores into
    it per (tenant, predictor) pair; once ``required_sample_size`` is met the
    control plane can trigger a transformation refresh (the paper's
    "Automated Calibration Refresh" roadmap item, implemented here).

Mergeable sketches (the fleet-calibration reduction)
----------------------------------------------------

:meth:`StreamingQuantileEstimator.merge` /
:meth:`StreamingQuantileEstimator.merge_checkpoints` reduce per-replica
estimator states into ONE estimator equivalent (up to the bound below) to an
estimator that watched the concatenation of every replica's stream.  The
fleet calibration plane (``serving/calibration.py``) pulls each replica's
exact checkpoint (reservoir + recent ring), merges per
(tenant, predictor), and fits T^Q once on the merged view.

**Merge accuracy bound.**  Each retained sample of part *i* represents
``seen_i / retained_i`` stream elements; when the union of retained samples
exceeds the merged capacity, a weighted subsample without replacement
(Efraimidis–Spirakis keys) keeps the merged reservoir an approximately
uniform sample of the concatenated stream.  Every uniform-subsampling stage
of size *n* contributes at most ``c(δ) / sqrt(n)`` rank (level-space) error
with probability ≥ 1 − δ, where ``c(δ) = sqrt(ln(2/δ) / 2)`` (the DKW
inequality); stages compose additively.  :func:`merge_rank_error_bound`
evaluates the bound and the property tests in ``tests/test_quantiles.py``
assert merged-vs-concatenated fits against it.  Merged ``count`` is exactly
the sum of part counts — associative and commutative — so the Eq.-5 gate
sees the union of what every replica saw.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Sequence

import numpy as np


def merge_rank_error_bound(*stage_sizes: int, delta: float = 1e-3) -> float:
    """Worst-case rank (level-space) error of a multi-stage uniform subsample.

    ``stage_sizes`` lists the size of every subsampling stage between the
    concatenated stream and the final reservoir (per-part reservoirs, the
    merge subsample, a comparison estimator's own reservoir, ...).  Each
    stage of size ``n`` contributes ``sqrt(ln(2/delta) / 2) / sqrt(n)``
    (DKW, confidence 1 − delta per stage); the stages add.
    """
    c = math.sqrt(math.log(2.0 / delta) / 2.0)
    return float(sum(c / math.sqrt(n) for n in stage_sizes if n > 0))


def required_sample_size(alert_rate: float, rel_error: float, z: float = 1.96) -> int:
    """Eq. 5 / Eq. 14: ``n = z^2 (1-a) / (delta^2 a)``.

    Minimum number of unlabeled score samples so the realized alert rate at
    the fitted threshold deviates from the target ``a`` by at most ``delta``
    (relative), with confidence given by z (1.96 -> 95%).
    """
    if not 0.0 < alert_rate < 1.0:
        raise ValueError(f"alert_rate must be in (0,1), got {alert_rate}")
    if rel_error <= 0.0:
        raise ValueError(f"rel_error must be > 0, got {rel_error}")
    return int(np.ceil(z * z * (1.0 - alert_rate) / (rel_error * rel_error * alert_rate)))


def alert_rate_rel_error(alert_rate: float, n: int, z: float = 1.96) -> float:
    """Inverse of Eq. 5: achievable relative error for a given sample budget."""
    return float(z * np.sqrt((1.0 - alert_rate) / (n * alert_rate)))


@dataclasses.dataclass
class StreamingQuantileEstimator:
    """Fixed-size uniform reservoir over a score stream.

    Simple, unbiased, and adequate at MUSE scale: the Appendix-A bound for
    a=0.1% alert rate at delta=20% needs ~96k samples, which a 128k reservoir
    holds exactly until overflow, after which uniform reservoir sampling keeps
    an unbiased subsample.  (P2/t-digest would use less memory; a reservoir is
    exact for the bins we need and trivially correct.)
    """

    capacity: int = 131072
    seed: int = 0
    # ring of the newest samples, independent of reservoir acceptance: the
    # calibration controller validates refit candidates against this window,
    # so a distribution shift AFTER the reservoir filled (which uniform
    # sampling dilutes almost invisibly) still fails support coverage
    recent_capacity: int = 4096

    def __post_init__(self) -> None:
        self._buf = np.empty((self.capacity,), dtype=np.float64)
        self._recent = np.empty((self.recent_capacity,), dtype=np.float64)
        self._recent_pos = 0   # explicit ring pointer (bulk writes reset it)
        self._seen = 0
        # live slot counts: equal to min(seen, capacity) for a purely
        # streamed estimator, but a MERGED estimator may hold fewer retained
        # samples than its count implies (parts already subsampled), so the
        # live prefixes are tracked explicitly
        self._filled = 0
        self._recent_filled = 0
        self._rng = np.random.default_rng(self.seed)

    @property
    def count(self) -> int:
        return self._seen

    def update(self, scores: np.ndarray) -> None:
        scores = np.asarray(scores, dtype=np.float64).ravel()
        # ceil division: floor allowed chunks up to 131071 — double the
        # documented 65536 bound (array_split over k parts caps each at
        # ceil(n / k), so k must be ceil(n / 65536))
        for chunk in np.array_split(scores, max(1, -(-len(scores) // 65536))):
            self._update_chunk(chunk)

    def apply_chunks(self, chunks: list[np.ndarray]) -> None:
        """Device-backed materialization hook: replay staged samples with
        one ``update`` call per ORIGINAL tracking window.

        State after a sequence of updates depends on the sample values AND
        the update-call boundaries (the recent ring bulk-resets on windows
        >= its capacity; the reservoir RNG draws once per overflow batch),
        so a device tracker that staged several windows must replay them as
        the separate calls they were — that is what makes its drained state
        bitwise-identical to eager tracking (see
        ``kernels/quantile_track.py``), not merely statistically equal."""
        for chunk in chunks:
            self.update(chunk)

    def _update_chunk(self, scores: np.ndarray) -> None:
        k = len(scores)
        if k == 0:
            return
        rc = self.recent_capacity
        if k >= rc:
            self._recent[:] = scores[-rc:]
            self._recent_pos = 0
            self._recent_filled = rc
        else:
            pos = (self._recent_pos + np.arange(k)) % rc
            self._recent[pos] = scores
            self._recent_pos = int((self._recent_pos + k) % rc)
            self._recent_filled = min(self._recent_filled + k, rc)
        fill = min(self.capacity - self._filled, k)
        if fill > 0:
            start = self._filled
            self._buf[start : start + fill] = scores[:fill]
            self._filled += fill
        rest = scores[fill:]
        if len(rest) > 0:
            # Vectorized reservoir: each element replaces a random slot with
            # probability capacity / (index seen so far).
            idx = self._seen + fill + np.arange(len(rest), dtype=np.int64) + 1
            accept = self._rng.random(len(rest)) < (self.capacity / idx)
            slots = self._rng.integers(0, self.capacity, size=len(rest))
            sel = np.flatnonzero(accept)
            self._buf[slots[sel]] = rest[sel]
        self._seen += k

    def quantiles(self, levels: np.ndarray) -> np.ndarray:
        if self._filled == 0:
            raise ValueError("no samples observed")
        data = self._buf[: self._filled]
        q = np.quantile(data, np.asarray(levels))
        return np.maximum.accumulate(q)

    def values(self) -> np.ndarray:
        """Read-only view of the retained (reservoir) samples."""
        view = self._buf[: self._filled]
        view.flags.writeable = False
        return view

    def recent(self) -> np.ndarray:
        """Read-only view of the newest ≤``recent_capacity`` samples
        (unordered).  Empty until the first update."""
        view = self._recent[: self._recent_filled]
        view.flags.writeable = False
        return view

    # ------------------------------------------------------------ merging
    def merge(self, *others: "StreamingQuantileEstimator"
              ) -> "StreamingQuantileEstimator":
        """Non-mutating reduction: a NEW estimator over the union of streams.

        See the module docstring for the accuracy bound; ``count`` of the
        result is exactly the sum of the parts' counts (associative and
        commutative), so the Eq.-5 gate evaluates the fleet-wide union.
        """
        return StreamingQuantileEstimator.merged((self, *others))

    @staticmethod
    def merged(parts: "Sequence[StreamingQuantileEstimator]"
               ) -> "StreamingQuantileEstimator":
        """Merge MANY estimators (the fleet reduction over replicas).

        Reservoir: the union of retained samples when it fits the merged
        capacity (exact — zero merge error); otherwise an Efraimidis–
        Spirakis weighted subsample without replacement, each part's samples
        weighted by ``seen_i / retained_i`` (the stream mass one retained
        sample represents).  Recent ring: the union of the parts' recent
        windows, uniformly subsampled to the merged ring capacity.  The
        merge seed derives from the (order-independent) multiset of part
        seeds/counts, so merging is deterministic given the parts.
        """
        parts = [p for p in parts]
        if not parts:
            raise ValueError("nothing to merge")
        cap = max(p.capacity for p in parts)
        rc = max(p.recent_capacity for p in parts)
        seed = zlib.crc32(repr(sorted(
            (p.seed, p.count, p.capacity) for p in parts)).encode())
        out = StreamingQuantileEstimator(capacity=cap, seed=seed,
                                         recent_capacity=rc)
        vals = [np.asarray(p.values(), np.float64) for p in parts]
        seens = [p.count for p in parts]
        retained = np.concatenate([v for v in vals if len(v)]) \
            if any(len(v) for v in vals) else np.empty(0, np.float64)
        if len(retained) <= cap:
            out._buf[: len(retained)] = retained
            out._filled = len(retained)
        else:
            # ES weighted subsample w/o replacement: key = log(u)/w, top-cap
            w = np.concatenate([np.full(len(v), s / len(v), np.float64)
                                for v, s in zip(vals, seens) if len(v)])
            keys = np.log(out._rng.random(len(retained))) / w
            sel = np.argpartition(-keys, cap - 1)[:cap]
            out._buf[:cap] = retained[sel]
            out._filled = cap
        out._seen = int(sum(seens))
        recents = [np.asarray(p.recent(), np.float64) for p in parts]
        pool = np.concatenate([r for r in recents if len(r)]) \
            if any(len(r) for r in recents) else np.empty(0, np.float64)
        if len(pool) > rc:
            pool = pool[out._rng.choice(len(pool), rc, replace=False)]
        out._recent[: len(pool)] = pool
        out._recent_filled = len(pool)
        out._recent_pos = int(len(pool) % rc)
        return out

    @staticmethod
    def merge_checkpoints(snapshots: Sequence[tuple[dict, dict]]
                          ) -> "StreamingQuantileEstimator":
        """Merge per-replica ``(checkpoint_arrays, checkpoint_meta)`` pairs.

        The fleet calibration plane's wire format IS the exact
        checkpoint serialization: each snapshot rebuilds bit-for-bit, then
        the estimators reduce through :meth:`merged`.
        """
        return StreamingQuantileEstimator.merged(
            [StreamingQuantileEstimator.from_checkpoint(a, m)
             for a, m in snapshots])

    def ready(self, alert_rate: float, rel_error: float, z: float = 1.96) -> bool:
        """Has this stream accumulated enough events for a trustworthy T^Q?"""
        return self._seen >= required_sample_size(alert_rate, rel_error, z)

    # ------------------------------------------------------- persistence
    def checkpoint_arrays(self) -> dict[str, np.ndarray]:
        """Array state for a checkpoint leaf dict (reservoir + recent ring).

        Full-capacity buffers are stored (not just the filled prefix) so the
        restore target has a static shape; ``checkpoint_meta`` records how
        much of each is live."""
        return {"buf": self._buf.copy(), "recent": self._recent.copy()}

    def checkpoint_meta(self) -> dict:
        """JSON-safe scalar state.  The RNG bit-generator state is reprd
        (its 128-bit PCG64 ints overflow orjson's 64-bit limit) so a
        restored estimator continues the SAME reservoir-acceptance sequence
        it would have run unsaved."""
        return {
            "capacity": int(self.capacity),
            "seed": int(self.seed),
            "recent_capacity": int(self.recent_capacity),
            "seen": int(self._seen),
            "recent_pos": int(self._recent_pos),
            # live prefixes: min(seen, capacity) for streamed estimators,
            # but smaller after a merge (parts had already subsampled)
            "filled": int(self._filled),
            "recent_filled": int(self._recent_filled),
            "rng_state": repr(self._rng.bit_generator.state),
        }

    @staticmethod
    def from_checkpoint(arrays: dict, meta: dict) -> "StreamingQuantileEstimator":
        """Rebuild an estimator from ``checkpoint_arrays``/``checkpoint_meta``.

        The round-trip is exact: reservoir samples, recent ring (+ pointer),
        observed count (so the Eq.-5 gate still passes), and RNG state all
        restore bit-for-bit — a surged replica starts warm."""
        import ast

        est = StreamingQuantileEstimator(
            capacity=int(meta["capacity"]), seed=int(meta["seed"]),
            recent_capacity=int(meta["recent_capacity"]))
        est._buf[:] = np.asarray(arrays["buf"], np.float64)
        est._recent[:] = np.asarray(arrays["recent"], np.float64)
        est._seen = int(meta["seen"])
        est._recent_pos = int(meta["recent_pos"])
        # pre-merge checkpoints carry no live-prefix keys: default to the
        # streamed invariant min(seen, capacity)
        est._filled = int(meta.get(
            "filled", min(est._seen, est.capacity)))
        est._recent_filled = int(meta.get(
            "recent_filled", min(est._seen, est.recent_capacity)))
        rng_state = meta.get("rng_state")
        if rng_state:
            est._rng.bit_generator.state = ast.literal_eval(rng_state)
        return est


def batch_sample_quantiles(
    samples: Sequence[np.ndarray],
    levels: np.ndarray,
) -> np.ndarray:
    """Quantiles of MANY sample sets in one vectorized pass -> (R, L).

    The fleet-wide calibration refresh refits every ready (tenant, predictor)
    stream at once.  Rows are padded with +inf into one (R, C_max) matrix,
    sorted with a single ``np.sort`` call (C-level, the padding tails sort
    last), and every row's quantile table comes from two vectorized
    ``take_along_axis`` gathers with linear interpolation against the row's
    OWN length — identical semantics to ``np.quantile(row, levels)``
    (method='linear') per row, without numpy's per-row ``nanquantile``
    Python loop.  Monotonicity is enforced per row (fp jitter guard, same
    as the scalar path).
    """
    levels = np.asarray(levels, np.float64)
    if not samples:
        return np.empty((0, len(levels)), np.float64)
    rows = [np.asarray(r, np.float64).ravel() for r in samples]
    lens = np.array([len(r) for r in rows], np.int64)
    if (lens == 0).any():
        raise ValueError("cannot refit a stream with no samples")
    mat = np.full((len(rows), int(lens.max())), np.inf, np.float64)
    for i, r in enumerate(rows):
        mat[i, : len(r)] = r
    mat.sort(axis=1)
    # np.quantile 'linear' method: position = level * (n - 1), per row
    pos = levels[None, :] * (lens[:, None] - 1).astype(np.float64)  # (R, L)
    lo = np.floor(pos).astype(np.int64)
    hi = np.ceil(pos).astype(np.int64)
    frac = pos - lo
    q_lo = np.take_along_axis(mat, lo, axis=1)
    q_hi = np.take_along_axis(mat, hi, axis=1)
    q = q_lo + (q_hi - q_lo) * frac                    # (R, L)
    return np.maximum.accumulate(q, axis=1)


def batch_quantiles(scores: np.ndarray, n_levels: int) -> tuple[np.ndarray, np.ndarray]:
    """Offline fit: (levels, quantiles) with monotonicity enforced."""
    levels = np.linspace(0.0, 1.0, n_levels)
    q = np.quantile(np.asarray(scores, dtype=np.float64), levels)
    return levels, np.maximum.accumulate(q)
