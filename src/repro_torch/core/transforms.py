"""Composable score transformations (paper Sec. 2.3), in PyTorch.

Three transformation nodes compose a predictor's post-model DAG:

  * :class:`PosteriorCorrection`  — ``T^C`` (Eq. 3), undoes undersampling bias.
  * :class:`Aggregation`          — ``A``, weighted average of calibrated experts.
  * :class:`QuantileMap`          — ``T^Q`` (Eq. 4), piecewise-linear CDF alignment.

The nodes are frozen dataclasses of tensors that live on one explicit
device.  A "seamless model update" replaces them under a stable routing
intent; nothing is edited in place, so a dispatch holding an old node (or an
old :class:`TransformBank`) keeps scoring on the parameters it snapshotted.
Functions compute on the device of their inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.device import to_numpy

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Posterior Correction (Eq. 3)
# ---------------------------------------------------------------------------

def posterior_correction(scores: Tensor, beta: Tensor | float) -> Tensor:
    """Eq. 3: ``T^C(y) = beta*y / (1 - (1-beta)*y)``.

    ``beta`` is the undersampling ratio of the majority (negative) class used
    when training the expert: ``beta = P(keep negative sample)``.  Scores are
    posterior probabilities in [0, 1].  The map is monotone, fixes 0 and 1,
    and is the exact analytical inverse of the prior shift introduced by
    undersampling (Dal Pozzolo et al., 2015).
    """
    scores = torch.as_tensor(scores)
    beta = torch.as_tensor(beta, dtype=scores.dtype, device=scores.device)
    return (beta * scores) / (1.0 - (1.0 - beta) * scores)


def posterior_correction_inverse(corrected: Tensor,
                                 beta: Tensor | float) -> Tensor:
    """Inverse of Eq. 3 — maps a true posterior back to the biased score.

    Used by the synthetic data pipeline to *induce* undersampling bias with a
    known ground truth, and in tests as the round-trip oracle.
    """
    corrected = torch.as_tensor(corrected)
    beta = torch.as_tensor(beta, dtype=corrected.dtype,
                           device=corrected.device)
    return corrected / (beta + (1.0 - beta) * corrected)


@dataclasses.dataclass(frozen=True)
class PosteriorCorrection:
    """Per-expert ``T^C_k`` node: carries the training undersampling ratio."""

    beta: Tensor  # scalar (or broadcastable) undersampling ratio in (0, 1]

    def __call__(self, scores: Tensor) -> Tensor:
        return posterior_correction(scores, self.beta)

    @staticmethod
    def identity() -> "PosteriorCorrection":
        # beta = 1.0 means "no undersampling" -> T^C is the identity map.
        return PosteriorCorrection(beta=torch.tensor(1.0, dtype=torch.float32))


# ---------------------------------------------------------------------------
# Ensemble aggregation (Sec. 2.3.2)
# ---------------------------------------------------------------------------

def _sum_k(x: Tensor) -> Tensor:
    """Sum over the last axis in k order, ((x_0 + x_1) + x_2) + ..., as the
    kernels sum.  ``torch.sum``'s order depends on the device: on CUDA it
    sums K = 3 as (x_0 + x_2) + x_1, which a steep T^Q segment can turn
    into more than the 2e-5 the kernel is held to."""
    total = x[..., 0]
    for e in range(1, x.shape[-1]):
        total = total + x[..., e]
    return total


@dataclasses.dataclass(frozen=True)
class Aggregation:
    """Weighted-average aggregation ``A`` over K calibrated expert scores.

    Weights are normalized at call time so that updating them (the paper's
    "lightweight model adaptation") never needs renormalization bookkeeping.
    """

    weights: Tensor  # (K,)

    def __call__(self, expert_scores: Tensor) -> Tensor:
        """``expert_scores``: (..., K) -> (...), weights and terms summed
        in k order, as the kernels sum them."""
        w = self.weights / _sum_k(self.weights)
        return _sum_k(expert_scores * w)

    @staticmethod
    def uniform(k: int) -> "Aggregation":
        return Aggregation(weights=torch.ones((k,), dtype=torch.float32))


# ---------------------------------------------------------------------------
# Quantile Mapping (Eq. 4)
# ---------------------------------------------------------------------------

def _unit_grid(n: int) -> Tensor:
    """``n`` evenly spaced float32 knots on [0, 1], bit for bit as
    ``jnp.linspace(0, 1, n, dtype=float32)`` gives them on the CPU: knot i
    is i times the float32 reciprocal of n - 1 (XLA turns the division by a
    constant into that product), and the last knot is 1.  ``torch.linspace``
    rounds differently: up to half the knots differ in the last bit."""
    if n < 2:
        return torch.zeros(n, dtype=torch.float32)
    step = float(np.float32(1.0) / np.float32(n - 1))
    steps = torch.arange(n - 1, dtype=torch.float32) * step
    return torch.cat([steps, torch.ones(1, dtype=torch.float32)])


def _knot_count(table: Tensor, values: Tensor) -> Tensor:
    """The exact count #{n : v >= table[n]}.  The count (not a binary
    search) fixes the bucket on ties, on unsorted tables and on NaN (no
    comparison holds -> count 0)."""
    return torch.sum(values[..., None] >= table, dim=-1)


def _bucket_index(count: Tensor, n: int) -> Tensor:
    """Index i s.t. table[i] <= v < table[i+1]: the knot count - 1, clamped
    to [0, N-2] so interpolation always has a right neighbour."""
    return torch.clamp(count - 1, 0, n - 2)


def _at_last_knot(out: Tensor, count: Tensor, n: int,
                  ref_last: Tensor) -> Tensor:
    """A value at or past every one of the ``n`` knots maps to exactly the
    last reference knot, as the kernels map it.  Interpolating the last
    segment there can round one ulp below it, where an edge-padded table
    (a flat segment) gives it exactly: with this, padding changes no bit at
    the last knot either.  NaN counts 0 and stays NaN.  The reference
    interpolates, so the two differ there by at most one ulp (more only
    where the last source segment is flat and its reference segment is
    not, where the reference's own padded and unpadded tables disagree)."""
    return torch.where(count == n, ref_last, out)


def _interpolate(x: Tensor, count: Tensor, n: int, q_s_i: Tensor,
                 q_s_n: Tensor, q_r_i: Tensor, q_r_n: Tensor, lo: Tensor,
                 hi: Tensor) -> Tensor:
    """T^Q of ``x`` in bucket [q_s_i, q_s_n] as the kernels compute it
    (``csrc/quantile_knots.cuh::interpolate``): the product before the
    division, ``q_r_i + ((x - q_s_i) * (q_r_n - q_r_i)) / denom``, then the
    last-knot rule and the clip to [lo, hi].  :func:`quantile_map` divides
    first, as the reference's oracle does; the two differ by an ulp."""
    diff = q_s_n - q_s_i
    denom = torch.where(diff > 0, diff, torch.ones_like(diff))
    out = q_r_i + (x - q_s_i) * (q_r_n - q_r_i) / denom
    out = _at_last_knot(out, count, n, hi)
    # torch.clamp propagates NaN, as jnp.clip does
    return torch.clamp(out, lo, hi)


def quantile_map(
    scores: Tensor,
    src_quantiles: Tensor,
    ref_quantiles: Tensor,
) -> Tensor:
    """Eq. 4: piecewise-linear map aligning CDF of S onto CDF of R.

    ``src_quantiles``/``ref_quantiles``: (N,) monotone non-decreasing arrays of
    matched quantiles q^S_i, q^R_i (same quantile levels).  The map is monotone
    (non-decreasing), hence rank/ROC preserving — the paper's key invariant.
    Values below q^S_1 are linearly extended from the first segment and
    clipped to the reference support; values at or past every knot map to
    exactly q^R_N (see :func:`_at_last_knot`).
    """
    scores = torch.as_tensor(scores)
    dtype = scores.dtype
    qs = src_quantiles.to(device=scores.device, dtype=dtype)
    qr = ref_quantiles.to(device=scores.device, dtype=dtype)
    n = qs.shape[-1]
    count = _knot_count(qs, scores)
    i = _bucket_index(count, n)
    q_s_i = qs[i]
    q_s_n = qs[i + 1]
    q_r_i = qr[i]
    q_r_n = qr[i + 1]
    # Guard degenerate (flat) source segments; slope first, as the reference.
    diff = q_s_n - q_s_i
    denom = torch.where(diff > 0, diff, torch.ones_like(diff))
    slope = (q_r_n - q_r_i) / denom
    out = q_r_i + (scores - q_s_i) * slope
    out = _at_last_knot(out, count, n, qr[-1])
    return torch.clamp(out, qr[0], qr[-1])


@dataclasses.dataclass(frozen=True)
class QuantileMap:
    """``T^Q`` node: tenant-specific source quantiles -> shared reference."""

    src_quantiles: Tensor  # (N,)
    ref_quantiles: Tensor  # (N,)

    def __call__(self, scores: Tensor) -> Tensor:
        return quantile_map(scores, self.src_quantiles, self.ref_quantiles)

    @property
    def num_quantiles(self) -> int:
        return self.src_quantiles.shape[-1]

    @staticmethod
    def identity(n: int = 64) -> "QuantileMap":
        q = _unit_grid(n)
        return QuantileMap(src_quantiles=q, ref_quantiles=q)

    @staticmethod
    def fit(
        source_scores: np.ndarray | Tensor,
        ref_quantiles: np.ndarray | Tensor,
        levels: np.ndarray | None = None,
    ) -> "QuantileMap":
        """Fit tenant-specific source quantiles from (unlabeled!) scores.

        This is the offline fitting path (Sec. 2.3.3): needs only raw score
        samples, no labels.  ``ref_quantiles`` must be evaluated at the same
        quantile ``levels`` (default: uniform grid of len(ref_quantiles)).
        The fit runs in float64 numpy on the host; the tables land on the
        device of ``ref_quantiles`` when it is a tensor, else on the CPU.
        """
        device = ref_quantiles.device \
            if isinstance(ref_quantiles, torch.Tensor) else None
        ref_q = to_numpy(ref_quantiles).astype(np.float64)
        n = ref_q.shape[-1]
        if levels is None:
            levels = np.linspace(0.0, 1.0, n)
        src = np.quantile(to_numpy(source_scores).astype(np.float64), levels)
        src = np.maximum.accumulate(src)  # enforce monotone vs fp jitter
        return QuantileMap(
            src_quantiles=torch.tensor(src, dtype=torch.float32, device=device),
            ref_quantiles=torch.tensor(ref_q, dtype=torch.float32,
                                       device=device),
        )


# ---------------------------------------------------------------------------
# Reference distributions (Sec. 2.3.3 / Sec. 7 of DESIGN.md)
# ---------------------------------------------------------------------------

def fraud_reference_quantiles(n: int = 256, *, a: float = 0.8, b: float = 8.0,
                              tail_w: float = 0.02, tail_a: float = 6.0,
                              tail_b: float = 1.5) -> Tensor:
    """A configurable reference distribution R with high density near 0 and a
    long tail toward 1 (the paper's guidance for imbalanced fraud settings:
    more resolution in the 0.1%–1% alert-rate region).

    Mixture: (1-tail_w)·Beta(a, b) + tail_w·Beta(tail_a, tail_b).
    Returns its quantiles on a uniform level grid, via numerical CDF inversion.
    """
    from scipy import stats  # offline path only

    levels = np.linspace(0.0, 1.0, n)
    grid = np.linspace(0.0, 1.0, 65537)
    cdf = (1.0 - tail_w) * stats.beta.cdf(grid, a, b) + tail_w * stats.beta.cdf(
        grid, tail_a, tail_b
    )
    q = np.interp(levels, cdf, grid)
    q = np.maximum.accumulate(q)
    return torch.tensor(q, dtype=torch.float32)


def uniform_reference_quantiles(n: int = 256) -> Tensor:
    return _unit_grid(n)


# ---------------------------------------------------------------------------
# Full Eq. 2 pipeline (reference composition; fused kernel in kernels/)
# ---------------------------------------------------------------------------

def score_pipeline(
    expert_scores: Tensor,
    betas: Tensor,
    weights: Tensor,
    src_quantiles: Tensor,
    ref_quantiles: Tensor,
) -> Tensor:
    """Eq. 2 end-to-end: ``T^Q(A([T^C_k(m_k(x))]))``.

    ``expert_scores``: (..., K) raw scores from the K experts.  Op for op
    :func:`banked_score_pipeline` on a one-row bank, and so the kernels'
    order: weights and terms summed in k order, T^Q by
    :func:`_interpolate`.
    """
    corrected = posterior_correction(expert_scores, betas)
    w = weights / _sum_k(weights)
    agg = _sum_k(corrected * w)
    qs = src_quantiles.to(device=agg.device, dtype=agg.dtype)
    qr = ref_quantiles.to(device=agg.device, dtype=agg.dtype)
    n = qs.shape[-1]
    count = _knot_count(qs, agg)
    i = _bucket_index(count, n)
    return _interpolate(agg, count, n, qs[i], qs[i + 1], qr[i], qr[i + 1],
                        qr[0], qr[-1])


def _pad_edge(x: Tensor, pad: int) -> Tensor:
    """Repeat the last knot ``pad`` times (``jnp.pad(mode="edge")``)."""
    return torch.cat([x, x[-1:].expand(pad)]) if pad else x


def pad_quantile_tables(
    value: "QuantileMap | tuple[Tensor, Tensor]", n: int, *,
    row: int | None = None,
) -> tuple[Tensor, Tensor]:
    """Normalize one replacement T^Q table pair to exactly ``n`` knots.

    ``value`` is a :class:`QuantileMap` or a raw ``(src, ref)`` pair.  Tables
    narrower than ``n`` are edge-padded: the extra flat segments are
    degenerate (guarded denominator in :func:`quantile_map`) and values past
    the true support already clip to the reference edge, so padding is
    semantics-preserving.  Wider tables, and a pair whose two tables differ
    in length, are a shape error (``ValueError``, as the reference's scatter
    raises for both).
    """
    src, ref = (value.src_quantiles, value.ref_quantiles) \
        if isinstance(value, QuantileMap) else value
    src = torch.as_tensor(src, dtype=torch.float32)
    ref = torch.as_tensor(ref, dtype=torch.float32)
    where = f"row {row}: " if row is not None else ""
    if src.shape != ref.shape:
        raise ValueError(f"{where}src {tuple(src.shape)} and ref "
                         f"{tuple(ref.shape)} tables differ in shape")
    pad = n - src.shape[-1]
    if pad < 0:
        raise ValueError(f"{where}{src.shape[-1]} knots > bank's {n}")
    return _pad_edge(src, pad), _pad_edge(ref, pad)


# ---------------------------------------------------------------------------
# Tenant-indexed transform bank (mixed-tenant batched Eq. 2)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TransformBank:
    """Stacked per-(tenant, predictor) transform parameters.

    One row per distinct post-model pipeline; a mixed-tenant micro-batch
    carries a per-row ``tenant_idx`` selecting its bank row, so the whole
    batch runs Eq. 2 in ONE dispatch (``kernels/score_pipeline.py::
    score_pipeline_banked``) instead of a Python loop of per-predictor calls.

    Banks are immutable and carry a ``generation``: the calibration control
    plane publishes a refreshed bank as a NEW object with a bumped generation
    and swaps the reference atomically.  In-flight dispatches that already
    snapshotted the old bank finish on the old parameters; the next window
    sees the new generation — never a torn mix of rows from two calibration
    versions.  No method writes into a bank's tensors.
    """

    betas: Tensor          # (T, K)
    weights: Tensor        # (T, K)
    src_quantiles: Tensor  # (T, N)
    ref_quantiles: Tensor  # (T, N)
    generation: int = 0

    @property
    def num_rows(self) -> int:
        return int(self.betas.shape[0])

    @property
    def num_experts(self) -> int:
        return int(self.betas.shape[-1])

    @property
    def num_quantiles(self) -> int:
        return int(self.src_quantiles.shape[-1])

    @property
    def device(self) -> torch.device:
        return self.betas.device

    def __call__(self, expert_scores: Tensor, tenant_idx: Tensor) -> Tensor:
        return banked_score_pipeline(
            expert_scores, tenant_idx, self.betas, self.weights,
            self.src_quantiles, self.ref_quantiles,
        )

    def pre_quantile(self, expert_scores: Tensor, tenant_idx: Tensor
                     ) -> Tensor:
        """Per-row T^Q input (corrected weighted aggregate) — what a
        refreshed T^Q must be fitted on; see TransformPipeline.pre_quantile."""
        return _banked_pre_quantile(expert_scores, tenant_idx, self.betas,
                                    self.weights)

    def with_rows(
        self,
        rows: Mapping[int, tuple[Tensor, Tensor]] | Mapping[int, "QuantileMap"],
        *,
        generation: int | None = None,
    ) -> "TransformBank":
        """Functional update: replace the T^Q tables of selected rows.

        ``rows`` maps row index -> ``QuantileMap`` (or a raw ``(src, ref)``
        pair).  Returns a NEW bank — the receiver is never mutated, so any
        dispatch holding it keeps scoring with the old parameters.  The
        scatter is the out-of-place ``index_copy``, which writes into a
        clone: an in-place scatter into a published bank would be a torn read
        for a window still scoring on it.  Tables narrower than the bank's N
        are edge-padded; wider tables are a shape error.  ``generation``
        defaults to the current one + 1.
        """
        if not rows:
            return self if generation is None else dataclasses.replace(
                self, generation=generation)
        n = self.num_quantiles
        idx, srcs, refs = [], [], []
        for row, value in sorted(rows.items()):
            if not 0 <= row < self.num_rows:
                raise IndexError(f"row {row} outside bank of {self.num_rows}")
            src, ref = pad_quantile_tables(value, n, row=row)
            idx.append(row)
            srcs.append(src.to(self.device))
            refs.append(ref.to(self.device))
        index = torch.tensor(idx, dtype=torch.long, device=self.device)
        return dataclasses.replace(
            self,
            src_quantiles=self.src_quantiles.index_copy(
                0, index, torch.stack(srcs)),
            ref_quantiles=self.ref_quantiles.index_copy(
                0, index, torch.stack(refs)),
            generation=self.generation + 1 if generation is None else generation,
        )

    @staticmethod
    def from_params(params: Sequence[tuple[Tensor, Tensor, Tensor, Tensor]],
                    *, generation: int = 0,
                    device: torch.device | str | None = None
                    ) -> "TransformBank":
        """Stack (betas, weights, src_q, ref_q) rows, padding ragged axes.

        Expert axes are padded with ``beta=1, weight=0`` columns (identity
        correction, zero aggregation mass).  Quantile tables are padded by
        repeating the last knot: the extra flat segments are degenerate
        (guarded denominator) and values past the true support already clip
        to the reference edge, so padding is semantics-preserving.  The bank
        lives on ``device`` (default: where the given tensors are).
        """
        if not params:
            raise ValueError("cannot build an empty TransformBank")

        def _f32(x):
            return torch.as_tensor(x, dtype=torch.float32, device=device)

        rows = [(torch.atleast_1d(_f32(b)), torch.atleast_1d(_f32(w)),
                 _f32(qs), _f32(qr)) for b, w, qs, qr in params]
        k_max = max(b.shape[-1] for b, _, _, _ in rows)
        n_max = max(qs.shape[-1] for _, _, qs, _ in rows)

        def _pad_k(x, fill):
            pad = k_max - x.shape[-1]
            return torch.cat([x, x.new_full((pad,), fill)]) if pad else x

        def _pad_n(x):
            return _pad_edge(x, n_max - x.shape[-1])

        return TransformBank(
            betas=torch.stack([_pad_k(b, 1.0) for b, _, _, _ in rows]),
            weights=torch.stack([_pad_k(w, 0.0) for _, w, _, _ in rows]),
            src_quantiles=torch.stack([_pad_n(qs) for _, _, qs, _ in rows]),
            ref_quantiles=torch.stack([_pad_n(qr) for _, _, _, qr in rows]),
            generation=generation,
        )


def _banked_pre_quantile(expert_scores: Tensor, tenant_idx: Tensor,
                         betas: Tensor, weights: Tensor) -> Tensor:
    """The corrected weighted aggregate of each row under its bank row,
    summed over K in k order as :func:`banked_score_pipeline` sums it.

    An id outside [0, T) raises ``IndexError`` (the gather checks it): the
    server forms ids from its own bank only, and the reference's
    ``pre_quantile`` gathers by ``jnp.take`` in its own way, so there is no
    out-of-range answer to match here.
    """
    tenant_idx = torch.as_tensor(tenant_idx, device=betas.device).long()
    b = betas.index_select(0, tenant_idx.reshape(-1)).reshape(
        tenant_idx.shape + betas.shape[-1:])          # (B, K)
    w = weights.index_select(0, tenant_idx.reshape(-1)).reshape(b.shape)
    corrected = posterior_correction(expert_scores, b)
    w = w / _sum_k(w)[..., None]
    return _sum_k(corrected * w)


def banked_score_pipeline(
    expert_scores: Tensor,
    tenant_idx: Tensor,
    betas: Tensor,
    weights: Tensor,
    src_quantiles: Tensor,
    ref_quantiles: Tensor,
) -> Tensor:
    """Mixed-tenant Eq. 2: row ``i`` uses parameter row ``tenant_idx[i]``.

    ``expert_scores``: (..., K); ``tenant_idx``: (...) int; bank params are
    (T, K) / (T, N).  Plain PyTorch — the reference for the banked CUDA
    kernel, op for op, its sums over K in k order on every device.
    Weights are normalized per row (so padded expert columns with weight 0
    contribute nothing).  A row whose id lies outside [0, T)
    scores NaN, as the CUDA kernel and the reference's Pallas kernel give
    (the reference's ``jnp.take`` oracle gives NaN for ids >= T but wraps
    negative ids); the other rows are untouched by it.
    """
    expert_scores = torch.as_tensor(expert_scores)
    tid = torch.as_tensor(tenant_idx, device=betas.device).long()
    outside = (tid < 0) | (tid >= betas.shape[0])
    # gather in range, then mask: the in-range rows are what they would be
    flat = tid.clamp(0, betas.shape[0] - 1).reshape(-1)

    def gather(table: Tensor) -> Tensor:
        return table.index_select(0, flat).reshape(
            tid.shape + table.shape[-1:])

    b = gather(betas)                                   # (..., K)
    w = gather(weights)                                 # (..., K)
    qs = gather(src_quantiles)                          # (..., N)
    qr = gather(ref_quantiles)                          # (..., N)
    corrected = posterior_correction(expert_scores, b)
    w = w / _sum_k(w)[..., None]
    agg = _sum_k(corrected * w)                         # (...)

    qs = qs.to(agg.dtype)
    qr = qr.to(agg.dtype)
    n = qs.shape[-1]
    count = _knot_count(qs, agg)
    i = _bucket_index(count, n)[..., None]
    q_s_i = torch.gather(qs, -1, i)[..., 0]
    q_s_n = torch.gather(qs, -1, i + 1)[..., 0]
    q_r_i = torch.gather(qr, -1, i)[..., 0]
    q_r_n = torch.gather(qr, -1, i + 1)[..., 0]
    out = _interpolate(agg, count, n, q_s_i, q_s_n, q_r_i, q_r_n,
                       qr[..., 0], qr[..., -1])
    return out.masked_fill(outside, float("nan"))


# ---------------------------------------------------------------------------
# Tenant-sharded transform bank (row partition over a "tenants" axis)
# ---------------------------------------------------------------------------

TENANT_AXIS = "tenants"  # axis name the bank rows are partitioned over


def shard_rows(num_rows: int, num_shards: int,
               shard_of: np.ndarray | None = None
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Row-partition rule shared by every sharded container.

    Assigns each of ``num_rows`` global rows an owning shard (default:
    round-robin ``t % S``, occupancy within one row of even) and a local
    id in global-row order within the shard.  Both
    :meth:`ShardedTransformBank.from_dense` and the tiered-over-sharded
    store (``serving/tiering.ShardedTieredBankStore``) derive their
    global<->local remaps from THIS function, so a hotness snapshot or a
    publish addressed by global row id lands on the same (shard, local)
    coordinates whichever container serves it.

    Returns ``(shard_of, local_of, row_counts)`` as int64 numpy arrays.
    """
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    assign = (np.arange(num_rows) % num_shards if shard_of is None
              else np.asarray(shard_of, np.int64).reshape(-1))
    if assign.shape[0] != num_rows:
        raise ValueError(
            f"shard_of has {assign.shape[0]} entries for {num_rows} rows")
    if assign.size and (assign.min() < 0 or assign.max() >= num_shards):
        raise ValueError("shard_of entries outside [0, num_shards)")
    counts = np.bincount(assign, minlength=num_shards).astype(np.int64)
    order = np.argsort(assign, kind="stable")
    starts = np.cumsum(counts) - counts
    local = np.empty(num_rows, np.int64)
    local[order] = np.arange(num_rows) - np.repeat(starts, counts)
    return assign, local, counts


class PlacementStack(NamedTuple):
    """One placement's rows of a sharded bank: (S/P, Tl, K) / (S/P, Tl, N)
    float32 stacks of its shards, on its device."""

    betas: Tensor
    weights: Tensor
    src_quantiles: Tensor
    ref_quantiles: Tensor


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedTransformBank:
    """A :class:`TransformBank` row-partitioned over a "tenants" axis.

    Parameter tensors carry a leading shard axis ((S, Tl, K) / (S, Tl, N),
    ``Tl`` = the largest shard's occupancy), so a shard's device holds ONLY
    its local rows (``per_shard_bytes`` ~ dense / S).  ``shard_of`` /
    ``local_of`` are the host-side (numpy) global<->local remap the serving
    layer buckets requests with; occupancy may be uneven and shards may be
    empty (rows beyond ``row_counts[s]`` are inert identity padding that no
    request selects).

    The shards fall in contiguous blocks over P placements (the tenant
    mesh's, ``launch/mesh.py``): ``stacks[p]`` holds shards ``p·S/P`` to
    ``(p+1)·S/P - 1`` on placement p's device, and no placement holds
    another's rows (``per_placement_bytes``).  The stacks are contiguous,
    so ``(S/P·Tl, ·)`` views of them are what one launch of the banked
    kernel a placement reads (``ShardedBankDispatcher``).  ``betas`` ...
    ``ref_quantiles`` are the whole (S, Tl, ·) stacks: with one placement
    its own tensors, with several a copy gathered on the first placement
    (inspection only; serving reads ``stacks``).

    Like the dense bank, a sharded bank is immutable and generation-stamped:
    ``with_rows`` scatters refreshed T^Q tables ONLY into each row's owning
    shard and returns a NEW object under one bumped generation, so a
    calibration publish swaps every shard's sub-bank in the same single
    control-plane assignment — per-shard generations can never diverge.
    """

    stacks: tuple[PlacementStack, ...]
    shard_of: np.ndarray   # (T,) owning shard per global bank row
    local_of: np.ndarray   # (T,) local row within the owning shard
    row_counts: np.ndarray  # (S,) occupied rows per shard
    generation: int = 0

    # ------------------------------------------------------------ geometry
    @property
    def num_placements(self) -> int:
        return len(self.stacks)

    @property
    def placements(self) -> tuple[torch.device, ...]:
        return tuple(st.betas.device for st in self.stacks)

    @property
    def shards_per_placement(self) -> int:
        return int(self.stacks[0].betas.shape[0])

    @property
    def num_shards(self) -> int:
        return self.shards_per_placement * self.num_placements

    @property
    def num_rows(self) -> int:
        return int(self.shard_of.shape[0])

    @property
    def rows_per_shard(self) -> int:
        return int(self.stacks[0].betas.shape[1])

    @property
    def num_experts(self) -> int:
        return int(self.stacks[0].betas.shape[-1])

    @property
    def num_quantiles(self) -> int:
        return int(self.stacks[0].src_quantiles.shape[-1])

    @property
    def device(self) -> torch.device:
        return self.stacks[0].betas.device

    @property
    def per_shard_bytes(self) -> int:
        """Bank bytes RESIDENT on one shard (the 1/S residency headline)."""
        tl, k, n = self.rows_per_shard, self.num_experts, self.num_quantiles
        return tl * (2 * k + 2 * n) * 4

    @property
    def per_placement_bytes(self) -> int:
        """Bank bytes resident on one placement: (S/P)·Tl·(2K+2N)·4."""
        return self.shards_per_placement * self.per_shard_bytes

    def _whole(self, field: int) -> Tensor:
        parts = [st[field] for st in self.stacks]
        if len(parts) == 1:
            return parts[0]
        return torch.cat([x.to(self.device) for x in parts])

    @property
    def betas(self) -> Tensor:              # (S, Tl, K)
        return self._whole(0)

    @property
    def weights(self) -> Tensor:            # (S, Tl, K)
        return self._whole(1)

    @property
    def src_quantiles(self) -> Tensor:      # (S, Tl, N)
        return self._whole(2)

    @property
    def ref_quantiles(self) -> Tensor:      # (S, Tl, N)
        return self._whole(3)

    def locate(self, tenant_idx) -> tuple[np.ndarray, np.ndarray]:
        """Global row ids -> (owning shard, local row) — the dispatch remap."""
        tid = np.asarray(to_numpy(tenant_idx), np.int64).reshape(-1)
        return self.shard_of[tid], self.local_of[tid]

    # --------------------------------------------------------- conversions
    @staticmethod
    def from_dense(bank: TransformBank, num_shards: int,
                   shard_of: np.ndarray | None = None,
                   placements: Sequence[torch.device | str] | None = None
                   ) -> "ShardedTransformBank":
        """Partition a dense bank's rows over ``num_shards`` shards.

        ``shard_of`` (optional, (T,)) assigns each global row an owning
        shard — any assignment is legal, including empty shards.  Default is
        round-robin (``t % S``).  Local ids are assigned in global-row order
        within each shard; shards are padded to the max occupancy with
        identity rows (beta=1, weight=1, the float32 ``np.linspace`` grid as
        both tables, bit for bit the reference's padding).  ``placements``
        (a tenant mesh's) puts each contiguous block of S/P shards straight
        on its device; the default is one placement, the dense bank's device.
        """
        devices = (bank.device,) if placements is None \
            else tuple(torch.device(d) for d in placements)
        if not devices or num_shards % len(devices):
            raise ValueError(f"{num_shards} shards do not split evenly over "
                             f"{len(devices)} placements")
        t = bank.num_rows
        assign, local, counts = shard_rows(t, num_shards, shard_of)
        tl = max(int(counts.max()) if counts.size else 0, 1)
        k, n = bank.num_experts, bank.num_quantiles

        betas = np.ones((num_shards, tl, k), np.float32)
        weights = np.ones((num_shards, tl, k), np.float32)
        ident = np.linspace(0.0, 1.0, n, dtype=np.float32)
        src = np.broadcast_to(ident, (num_shards, tl, n)).copy()
        ref = src.copy()
        betas[assign, local] = to_numpy(bank.betas)
        weights[assign, local] = to_numpy(bank.weights)
        src[assign, local] = to_numpy(bank.src_quantiles)
        ref[assign, local] = to_numpy(bank.ref_quantiles)
        per = num_shards // len(devices)
        return ShardedTransformBank(
            tuple(PlacementStack(*(torch.from_numpy(a[p * per:(p + 1) * per])
                                   .to(dev)
                                   for a in (betas, weights, src, ref)))
                  for p, dev in enumerate(devices)),
            shard_of=assign, local_of=local, row_counts=counts,
            generation=bank.generation)

    def shard_bank(self, shard: int) -> TransformBank:
        """The dense sub-bank one shard serves (its occupied local rows)."""
        c = max(int(self.row_counts[shard]), 1)  # empty: one inert row
        p, s = divmod(shard, self.shards_per_placement)
        st = self.stacks[p]
        return TransformBank(
            betas=st.betas[s, :c], weights=st.weights[s, :c],
            src_quantiles=st.src_quantiles[s, :c],
            ref_quantiles=st.ref_quantiles[s, :c],
            generation=self.generation)

    def to_dense(self) -> TransformBank:
        """Reassemble the global dense bank on the first placement
        (parity/inspection path)."""
        sh = torch.from_numpy(self.shard_of).to(self.device)
        lo = torch.from_numpy(self.local_of).to(self.device)
        return TransformBank(
            betas=self.betas[sh, lo], weights=self.weights[sh, lo],
            src_quantiles=self.src_quantiles[sh, lo],
            ref_quantiles=self.ref_quantiles[sh, lo],
            generation=self.generation)

    # ------------------------------------------------------------- updates
    def with_rows(
        self,
        rows: Mapping[int, tuple[Tensor, Tensor]] | Mapping[int, "QuantileMap"],
        *,
        generation: int | None = None,
    ) -> "ShardedTransformBank":
        """Functional T^Q update addressed by GLOBAL row id.

        Each replacement table is scattered only into its row's owning
        shard (one out-of-place ``index_put`` per table stack of the
        owning placement, at (shard, local)); every other row is carried
        over untouched, and a placement that owns none of the rows keeps
        its tensors (no copy, no upload).  Semantics otherwise match
        :meth:`TransformBank.with_rows` (edge-padding of narrow tables by
        :func:`pad_quantile_tables`, so the last-knot rule holds here too;
        generation defaulting to current + 1).
        """
        if not rows:
            return self if generation is None else dataclasses.replace(
                self, generation=generation)
        n = self.num_quantiles
        per = self.shards_per_placement
        touched: dict[int, tuple[list, list, list, list]] = {}
        for row, value in sorted(rows.items()):
            if not 0 <= row < self.num_rows:
                raise IndexError(f"row {row} outside bank of {self.num_rows}")
            src, ref = pad_quantile_tables(value, n, row=row)
            p, s = divmod(int(self.shard_of[row]), per)
            dev = self.stacks[p].betas.device
            s_idx, l_idx, srcs, refs = touched.setdefault(p, ([], [], [], []))
            s_idx.append(s)
            l_idx.append(int(self.local_of[row]))
            srcs.append(src.to(dev))
            refs.append(ref.to(dev))
        stacks = list(self.stacks)
        for p, (s_idx, l_idx, srcs, refs) in touched.items():
            st = stacks[p]
            dev = st.betas.device
            where = (torch.tensor(s_idx, dtype=torch.long, device=dev),
                     torch.tensor(l_idx, dtype=torch.long, device=dev))
            stacks[p] = st._replace(
                src_quantiles=st.src_quantiles.index_put(
                    where, torch.stack(srcs)),
                ref_quantiles=st.ref_quantiles.index_put(
                    where, torch.stack(refs)))
        return dataclasses.replace(
            self, stacks=tuple(stacks),
            generation=self.generation + 1 if generation is None else generation,
        )
