"""The card's timer and the least time the card could take for each kernel.

:func:`device_ms` times a call with CUDA events; :func:`host_ms` times a
call with the host clock (for a CPU run, which says nothing about the
card).  The bounds follow one rule: the larger of the bytes the function
must move (each input read once, each output written once) over the
card's memory rate, and its operations over the card's peak rate for their
type.  The rates are the published ones of an NVIDIA H100 SXM at its full
power limit; each bound returns ``(ms, "bytes" | "operations")``.
"""
from __future__ import annotations

import math
import statistics
import time

import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor cores
SLEEP_CYCLES = 20_000_000   # keeps the card busy while launches queue up


def device_ms(fn, *, reps: int = 20, inner: int = 50) -> float:
    """Median over ``reps`` of the card's time per call of ``fn``, from CUDA
    events around ``inner`` back-to-back calls queued behind a busy card
    (so the host's launch cost is not what is timed)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def host_ms(fn, *, reps: int = 3) -> float:
    """Median host milliseconds of one call of ``fn`` after one warm-up
    call; for CPU tensors, where the call returns when the work is done."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _bound(nbytes: float, ops: float, flops_per_s: float
           ) -> tuple[float, str]:
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / flops_per_s * 1e3
    if by_bytes >= by_ops:
        return by_bytes, "bytes"
    return by_ops, "operations"


def _tq_ops(n: int) -> int:
    """float32 operations of T^Q on one score against N knots: the exact
    bucket by a search over the sorted knots (ceil(log2 N) + 1 compares)
    and the interpolation and clip (10)."""
    return math.ceil(math.log2(n)) + 11


def quantile_map_bound(m: int, n: int, itemsize: int) -> tuple[float, str]:
    """T^Q of M scores against N-knot float32 tables: the scores read and
    the results written in their itemsize, the tables once, against
    M * (ceil(log2 N) + 11) float32 operations."""
    return _bound(2 * m * itemsize + 2 * n * 4, m * _tq_ops(n), F32_FLOPS)


def score_pipeline_bound(m: int, k: int, n: int, itemsize: int
                         ) -> tuple[float, str]:
    """Eq. 2 of M rows of K scores with one parameter set: the scores and
    results in their itemsize, (2K + 2N) float32 parameters once, against
    M * (9K + ceil(log2 N) + 11) float32 operations."""
    return _bound(m * k * itemsize + m * itemsize + (2 * k + 2 * n) * 4,
                  m * (9 * k + _tq_ops(n)), F32_FLOPS)


def banked_bound(m: int, k: int, t: int, n: int) -> tuple[float, str]:
    """The banked pipeline: float32 scores, int32 ids and float32 results,
    each read or written once, and the (T, 2K + 2N) bank once, against
    9K + ceil(log2 N) + 11 float32 operations a row."""
    return _bound(m * k * 4 + m * 4 + m * 4 + t * (2 * k + 2 * n) * 4,
                  m * (9 * k + _tq_ops(n)), F32_FLOPS)


def attention_bound(b, tq, tk, hq, hkv, d, causal, window, itemsize
                    ) -> tuple[float, str, float]:
    """Prefill attention: 4*D flops per visible (query, key) pair per query
    head over the peak rate of the inputs' type (bf16 tensor cores for
    2-byte items, float32 outside them for 4-byte), against q, k, v read
    once and o written once.  Returns (ms, bound_by, flops)."""
    qpos = torch.arange(tq)[:, None]
    kpos = torch.arange(tk)[None, :]
    mask = torch.ones(tq, tk, dtype=torch.bool)
    if causal:
        mask &= qpos >= kpos
    if window > 0:
        mask &= kpos > qpos - window
    flops = 4.0 * b * hq * d * int(mask.sum())
    nbytes = (2 * b * tq * hq * d + 2 * b * tk * hkv * d) * itemsize
    peak = F32_FLOPS if itemsize == 4 else BF16_FLOPS
    ms, by = _bound(nbytes, flops, peak)
    return ms, by, flops


def decode_bound(valid: list[int], hq: int, hkv: int, d: int, itemsize: int
                 ) -> tuple[float, str]:
    """Decode attention with ``valid[b]`` valid cache positions in row b
    (clamped to [0, S]): those rows of K and V read once, q read and o
    written once, the lengths once, against 4 * D * Hq flops a valid
    position over the bf16 tensor-core rate."""
    b, total = len(valid), sum(valid)
    nbytes = (2 * total * hkv * d + 2 * b * hq * d) * itemsize + 4 * b
    return _bound(nbytes, 4.0 * d * hq * total, BF16_FLOPS)
