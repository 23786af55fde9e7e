"""The card's timer and the least time the card could take for each kernel.

:func:`device_ms` times a call with CUDA events; :func:`host_ms` times a
call with the host clock (for a CPU run, which says nothing about the
card).  The bounds follow one rule: the larger of the bytes the function
must move (each input read once, each output written once) over the
card's memory rate, and its operations over the card's peak rate for their
type.  The rates are the published ones of an NVIDIA H100 SXM at its full
power limit; each bound returns ``(ms, "bytes" | "operations")``.  The
work behind a kernel's bound (its ``*_work``: operations and bytes) is also
what ``kernels/ops.py`` tallies when the kernel's wrapper is called on meta
tensors, so the dry-run (``launch/dryrun.py``) counts a kernel as its bound
does.
"""
from __future__ import annotations

import math
import statistics
import time

import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor cores
# special-function results (exp2 and kin) a second: 16 a clock an SM at
# compute capability 9.0 (CUDA C++ Programming Guide, arithmetic
# instruction throughput), 132 SMs at the 1.98 GHz behind F32_FLOPS
SFU_OPS = 132 * 16 * 1.98e9
# float32 instructions a second outside the tensor cores: 128 a clock an SM
# (F32_FLOPS counts each as a fused multiply-add, two FLOPs); the scan
# kernels build with -fmad=false, so each product and each sum is one
SCALAR_F32_OPS = 132 * 128 * 1.98e9
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


def quantile_map_work(m: int, n: int, itemsize: int) -> tuple[float, float]:
    """(operations, bytes) of T^Q on M scores against N-knot float32
    tables: the scores read and the results written in their itemsize, the
    tables once; M * (ceil(log2 N) + 11) float32 operations."""
    return float(m * _tq_ops(n)), float(2 * m * itemsize + 2 * n * 4)


def quantile_map_bound(m: int, n: int, itemsize: int) -> tuple[float, str]:
    """T^Q of M scores against N-knot float32 tables
    (:func:`quantile_map_work`) against the float32 rate."""
    ops, nbytes = quantile_map_work(m, n, itemsize)
    return _bound(nbytes, ops, F32_FLOPS)


def score_pipeline_work(m: int, k: int, n: int, itemsize: int
                        ) -> tuple[float, float]:
    """(operations, bytes) of Eq. 2 on M rows of K scores with one
    parameter set: the scores and results in their itemsize, (2K + 2N)
    float32 parameters once; M * (9K + ceil(log2 N) + 11) float32
    operations."""
    return (float(m * (9 * k + _tq_ops(n))),
            float(m * k * itemsize + m * itemsize + (2 * k + 2 * n) * 4))


def score_pipeline_bound(m: int, k: int, n: int, itemsize: int
                         ) -> tuple[float, str]:
    """Eq. 2 with one parameter set (:func:`score_pipeline_work`) against
    the float32 rate."""
    ops, nbytes = score_pipeline_work(m, k, n, itemsize)
    return _bound(nbytes, ops, F32_FLOPS)


def banked_work(m: int, k: int, t: int, n: int) -> tuple[float, float]:
    """(operations, bytes) of the banked pipeline: float32 scores, int32
    ids and float32 results, each read or written once, and the
    (T, 2K + 2N) bank once; 9K + ceil(log2 N) + 11 float32 operations a
    row."""
    return (float(m * (9 * k + _tq_ops(n))),
            float(m * k * 4 + m * 4 + m * 4 + t * (2 * k + 2 * n) * 4))


def banked_bound(m: int, k: int, t: int, n: int) -> tuple[float, str]:
    """The banked pipeline (:func:`banked_work`) against the float32
    rate."""
    ops, nbytes = banked_work(m, k, t, n)
    return _bound(nbytes, ops, F32_FLOPS)


def attention_pairs(tq: int, tk: int, causal: bool, window: int) -> int:
    """(query, key) pairs one query head sees, query i and key j counted
    from 0: j <= i when causal, j > i - window when windowed."""
    q = torch.arange(tq, dtype=torch.int64)
    hi = q.clamp(max=tk - 1) if causal else torch.full_like(q, tk - 1)
    lo = (q - window + 1).clamp(min=0) if window > 0 else torch.zeros_like(q)
    return int((hi - lo + 1).clamp(min=0).sum())


def attention_work(b, tq, tk, hq, hkv, d, causal, window, itemsize
                   ) -> tuple[float, float]:
    """(flops, bytes) of prefill attention: 4*D flops per visible (query,
    key) pair per query head, q, k, v read once and o written once."""
    flops = 4.0 * b * hq * d * attention_pairs(tq, tk, causal, window)
    nbytes = (2 * b * tq * hq * d + 2 * b * tk * hkv * d) * itemsize
    return flops, float(nbytes)


def attention_bound(b, tq, tk, hq, hkv, d, causal, window, itemsize
                    ) -> tuple[float, str, float]:
    """Prefill attention (:func:`attention_work`) over the peak rate of
    the inputs' type (bf16 tensor cores for 2-byte items, float32 outside
    them for 4-byte).  Returns (ms, bound_by, flops)."""
    flops, nbytes = attention_work(b, tq, tk, hq, hkv, d, causal, window,
                                   itemsize)
    peak = F32_FLOPS if itemsize == 4 else BF16_FLOPS
    ms, by = _bound(nbytes, flops, peak)
    return ms, by, flops


def decode_work(valid: list[int], hq: int, hkv: int, d: int, itemsize: int
                ) -> tuple[float, float]:
    """(flops, bytes) of decode attention with ``valid[b]`` valid cache
    positions in row b (clamped to [0, S]): those rows of K and V read
    once, q read and o written once, the lengths once; 4 * D * Hq flops a
    valid position."""
    b, total = len(valid), sum(valid)
    nbytes = (2 * total * hkv * d + 2 * b * hq * d) * itemsize + 4 * b
    return 4.0 * d * hq * total, float(nbytes)


def decode_bound(valid: list[int], hq: int, hkv: int, d: int, itemsize: int
                 ) -> tuple[float, str]:
    """Decode attention (:func:`decode_work`) over the bf16 tensor-core
    rate."""
    flops, nbytes = decode_work(valid, hq, hkv, d, itemsize)
    return _bound(nbytes, flops, BF16_FLOPS)


def _scan_bound(exps: int, ops: int, nbytes: int) -> tuple[float, str]:
    """The larger of the exponentials on the special-function units and
    the float32 operations (each its own instruction), against the
    bytes."""
    by_ops = max(exps / SFU_OPS, ops / SCALAR_F32_OPS) * 1e3
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if by_bytes >= by_ops:
        return by_bytes, "bytes"
    return by_ops, "operations"


def selective_scan_work(b: int, t: int, c: int, n: int, *,
                        h0: bool = False) -> tuple[int, int, int]:
    """(exponentials, float32 operations, bytes) of the Mamba scan of
    (B, T, C) float32 dt and x into y with N states a channel: dt and x
    read and y written once, (B, T, N) Bm and Cm and (C, N) A read once,
    h_T written (h0 read when given); one exponential per (b, t, c, n),
    and per (b, t, c, n) the decay's product, the input's, the state's
    product and sum, y's product and sum, per (b, t, c) dt * x."""
    nbytes = 4 * (3 * b * t * c + 2 * b * t * n + c * n
                  + (2 if h0 else 1) * b * c * n)
    exps = b * t * c * n
    return exps, 6 * exps + b * t * c, nbytes


def selective_scan_bound(b: int, t: int, c: int, n: int, *,
                         h0: bool = False) -> tuple[float, str]:
    """The Mamba scan (:func:`selective_scan_work`)."""
    return _scan_bound(*selective_scan_work(b, t, c, n, h0=h0))


def selective_scan_bwd_work(b: int, t: int, c: int, n: int, *,
                            dh_t: bool = False) -> tuple[int, int, int]:
    """(exponentials, float32 operations, bytes) of the Mamba scan's
    backward at (B, T, C) float32 with N states a channel: dt, x and dy
    read and ddt and dx written once, (B, T, N) Bm and Cm read and dBm and
    dCm written, (C, N) A read and dA written, dh_T read when given (the
    tile checkpoints the kernel reads are its own choice, and a dh0 it
    writes is not asked of training: neither counts); one exponential per
    (b, t, c, n), and the float32 operations of the gradients (per (b, t,
    c, n) g's product and sum, the dCm, dBm, du, q·A and dA terms each a
    product and a sum, q's two products and the carry's; per (b, t, c) u,
    ddt's product and sum and dx)."""
    nbytes = 4 * (5 * b * t * c + 4 * b * t * n + 2 * c * n
                  + (b * c * n if dh_t else 0))
    exps = b * t * c * n
    return exps, 16 * exps + 4 * b * t * c, nbytes


def selective_scan_bwd_bound(b: int, t: int, c: int, n: int, *,
                             dh_t: bool = False) -> tuple[float, str]:
    """The scan's backward (:func:`selective_scan_bwd_work`)."""
    return _scan_bound(*selective_scan_bwd_work(b, t, c, n, dh_t=dh_t))
