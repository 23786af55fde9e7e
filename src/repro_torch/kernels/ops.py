"""Public entry points of the port's kernels, dispatched by tensor device.

A CPU tensor runs the plain PyTorch version (``kernels/ref.py``); a CUDA
tensor launches the hand-written kernel, which raises on what it does not
take.  There is no switch and no fallback: a CUDA tensor never reaches the
plain version through this module.  The plain versions are torch ops, so
autograd differentiates them; of the kernels only the selective scan has a
backward (:class:`SelectiveScanFn`), and every other kernel raises when
grad mode is on and an input requires grad, rather than return a tensor
that cuts the gradient.

A meta tensor (``device="meta"``: shapes and dtypes, no data) launches
nothing: the wrapper returns empty meta tensors in the shapes and dtypes
its plain version returns and, inside :func:`meta_work`, tallies what the
kernel would do, by the formulas of its bound (``benchmarks/timing.py``).
That is how the dry-run (``launch/dryrun.py``) traces a step through the
kernel branch, as ``jax.eval_shape`` traces the reference's Pallas calls.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator

import torch

from repro_torch.benchmarks import timing
from repro_torch.kernels import _build, ref
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import quantile_map as _qm
from repro_torch.kernels import score_pipeline as _sp
from repro_torch.kernels import selective_scan as _ss

# launch counts of every hand-written kernel (the wrappers bump them)
LAUNCHES = _build.LAUNCHES

# the open meta_work tallies; a meta call adds to each
_TALLIES: list[dict[str, dict[str, float]]] = []


@contextlib.contextmanager
def meta_work() -> Iterator[dict[str, dict[str, float]]]:
    """A tally of the kernel calls made on meta tensors while it is open:
    kernel name -> {"calls", "flops", "bytes"}, the work of each call by
    the formulas of the kernel's bound.  A meta call bumps no
    :data:`LAUNCHES`."""
    tally: dict[str, dict[str, float]] = {}
    _TALLIES.append(tally)
    try:
        yield tally
    finally:
        _TALLIES.remove(tally)


def _meta(kernel: str, flops: float, nbytes: float, out):
    """Record one meta call of ``kernel`` in every open tally; returns
    ``out``."""
    for tally in _TALLIES:
        entry = tally.setdefault(kernel, {"calls": 0, "flops": 0.0,
                                          "bytes": 0.0})
        entry["calls"] += 1
        entry["flops"] += float(flops)
        entry["bytes"] += float(nbytes)
    return out


def quantile_map(scores: torch.Tensor, src_quantiles: torch.Tensor,
                 ref_quantiles: torch.Tensor) -> torch.Tensor:
    """T^Q (Eq. 4): scores of any shape against (N,) tables -> the same
    shape and dtype, float32 math.

    The reference's ``block`` and ``interpret`` are TPU tiling and Pallas
    knobs and are not carried over: the device of ``scores`` picks the
    implementation.
    """
    device = scores.device.type
    if device == "cpu":
        return ref.quantile_map(scores, src_quantiles, ref_quantiles)
    if device == "cuda":
        return _qm.quantile_map(scores, src_quantiles, ref_quantiles)
    if device == "meta":
        return _meta("quantile_map", *timing.quantile_map_work(
            scores.numel(), src_quantiles.shape[-1], scores.element_size()),
            torch.empty_like(scores,
                             memory_format=torch.contiguous_format))
    raise ValueError(f"no quantile_map for device {device!r}")


def score_pipeline(expert_scores: torch.Tensor, betas: torch.Tensor,
                   weights: torch.Tensor, src_quantiles: torch.Tensor,
                   ref_quantiles: torch.Tensor) -> torch.Tensor:
    """Eq. 2 with one shared parameter set: ``expert_scores`` (..., K),
    (K,) betas and weights, (N,) tables -> (...) in the scores' dtype.

    The reference's ``block`` and ``interpret`` are TPU tiling and Pallas
    knobs and are not carried over.
    """
    device = expert_scores.device.type
    if device == "cpu":
        return ref.score_pipeline(expert_scores, betas, weights,
                                  src_quantiles, ref_quantiles)
    if device == "cuda":
        return _sp.score_pipeline(expert_scores, betas, weights,
                                  src_quantiles, ref_quantiles)
    if device == "meta":
        *rows, k = expert_scores.shape
        return _meta("score_pipeline", *timing.score_pipeline_work(
            math.prod(rows), k, src_quantiles.shape[-1],
            expert_scores.element_size()),
            expert_scores.new_empty(rows))
    raise ValueError(f"no score_pipeline for device {device!r}")


def banked_skip_stats(tenant_idx, *, block: int = _sp.DEFAULT_BLOCK) -> dict:
    """Host-side uniform-block report for a tenant layout (see
    :func:`repro_torch.kernels.score_pipeline.banked_skip_stats`)."""
    return _sp.banked_skip_stats(tenant_idx, block=block)


def score_pipeline_banked(expert_scores: torch.Tensor,
                          tenant_idx: torch.Tensor, betas: torch.Tensor,
                          weights: torch.Tensor, src_quantiles: torch.Tensor,
                          ref_quantiles: torch.Tensor) -> torch.Tensor:
    """Mixed-tenant Eq. 2: ``expert_scores`` (..., K), ``tenant_idx`` (...)
    indexing the (T, K) / (T, N) banks -> (...) scores.  A row whose id
    lies outside [0, T) scores NaN.

    The ids are cast to int32 on both devices, as the reference's wrapper
    casts them (an integer of another width is taken modulo 2^32).
    """
    *batch_shape, k = expert_scores.shape
    flat = expert_scores.reshape(-1, k)
    if tenant_idx.is_floating_point() or tenant_idx.is_complex() \
            or tenant_idx.dtype == torch.bool:
        raise ValueError(f"tenant_idx: dtype {tenant_idx.dtype}, expected "
                         "an integer type")
    idx = tenant_idx.reshape(-1).to(torch.int32)
    if idx.shape[0] != flat.shape[0]:
        raise ValueError(f"tenant_idx has {idx.shape[0]} rows for "
                         f"{flat.shape[0]} score rows")
    device = expert_scores.device.type
    if device == "cpu":
        out = ref.score_pipeline_banked(flat, idx, betas, weights,
                                        src_quantiles, ref_quantiles)
    elif device == "cuda":
        out = _sp.score_pipeline_banked(flat, idx, betas, weights,
                                        src_quantiles, ref_quantiles)
    elif device == "meta":
        dtype = torch.promote_types(torch.promote_types(
            flat.dtype, betas.dtype), weights.dtype)
        out = _meta("score_pipeline_banked", *timing.banked_work(
            flat.shape[0], k, betas.shape[0], src_quantiles.shape[-1]),
            flat.new_empty(flat.shape[:1], dtype=dtype))
    else:
        raise ValueError(f"no score_pipeline_banked for device {device!r}")
    return out.reshape(batch_shape)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sliding_window: int = 0
                    ) -> torch.Tensor:
    """GQA attention, q: (B, Tq, Hq, D); k, v: (B, Tk, Hkv, D) ->
    (B, Tq, Hq, D) in q's dtype, causal and/or sliding-window.

    The reference's ``block_q``, ``block_k`` and ``interpret`` are TPU
    tiling and Pallas knobs and are not carried over: the CUDA kernel picks
    its own tiles, and the device of ``q`` picks the implementation.
    """
    device = q.device.type
    if device == "cpu":
        return ref.flash_attention(q, k, v, causal=causal,
                                   sliding_window=sliding_window)
    if device == "cuda":
        return _fa.flash_attention(q, k, v, causal=causal,
                                   sliding_window=sliding_window)
    if device == "meta":
        b, tq, hq, d = q.shape
        return _meta("flash_attention", *timing.attention_work(
            b, tq, k.shape[1], hq, k.shape[2], d, causal, sliding_window,
            q.element_size()),
            torch.empty_like(q, memory_format=torch.contiguous_format))
    raise ValueError(f"no flash_attention for device {device!r}")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid_len) -> torch.Tensor:
    """One query position against a KV cache: q (B, Hq, D), caches
    (B, S, Hkv, D), ``valid_len`` (B,) -> (B, Hq, D) in q's dtype.  On the
    card ``valid_len`` is an int32 CUDA tensor.

    The reference's ``block_s`` and ``interpret`` are TPU tiling and Pallas
    knobs and are not carried over: the CUDA kernel picks its own splits.
    """
    device = q.device.type
    if device == "cpu":
        return ref.decode_attention(q, k_cache, v_cache, valid_len)
    if device == "cuda":
        return _da.decode_attention(q, k_cache, v_cache, valid_len)
    if device == "meta":
        b, s = k_cache.shape[:2]
        if isinstance(valid_len, torch.Tensor) and \
                valid_len.device.type == "meta":
            valid = [s] * b   # lengths without values: every slot counts
        else:
            valid = [min(max(int(v), 0), s) for v in valid_len]
        return _meta("decode_attention", *timing.decode_work(
            valid, q.shape[1], k_cache.shape[2], q.shape[2],
            q.element_size()),
            torch.empty_like(q, memory_format=torch.contiguous_format))
    raise ValueError(f"no decode_attention for device {device!r}")


def _scan_meta(dt, x, b_mat, c_mat, a, h0, *, state_out=None,
               chunk_states: bool = False):
    """The forward scan on meta tensors: the plain version's outputs
    (``state_out`` returned as h_T when given)."""
    b, t, c = x.shape
    n = a.shape[1]
    y = x.new_empty((b, t, c))
    h = state_out if state_out is not None else x.new_empty((b, c, n))
    out = (y, h)
    if chunk_states:
        out += (x.new_empty((b, -(-t // ref.SCAN_CHUNK), c, n)),)
    exps, ops, nbytes = timing.selective_scan_work(b, t, c, n,
                                                   h0=h0 is not None)
    return _meta("selective_scan", exps + ops, nbytes, out)


def _scan_forward(dt, x, b_mat, c_mat, a, h0, **kw):
    device = x.device.type
    if device == "cpu":
        return ref.selective_scan(dt, x, b_mat, c_mat, a, h0, **kw)
    if device == "cuda":
        return _ss.selective_scan(dt, x, b_mat, c_mat, a, h0, **kw)
    if device == "meta":
        return _scan_meta(dt, x, b_mat, c_mat, a, h0, **kw)
    raise ValueError(f"no selective_scan for device {device!r}")


def selective_scan_backward(dt, x, b_mat, c_mat, a, chunks, dy, dh_t=None,
                            *, want_dh0: bool = False):
    """The scan's gradients (ddt, dx, dBm, dCm, dA, dh0): the hand-written
    ``csrc/selective_scan_bwd.cu`` for CUDA tensors, its plain version
    (``kernels/ref.py::selective_scan_backward``) for CPU tensors."""
    device = x.device.type
    if device == "cpu":
        return ref.selective_scan_backward(dt, x, b_mat, c_mat, a, chunks,
                                           dy, dh_t, want_dh0=want_dh0)
    if device == "cuda":
        return _ss.selective_scan_backward(dt, x, b_mat, c_mat, a, chunks,
                                           dy, dh_t, want_dh0=want_dh0)
    if device == "meta":
        b, t, c = x.shape
        n = a.shape[1]
        exps, ops, nbytes = timing.selective_scan_bwd_work(
            b, t, c, n, dh_t=dh_t is not None)
        return _meta("selective_scan_bwd", exps + ops, nbytes, (
            x.new_empty((b, t, c)), x.new_empty((b, t, c)),
            x.new_empty((b, t, n)), x.new_empty((b, t, n)),
            x.new_empty((c, n)),
            x.new_empty((b, c, n)) if want_dh0 else None))
    raise ValueError(f"no selective_scan_backward for device {device!r}")


class SelectiveScanFn(torch.autograd.Function):
    """The scan with its gradient: the forward saves the state at the start
    of every 16 steps, the backward recomputes each chunk from it (on the
    card both are hand-written kernels, on the CPU their plain versions).
    Returns (y, h_T, chunks); ``chunks`` takes no gradient."""

    @staticmethod
    def forward(dt, x, b_mat, c_mat, a, h0):
        return _scan_forward(dt, x, b_mat, c_mat, a, h0, chunk_states=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        dt, x, b_mat, c_mat, a, _ = inputs
        chunks = output[2]
        ctx.mark_non_differentiable(chunks)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(dt, x, b_mat, c_mat, a, chunks)

    @staticmethod
    def backward(ctx, dy, dh_t, _):
        dt, x, b_mat, c_mat, a, chunks = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        if dh_t is not None:
            dh_t = dh_t.contiguous()
        ddt, dx, d_bm, d_cm, da, dh0 = selective_scan_backward(
            dt, x, b_mat, c_mat, a, chunks, dy, dh_t,
            want_dh0=ctx.needs_input_grad[5])
        return ddt, dx, d_bm, d_cm, da, dh0


def selective_scan(dt: torch.Tensor, x: torch.Tensor, b_mat: torch.Tensor,
                   c_mat: torch.Tensor, a: torch.Tensor,
                   h0: torch.Tensor | None = None, *,
                   state_out: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The Mamba mixer's diagonal SSM scan, float32: dt, x (B, T, C);
    b_mat, c_mat (B, T, N); a (C, N); h0 (B, C, N) or None for zeros ->
    (y (B, T, C), h_T (B, C, N)).  ``state_out`` (B, C, N), when given,
    receives h_T and is returned as it; it may be ``h0`` itself.

    Under grad mode with an input that requires grad the scan runs through
    :class:`SelectiveScanFn`, whose backward is a kernel too; ``state_out``
    (an in-place write, for a decode step under ``torch.no_grad``) then
    raises.  Otherwise it is one forward launch that saves nothing, as
    served.  The reference's chunks and associative scan are its way to
    bound the TPU's VMEM and are not carried over: the whole sequence is
    one scan.
    """
    inputs = (dt, x, b_mat, c_mat, a, h0)
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in inputs)
    if needs_grad:
        if state_out is not None:
            raise RuntimeError("selective_scan: state_out writes h_T in "
                               "place and takes no gradient; run a decode "
                               "step under torch.no_grad()")
        y, h, _ = SelectiveScanFn.apply(*inputs)
        return y, h
    if x.device.type == "cpu":
        y, h = ref.selective_scan(*inputs)
        if state_out is None:
            return y, h
        return y, state_out.copy_(h)
    return _scan_forward(*inputs, state_out=state_out)
