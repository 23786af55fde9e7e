"""Public entry points of the port's kernels, dispatched by tensor device.

A CPU tensor runs the plain PyTorch version (``kernels/ref.py``); a CUDA
tensor launches the hand-written kernel, which raises on what it does not
take.  There is no switch and no fallback: a CUDA tensor never reaches the
plain version through this module.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import quantile_map as _qm
from repro_torch.kernels import score_pipeline as _sp

# launch counts of every hand-written kernel (the wrappers bump them)
LAUNCHES = _build.LAUNCHES


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
    raise ValueError(f"no decode_attention for device {device!r}")
