"""The Eq. 2 kernels for Hopper and their host helpers.

    T^Q( A( [T^C_k(y_k)]_k ) )   —  posterior correction -> weighted
                                     aggregation -> quantile map

Two entry points, as in the reference module:

* :func:`score_pipeline` launches ``csrc/score_pipeline.cu``: one shared
  (K,) / (N,) parameter set, one thread per row, the tables staged in
  shared memory, the bucket by a binary search where the block has proved
  the table sorted and by the exact count otherwise.
* :func:`score_pipeline_banked` launches ``csrc/score_pipeline_banked.cu``:
  one thread per row; a bank whose tables fit a block's shared memory, on
  a window large enough to pay for the copies, has them staged there, its
  source tables proved sorted and searched; otherwise the tables stay in
  L1/L2 and each warp counts its rows' buckets together.
  :func:`banked_path` picks the kernel.

Both are built by ``kernels/_build.py`` and launch on PyTorch's current
stream.  They take CUDA tensors only and raise on anything else; the plain
PyTorch versions are ``kernels/ref.py``, and ``kernels/ops.py`` picks
between the two by the device of the tensors.

:func:`banked_skip_stats` and :func:`_round_block` are the reference's
host-side blocking report, kept unchanged so the ``skip_blocks_*`` serving
metrics mean the same in both packages: the share of pow-2 row blocks that
hold one tenant only.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quantile_map import (check_devices, check_scores,
                                              check_tables)

DEFAULT_BLOCK = 1024
MAX_EXPERTS = 256

LAUNCHES = _build.LAUNCHES


def _round_block(n: int, block: int) -> int:
    """Next power of two >= n, capped at ``block`` — bounds the number of
    distinct (block,) jit specializations the serving layer can trigger."""
    b = 1
    while b < min(n, block):
        b *= 2
    return min(b, block)


def banked_skip_stats(tenant_idx, *, block: int = DEFAULT_BLOCK) -> dict:
    """Host-side skip-rate report for a given tenant layout.

    Mirrors the wrapper's blocking exactly (power-of-two block, edge-padded
    tail) and returns how many grid blocks take the uniform fast path —
    the fraction of blocks that skip the one-hot gather matmuls.
    """
    idx = np.asarray(tenant_idx).reshape(-1)
    n = idx.shape[0]
    blk = _round_block(max(n, 1), block)
    pad = (-n) % blk
    if pad and n:
        idx = np.concatenate([idx, np.full(pad, idx[-1], idx.dtype)])
    blocks = idx.reshape(-1, blk)
    uniform = int((blocks == blocks[:, :1]).all(axis=1).sum())
    total = blocks.shape[0]
    return {"block": blk, "blocks": total, "uniform_blocks": uniform,
            "skip_rate": uniform / total if total else 0.0}


def _shared_library() -> ctypes.CDLL:
    """The shared-parameter kernel's library, with its C signatures."""
    lib = _build.library("score_pipeline")
    lib.score_pipeline_launch.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.score_pipeline_launch.restype = ctypes.c_int
    lib.score_pipeline_error_string.argtypes = [ctypes.c_int]
    lib.score_pipeline_error_string.restype = ctypes.c_char_p
    return lib


def score_pipeline(expert_scores: torch.Tensor, betas: torch.Tensor,
                   weights: torch.Tensor, src_quantiles: torch.Tensor,
                   ref_quantiles: torch.Tensor) -> torch.Tensor:
    """Eq. 2 with one shared parameter set in ONE launch of the CUDA kernel.

    ``expert_scores``: (..., K) float32 or bfloat16; ``betas``, ``weights``:
    (K,) float32; the tables: (N,) float32; all on one CUDA device.  Returns
    (...) in the scores' dtype (float32 math).  The rows are flattened as
    the reference flattens them; a non-contiguous tensor is copied first.
    Raises ``ValueError`` on any other input — there is no fallback to the
    plain version.
    """
    check_scores(expert_scores)
    if expert_scores.dim() < 1:
        raise ValueError("expert_scores must be (..., K)")
    *batch_shape, k = expert_scores.shape
    if not 1 <= k <= MAX_EXPERTS:
        raise ValueError(f"K = {k}: the kernel takes 1 <= K <= {MAX_EXPERTS}")
    for name, x in (("betas", betas), ("weights", weights)):
        if not isinstance(x, torch.Tensor) or tuple(x.shape) != (k,):
            raise ValueError(f"{name} must be ({k},)")
        if x.dtype != torch.float32:
            raise ValueError(f"{name}: dtype {x.dtype}, expected "
                             "torch.float32")
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    n = check_tables(src_quantiles, ref_quantiles)
    check_devices(expert_scores, betas=betas, weights=weights,
                  src_quantiles=src_quantiles, ref_quantiles=ref_quantiles)
    device = expert_scores.device
    flat = expert_scores.reshape(-1, k).contiguous()
    out = torch.empty(flat.shape[0], dtype=expert_scores.dtype, device=device)
    lib = _shared_library()
    with torch.cuda.device(device):
        code = lib.score_pipeline_launch(
            flat.data_ptr(), betas.data_ptr(), weights.data_ptr(),
            src_quantiles.data_ptr(), ref_quantiles.data_ptr(),
            out.data_ptr(), flat.shape[0], k, n,
            int(expert_scores.dtype == torch.bfloat16),
            torch.cuda.current_stream(device).cuda_stream)
    if code != 0:
        msg = lib.score_pipeline_error_string(code).decode()
        raise RuntimeError(f"score_pipeline launch failed: {msg}")
    LAUNCHES["score_pipeline"] += 1
    return out.reshape(batch_shape)


def banked_shared_bytes(t: int, n: int) -> int:
    """Shared memory the shared-bank kernel takes for T table pairs of N
    knots: both tables, each row padded to an odd number of 16-byte quads,
    and a sorted flag a tenant, 4 bytes each
    (``csrc/score_pipeline_banked.cu::shared_bytes``)."""
    quads = -(-n // 4)
    padded = 4 * (quads if quads % 2 else quads + 1)
    return 4 * t * (2 * padded + 1)


# Rows an SM must score before staging the bank in each of its blocks
# pays for itself: on the H100 (132 SMs) the L1/L2 kernel is the faster
# one up to 16,384 rows and the shared-memory kernel from 32,768 (T = 64,
# K = 8; chip_smoke.py's kernel phase times both across that range).
SHARED_ROWS_PER_SM = 200


def banked_path(t: int, n: int, m: int, shared_limit: int, sms: int) -> str:
    """Which banked kernel scores M rows against a bank of T tenants and N
    knots on a card of ``sms`` SMs whose blocks may opt in to
    ``shared_limit`` bytes of shared memory: ``"shared"`` (both tables
    staged in each block) when they fit and the rows give every SM at least
    ``SHARED_ROWS_PER_SM`` of them to pay for its copy, else ``"global"``
    (the tables read through L1/L2).  Both are the hand-written kernel.  K
    does not enter: beta and w are read through L1 on both paths."""
    fits = banked_shared_bytes(t, n) <= shared_limit
    return "shared" if fits and m >= SHARED_ROWS_PER_SM * sms else "global"


# device index -> (opt-in shared memory per block, SMs), read once
_CARD: dict[int, tuple[int, int]] = {}


def card(device: torch.device) -> tuple[int, int]:
    """The opt-in shared memory a block of ``device`` may take, as the card
    reports it (``cudaDevAttrMaxSharedMemoryPerBlockOptin``), and its SM
    count: what :func:`banked_path` needs to know of the card."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _CARD:
        props = torch.cuda.get_device_properties(index)
        _CARD[index] = (props.shared_memory_per_block_optin,
                        props.multi_processor_count)
    return _CARD[index]


def _library() -> ctypes.CDLL:
    """The banked kernel's library, with its C signatures declared."""
    lib = _build.library("score_pipeline_banked")
    lib.score_pipeline_banked_launch.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.score_pipeline_banked_launch.restype = ctypes.c_int
    lib.score_pipeline_banked_error_string.argtypes = [ctypes.c_int]
    lib.score_pipeline_banked_error_string.restype = ctypes.c_char_p
    lib.score_pipeline_banked_shared_bytes.argtypes = [ctypes.c_int] * 2
    lib.score_pipeline_banked_shared_bytes.restype = ctypes.c_longlong
    return lib


def score_pipeline_banked(expert_scores: torch.Tensor,
                          tenant_idx: torch.Tensor, betas: torch.Tensor,
                          weights: torch.Tensor, src_quantiles: torch.Tensor,
                          ref_quantiles: torch.Tensor) -> torch.Tensor:
    """Mixed-tenant Eq. 2 in ONE launch of a CUDA kernel, the one
    :func:`banked_path` picks for the bank.

    ``expert_scores``: (M, K) float32; ``tenant_idx``: (M,) int32 row index
    into the (T, K) / (T, N) float32 banks (``ops.score_pipeline_banked``
    casts other integer ids); every tensor contiguous and on one CUDA
    device.  Returns (M,) float32.  A row whose id lies outside [0, T)
    scores NaN.  Raises ``ValueError`` on any other input — there is no
    fallback to the plain version.
    """
    tensors = {"expert_scores": expert_scores, "tenant_idx": tenant_idx,
               "betas": betas, "weights": weights,
               "src_quantiles": src_quantiles, "ref_quantiles": ref_quantiles}
    device = expert_scores.device
    for name, x in tensors.items():
        if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
            raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors")
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, scores on {device}")
        want = torch.int32 if name == "tenant_idx" else torch.float32
        if x.dtype != want:
            raise ValueError(f"{name}: dtype {x.dtype}, expected {want}")
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if expert_scores.dim() != 2 or tenant_idx.dim() != 1:
        raise ValueError("expert_scores must be (M, K) and tenant_idx (M,)")
    m, k = expert_scores.shape
    if tenant_idx.shape[0] != m:
        raise ValueError(f"tenant_idx has {tenant_idx.shape[0]} rows for "
                         f"{m} score rows")
    if m == 0 or k == 0:
        raise ValueError("empty input: the kernel needs M >= 1 and K >= 1")
    if betas.dim() != 2 or betas.shape != weights.shape \
            or betas.shape[1] != k:
        raise ValueError(f"betas/weights must both be (T, {k})")
    t = betas.shape[0]
    if src_quantiles.dim() != 2 or src_quantiles.shape != ref_quantiles.shape \
            or src_quantiles.shape[0] != t or src_quantiles.shape[1] < 2 \
            or t == 0:
        raise ValueError(f"src/ref quantiles must both be ({t}, N), N >= 2")
    n = src_quantiles.shape[1]
    shared = banked_path(t, n, m, *card(device)) == "shared"
    out = torch.empty(m, dtype=torch.float32, device=device)
    lib = _library()
    with torch.cuda.device(device):
        code = lib.score_pipeline_banked_launch(
            expert_scores.data_ptr(), tenant_idx.data_ptr(),
            betas.data_ptr(), weights.data_ptr(), src_quantiles.data_ptr(),
            ref_quantiles.data_ptr(), out.data_ptr(), m, k, t, n,
            int(shared), torch.cuda.current_stream(device).cuda_stream)
    if code != 0:
        msg = lib.score_pipeline_banked_error_string(code).decode()
        raise RuntimeError(f"score_pipeline_banked launch failed: {msg}")
    LAUNCHES["score_pipeline_banked"] += 1
    return out
