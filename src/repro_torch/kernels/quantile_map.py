"""The quantile map T^Q (paper Eq. 4) for Hopper.

:func:`quantile_map` launches the hand-written CUDA kernel of
``csrc/quantile_map.cu`` (built by ``kernels/_build.py``) on PyTorch's
current stream: one score a thread, both tables staged in shared memory,
the bucket from a binary search on a table the block proves sorted and free
of NaN, else the exact count of knots at or below the score.  It takes CUDA
tensors only and raises on anything else; the plain PyTorch version is
``kernels/ref.py``, and ``kernels/ops.py`` picks between the two by the
device of the tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = _build.LAUNCHES
DTYPES = (torch.float32, torch.bfloat16)
MAX_KNOTS = 4096   # two float32 tables in 48 KB of shared memory


def check_scores(scores: torch.Tensor) -> None:
    """Raise ``ValueError`` unless the scores are a non-empty float32 or
    bfloat16 tensor."""
    if not isinstance(scores, torch.Tensor):
        raise ValueError("scores must be a tensor")
    if scores.dtype not in DTYPES:
        raise ValueError(f"scores: dtype {scores.dtype}; the kernel takes "
                         "float32 or bfloat16")
    if scores.numel() == 0:
        raise ValueError("empty input: the kernel needs at least one score")


def check_tables(src_quantiles: torch.Tensor,
                 ref_quantiles: torch.Tensor) -> int:
    """Raise ``ValueError`` unless the two tables are one (N,) float32
    contiguous pair with 2 <= N <= ``MAX_KNOTS``; returns N."""
    for name, x in (("src_quantiles", src_quantiles),
                    ("ref_quantiles", ref_quantiles)):
        if not isinstance(x, torch.Tensor) or x.dim() != 1:
            raise ValueError(f"{name} must be a rank-1 (N,) tensor")
        if x.dtype != torch.float32:
            raise ValueError(f"{name}: dtype {x.dtype}, expected "
                             "torch.float32")
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if src_quantiles.shape != ref_quantiles.shape:
        raise ValueError(f"src {tuple(src_quantiles.shape)} and ref "
                         f"{tuple(ref_quantiles.shape)} tables differ")
    n = src_quantiles.shape[0]
    if not 2 <= n <= MAX_KNOTS:
        raise ValueError(f"{n} knots: the kernel takes N >= 2 and "
                         f"N <= {MAX_KNOTS}")
    return n


def check_devices(scores: torch.Tensor, **tensors: torch.Tensor) -> None:
    """Raise ``ValueError`` unless the scores lie on a CUDA device and every
    other tensor on the same one."""
    if scores.device.type != "cuda":
        raise ValueError("scores: the CUDA kernel takes CUDA tensors")
    for name, x in tensors.items():
        if x.device != scores.device:
            raise ValueError(f"{name} is on {x.device}, scores on "
                             f"{scores.device}")


def _library() -> ctypes.CDLL:
    """The kernel's library, with its C signatures declared for ctypes."""
    lib = _build.library("quantile_map")
    ptr = ctypes.c_void_p
    lib.quantile_map_launch.argtypes = [ptr] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ptr]
    lib.quantile_map_launch.restype = ctypes.c_int
    lib.quantile_map_error_string.argtypes = [ctypes.c_int]
    lib.quantile_map_error_string.restype = ctypes.c_char_p
    return lib


def quantile_map(scores: torch.Tensor, src_quantiles: torch.Tensor,
                 ref_quantiles: torch.Tensor) -> torch.Tensor:
    """Scores of any shape, float32 or bfloat16, against (N,) float32 tables
    -> mapped scores of the same shape and dtype, in ONE launch of the CUDA
    kernel (float32 math).  The scores are flattened as the reference
    flattens them; a non-contiguous tensor is copied first.  Raises
    ``RuntimeError`` under grad mode when an input requires grad (the
    kernel has no backward)."""
    _build.refuse_grad("quantile_map", (scores, src_quantiles,
                                        ref_quantiles))
    check_scores(scores)
    n = check_tables(src_quantiles, ref_quantiles)
    check_devices(scores, src_quantiles=src_quantiles,
                  ref_quantiles=ref_quantiles)
    flat = scores.reshape(-1).contiguous()
    out = torch.empty_like(flat)
    lib = _library()
    with torch.cuda.device(scores.device):
        code = lib.quantile_map_launch(
            flat.data_ptr(), src_quantiles.data_ptr(),
            ref_quantiles.data_ptr(), out.data_ptr(), flat.shape[0], n,
            int(scores.dtype == torch.bfloat16),
            torch.cuda.current_stream(scores.device).cuda_stream)
    if code != 0:
        msg = lib.quantile_map_error_string(code).decode()
        raise RuntimeError(f"quantile_map launch failed: {msg}")
    LAUNCHES["quantile_map"] += 1
    return out.reshape(scores.shape)
