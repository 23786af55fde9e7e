"""Flash attention (GQA, causal and/or sliding window) for Hopper.

:func:`flash_attention` launches one of two hand-written CUDA kernels
(built by ``kernels/_build.py``) on PyTorch's current stream, chosen by
:func:`kernel_form` from the dtype and head dim alone:

* ``"wgmma"``, ``csrc/flash_attention_wgmma.cu``: bf16 with D in
  ``WGMMA_HEAD_DIMS``, on the tensor cores (wgmma, a TMA ring, warp
  specialisation).  TMA reads only 16-byte-aligned rows, so such an input
  whose data pointer or B, T or H stride is not a multiple of 16 bytes
  raises ``ValueError``;
* ``"simt"``, ``csrc/flash_attention.cu``: float32, and bf16 with any other
  D, in float32 on the CUDA cores.

Either reads q, k and v in place from the model's (B, T, H, D) layout by
their strides, so the innermost dim must be contiguous; it allocates the
(B, Tq, Hq, D) output in q's dtype.  It takes CUDA tensors only and raises
``ValueError`` on anything the kernels do not take; a failed build or
launch raises too, and no form stands in for another.  The plain PyTorch
version is ``kernels/ref.py``, and ``kernels/ops.py`` picks between it and
the kernels by the device of the tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = _build.LAUNCHES
DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 128
WGMMA_HEAD_DIMS = (64, 128)


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 sliding_window: int) -> None:
    """Raise ``ValueError`` unless the kernel takes these inputs."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not isinstance(x, torch.Tensor) or x.dim() != 4:
            raise ValueError(f"{name} must be a rank-4 (B, T, H, D) tensor")
        if x.dtype not in DTYPES:
            raise ValueError(f"{name}: dtype {x.dtype}; the kernel takes "
                             "float32 or bfloat16")
        if x.dtype != q.dtype:
            raise ValueError(f"{name} is {x.dtype}, q is {q.dtype}")
    b, tq, hq, d = q.shape
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    hkv = k.shape[2]
    if hkv == 0 or hq % hkv != 0:
        raise ValueError(f"{hq} query heads are not a multiple of {hkv} "
                         "KV heads")
    if d % 16 != 0 or not 16 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d}: the kernel takes multiples of 16 "
                         f"up to {MAX_HEAD_DIM}")
    if b == 0 or tq == 0 or k.shape[1] == 0:
        raise ValueError("empty input: the kernel needs B, Tq, Tk >= 1")
    if int(sliding_window) < 0:
        raise ValueError(f"sliding_window {sliding_window} < 0")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"{name}: the head dim must be contiguous "
                             f"(strides {x.stride()})")
        if x.device.type != "cuda":
            raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")


def _tma_aligned(x: torch.Tensor) -> bool:
    """TMA's rule: the data pointer and the stride of every B, T and H
    dim longer than 1 are multiples of 16 bytes."""
    return x.data_ptr() % 16 == 0 and all(
        (stride * x.element_size()) % 16 == 0
        for size, stride in zip(x.shape[:3], x.stride()[:3]) if size > 1)


def kernel_form(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """``"wgmma"`` for bf16 with D in ``WGMMA_HEAD_DIMS``, else ``"simt"``
    (for inputs :func:`check_inputs` accepts).  Raises ``ValueError`` for a
    wgmma input that is not 16-byte aligned: no other form takes it."""
    if q.dtype != torch.bfloat16 or q.shape[3] not in WGMMA_HEAD_DIMS:
        return "simt"
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not _tma_aligned(x):
            raise ValueError(
                f"{name}: the bf16 D={q.shape[3]} kernel reads by TMA, which "
                "needs a 16-byte-aligned data pointer and B, T, H strides "
                f"(pointer {x.data_ptr()}, strides {x.stride()})")
    return "wgmma"


# each form's source and the ctypes signature of its launcher: pointers
# q, k, v, o; B, Tq, Tk; Hq, Hkv, D; twelve strides; causal, window (and
# the SIMT form's is_bf16); the stream
_I64, _I32, _PTR = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
_ARGS = [_PTR] * 4 + [_I64] * 3 + [_I32] * 3 + [_I64] * 12
_SOURCES = {"simt": ("flash_attention", _ARGS + [_I32] * 3 + [_PTR]),
            "wgmma": ("flash_attention_wgmma", _ARGS + [_I32] * 2 + [_PTR])}


def _entry_points(form: str):
    """A form's launcher and error-string functions, their C signatures
    declared for ctypes."""
    name, argtypes = _SOURCES[form]
    lib = _build.library(name)
    launch = getattr(lib, f"{name}_launch")
    launch.argtypes = argtypes
    launch.restype = ctypes.c_int
    error_string = getattr(lib, f"{name}_error_string")
    error_string.argtypes = [ctypes.c_int]
    error_string.restype = ctypes.c_char_p
    return launch, error_string


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sliding_window: int = 0
                    ) -> torch.Tensor:
    """q: (B, Tq, Hq, D); k, v: (B, Tk, Hkv, D) -> (B, Tq, Hq, D) in q's
    dtype, in ONE launch of the form :func:`kernel_form` picks.  Query head
    h reads KV head h // (Hq / Hkv); positions count from 0 on both sides.
    A query row that sees no key comes out 0.  ``LAUNCHES`` counts every
    launch under ``"flash_attention"`` and the wgmma form's also under
    ``"flash_attention_wgmma"``."""
    check_inputs(q, k, v, sliding_window)
    form = kernel_form(q, k, v)
    b, tq, hq, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    out = torch.empty((b, tq, hq, d), dtype=q.dtype, device=q.device)
    launch, error_string = _entry_points(form)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, tq, tk, hq, hkv, d,
            *(s for x in (q, k, v, out) for s in x.stride()[:3]),
            int(bool(causal)), int(sliding_window)]
    if form == "simt":
        args.append(int(q.dtype == torch.bfloat16))
    with torch.cuda.device(q.device):
        code = launch(*args, torch.cuda.current_stream(q.device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"flash_attention ({form} form) launch failed: "
                           f"{error_string(code).decode()}")
    LAUNCHES["flash_attention"] += 1
    if form == "wgmma":
        LAUNCHES["flash_attention_wgmma"] += 1
    return out
