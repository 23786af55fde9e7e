"""Flash attention (GQA, causal and/or sliding window) for Hopper.

:func:`flash_attention` launches the hand-written CUDA kernel of
``csrc/flash_attention.cu`` (built by ``kernels/_build.py``) on PyTorch's
current stream.  It reads q, k and v in place from the model's
(B, T, H, D) layout by their strides, so the innermost dim must be
contiguous; it allocates the (B, Tq, Hq, D) output in q's dtype.  It takes
CUDA tensors only and raises ``ValueError`` on anything the kernel does not
take; the plain PyTorch version is ``kernels/ref.py``, and
``kernels/ops.py`` picks between the two by the device of the tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = _build.LAUNCHES
DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 128


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


def _library() -> ctypes.CDLL:
    """The kernel's library, with its C signatures declared for ctypes."""
    lib = _build.library("flash_attention")
    i64, i32, ptr = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    lib.flash_attention_launch.argtypes = (
        [ptr] * 4 + [i64] * 3 + [i32] * 3 + [i64] * 12 + [i32] * 3 + [ptr])
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sliding_window: int = 0
                    ) -> torch.Tensor:
    """q: (B, Tq, Hq, D); k, v: (B, Tk, Hkv, D) -> (B, Tq, Hq, D) in q's
    dtype, in ONE launch of the CUDA kernel.  Query head h reads KV head
    h // (Hq / Hkv); positions count from 0 on both sides.  A query row
    that sees no key comes out 0."""
    check_inputs(q, k, v, sliding_window)
    b, tq, hq, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    out = torch.empty((b, tq, hq, d), dtype=q.dtype, device=q.device)
    lib = _library()
    strides = [s for x in (q, k, v, out) for s in x.stride()[:3]]
    with torch.cuda.device(q.device):
        code = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, tq, tk, hq, hkv, d, *strides, int(bool(causal)),
            int(sliding_window), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    if code != 0:
        msg = lib.flash_attention_error_string(code).decode()
        raise RuntimeError(f"flash_attention launch failed: {msg}")
    LAUNCHES["flash_attention"] += 1
    return out
