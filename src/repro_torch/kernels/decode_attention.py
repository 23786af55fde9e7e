"""Decode attention (one query position against a KV cache, GQA) for Hopper.

:func:`decode_attention` launches the hand-written CUDA kernels of
``csrc/decode_attention.cu`` (built by ``kernels/_build.py``) on PyTorch's
current stream: a split pass that streams the cache with 16-byte copies
and writes per-split partial softmax states to a float32 workspace (bf16
with D a multiple of 32 on the tensor cores, the rest on the CUDA cores),
then a combine, which the plan leaves out where one split covers the
cache.  It reads the (B, S, Hkv, D) caches in place by their strides, so
the head dim must be contiguous and every pointer and stride 16-byte
aligned.  It takes CUDA tensors only and raises ``ValueError`` on anything
the kernels do not take; the plain PyTorch version is ``kernels/ref.py``,
and ``kernels/ops.py`` picks between the two by the device of the tensors.
One call is at most two CUDA launches and counts as one in ``LAUNCHES``.
The wrapper keeps no state between calls but the loaded library.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

LAUNCHES = _build.LAUNCHES
DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 128
MAX_GROUP = 64          # query heads per KV head
SMS = 132               # streaming multiprocessors of an H100
CHUNK_STEP = 16         # a split's positions are a multiple of this
# the bf16 check of the kernel: its output against the plain version run in
# float32 on the same bf16 inputs, within bf16's rounding of o (half an
# ulp, at most 2^-8 of |o|) plus the float32 tolerance for the sums
BF16_RTOL = 2.0 ** -8
BF16_ATOL = 2e-5


def uses_tensor_cores(d: int, dtype: torch.dtype) -> bool:
    """bf16 with D a multiple of 32 runs the tensor-core form of the split
    pass; float32 and other D the CUDA-core form."""
    return dtype == torch.bfloat16 and d % 32 == 0


def resident_blocks(d: int, dtype: torch.dtype) -> int:
    """Split-pass blocks an H100 holds at once (the kernels'
    ``__launch_bounds__``): on the tensor cores 2 an SM at D <= 64 and 1
    above (their registers), on the CUDA cores 3 (2 for bf16 with more
    than 4 heads a pass, which the plan does not see: a part of such a
    grid runs as a second wave)."""
    if uses_tensor_cores(d, dtype):
        return SMS * (2 if d <= 64 else 1)
    return SMS * 3


def plan_splits(b: int, hkv: int, s: int, d: int, dtype: torch.dtype
                ) -> tuple[int, int]:
    """(splits, chunk) for a (B, S, Hkv, D) cache of ``dtype``: ``chunk``
    positions a split, a multiple of ``CHUNK_STEP``, and ``splits`` the
    fewest chunks that cover S.  About one wave of resident blocks over
    the B * Hkv (row, KV head) pairs, each streaming its chunk in many
    rounds; one split where the pairs alone fill the wave."""
    want = max(1, resident_blocks(d, dtype) // (b * hkv))
    per_split = -(-s // want)
    chunk = -(-per_split // CHUNK_STEP) * CHUNK_STEP
    return -(-s // chunk), chunk


def bf16_excess(got: torch.Tensor, want: torch.Tensor) -> float:
    """How far the bf16 output ``got`` lies outside its check against
    ``want``, the plain version run in float32 on the same bf16 inputs
    (``BF16_RTOL``, ``BF16_ATOL``); the check passes where this is <= 0."""
    want = want.float()
    err = (got.float() - want).abs()
    return (err - (BF16_ATOL + BF16_RTOL * want.abs())).max().item()


def check_inputs(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, valid_len: torch.Tensor) -> None:
    """Raise ``ValueError`` unless the kernels take these inputs."""
    if not isinstance(q, torch.Tensor) or q.dim() != 3:
        raise ValueError("q must be a rank-3 (B, Hq, D) tensor")
    for name, x in (("k_cache", k_cache), ("v_cache", v_cache)):
        if not isinstance(x, torch.Tensor) or x.dim() != 4:
            raise ValueError(f"{name} must be a rank-4 (B, S, Hkv, D) tensor")
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if x.dtype not in DTYPES:
            raise ValueError(f"{name}: dtype {x.dtype}; the kernel takes "
                             "float32 or bfloat16")
        if x.dtype != q.dtype:
            raise ValueError(f"{name} is {x.dtype}, q is {q.dtype}")
    b, hq, d = q.shape
    if k_cache.shape != v_cache.shape:
        raise ValueError(f"k_cache {tuple(k_cache.shape)} and v_cache "
                         f"{tuple(v_cache.shape)} differ")
    if k_cache.shape[0] != b or k_cache.shape[3] != d:
        raise ValueError(f"caches {tuple(k_cache.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    hkv = k_cache.shape[2]
    if hkv == 0 or hq % hkv != 0:
        raise ValueError(f"{hq} query heads are not a multiple of {hkv} "
                         "KV heads")
    if hq // hkv > MAX_GROUP:
        raise ValueError(f"{hq // hkv} query heads per KV head: the kernel "
                         f"takes at most {MAX_GROUP}")
    if d % 16 != 0 or not 16 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d}: the kernel takes multiples of 16 "
                         f"up to {MAX_HEAD_DIM}")
    if b == 0 or k_cache.shape[1] == 0:
        raise ValueError("empty input: the kernel needs B, S >= 1")
    if not isinstance(valid_len, torch.Tensor) or valid_len.dtype != \
            torch.int32 or tuple(valid_len.shape) != (b,):
        raise ValueError(f"valid_len must be a ({b},) int32 tensor")
    if not valid_len.is_contiguous():
        raise ValueError("valid_len is not contiguous")
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if x.stride(-1) != 1:
            raise ValueError(f"{name}: the head dim must be contiguous "
                             f"(strides {x.stride()})")
    # every row the kernel reads with 16-byte loads starts 16-byte aligned
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        size = x.element_size()
        if x.data_ptr() % 16 or any(
                n > 1 and st * size % 16
                for n, st in zip(x.shape[:-1], x.stride()[:-1])):
            raise ValueError(f"{name}: the kernel reads 16-byte rows; its "
                             f"pointer or strides {x.stride()} are not "
                             "16-byte aligned")
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("valid_len", valid_len)):
        if x.device.type != "cuda":
            raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernels' library, with its C signatures declared once."""
    lib = _build.library("decode_attention")
    i64, i32, ptr = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    lib.decode_attention_launch.argtypes = (
        [ptr] * 6 + [i64] * 2 + [i32] * 4 + [i64] * 9 + [i32, ptr])
    lib.decode_attention_launch.restype = ctypes.c_int
    lib.decode_attention_error_string.argtypes = [ctypes.c_int]
    lib.decode_attention_error_string.restype = ctypes.c_char_p
    return lib


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid_len: torch.Tensor
                     ) -> torch.Tensor:
    """q: (B, Hq, D); caches: (B, S, Hkv, D); ``valid_len``: (B,) int32 ->
    (B, Hq, D) in q's dtype.  Query head h attends to positions
    < clamp(valid_len[b], 0, S) of KV head h // (Hq / Hkv); a row with no
    such position comes out 0."""
    check_inputs(q, k_cache, v_cache, valid_len)
    b, hq, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    splits, chunk = plan_splits(b, hkv, s, d, q.dtype)
    # the split pass's float32 (acc, m, l) of every (row, head, split)
    ws = torch.empty(b * hq * splits * (d + 2) if splits > 1 else 0,
                     dtype=torch.float32, device=q.device)
    out = torch.empty((b, hq, d), dtype=q.dtype, device=q.device)
    strides = [*q.stride()[:2], *k_cache.stride()[:3], *v_cache.stride()[:3]]
    lib = _library()
    with torch.cuda.device(q.device):
        code = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            valid_len.data_ptr(), out.data_ptr(),
            ws.data_ptr() if splits > 1 else None, b, s, hq, hkv, d,
            splits, chunk, *strides, int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    if code != 0:
        msg = lib.decode_attention_error_string(code).decode()
        raise RuntimeError(f"decode_attention launch failed: {msg}")
    LAUNCHES["decode_attention"] += 1
    return out
