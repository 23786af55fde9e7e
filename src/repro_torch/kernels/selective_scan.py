"""The Mamba mixer's selective scan for Hopper.

:func:`selective_scan` launches the hand-written CUDA kernel of
``csrc/selective_scan.cu`` (built by ``kernels/_build.py``) on PyTorch's
current stream: one thread a (batch, channel) lane holding its N states in
registers over the whole sequence, ``Bm`` and ``Cm`` staged in shared
memory a tile of time steps at a time.  It takes float32 contiguous CUDA
tensors only and raises on anything else; the plain PyTorch version is
``kernels/ref.py::selective_scan``, and ``kernels/ops.py`` picks between
the two by the device of the tensors.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

LAUNCHES = _build.LAUNCHES
MAX_STATE = 16      # the kernel keeps N <= 16 states a thread in registers


def check_inputs(dt: torch.Tensor, x: torch.Tensor, b_mat: torch.Tensor,
                 c_mat: torch.Tensor, a: torch.Tensor,
                 h0: torch.Tensor | None = None,
                 state_out: torch.Tensor | None = None) -> None:
    """Raise ``ValueError`` unless dt, x are (B, T, C), b_mat, c_mat
    (B, T, N), a (C, N) and h0, state_out (when given) (B, C, N), every one
    float32 and contiguous, with B, T, C >= 1 and 1 <= N <= ``MAX_STATE``."""
    tensors = {"dt": dt, "x": x, "b_mat": b_mat, "c_mat": c_mat, "a": a}
    if h0 is not None:
        tensors["h0"] = h0
    if state_out is not None:
        tensors["state_out"] = state_out
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{name} must be a tensor")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: dtype {t.dtype}, the kernel takes "
                             "torch.float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"dt {tuple(dt.shape)} and x {tuple(x.shape)} must "
                         "be one (B, T, C) shape")
    b, t, c = x.shape
    if a.dim() != 2 or a.shape[0] != c:
        raise ValueError(f"a {tuple(a.shape)} must be (C, N) with C = {c}")
    n = a.shape[1]
    for name, m in (("b_mat", b_mat), ("c_mat", c_mat)):
        if tuple(m.shape) != (b, t, n):
            raise ValueError(f"{name} {tuple(m.shape)}, expected "
                             f"{(b, t, n)}")
    for name in ("h0", "state_out"):
        if name in tensors and tuple(tensors[name].shape) != (b, c, n):
            raise ValueError(f"{name} {tuple(tensors[name].shape)}, "
                             f"expected {(b, c, n)}")
    if min(b, t, c) < 1 or not 1 <= n <= MAX_STATE:
        raise ValueError(f"B, T, C = {b}, {t}, {c} and N = {n}: the kernel "
                         f"takes sizes >= 1 and N <= {MAX_STATE}")


def check_devices(x: torch.Tensor, **tensors: torch.Tensor | None) -> None:
    """Raise ``ValueError`` unless x lies on a CUDA device and every other
    given tensor on the same one."""
    if x.device.type != "cuda":
        raise ValueError("x: the CUDA kernel takes CUDA tensors")
    for name, t in tensors.items():
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library, with its C signature declared once."""
    lib = _build.library("selective_scan")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.selective_scan_launch.argtypes = [ptr] * 8 + [i32] * 4 + [ptr]
    lib.selective_scan_launch.restype = ctypes.c_int
    lib.selective_scan_error_string.argtypes = [ctypes.c_int]
    lib.selective_scan_error_string.restype = ctypes.c_char_p
    return lib


def selective_scan(dt: torch.Tensor, x: torch.Tensor, b_mat: torch.Tensor,
                   c_mat: torch.Tensor, a: torch.Tensor,
                   h0: torch.Tensor | None = None, *,
                   state_out: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(y (B, T, C), h_T (B, C, N)) of the recurrence
    ``h_t = exp(dt_t · A) · h_{t-1} + (dt_t · x_t) · Bm_t``,
    ``y_t = Σ_n h_t · Cm_t`` from ``h0`` (zeros when None), in ONE launch.
    ``state_out``, when given, receives h_T and is returned as it; it may
    be ``h0`` itself (a decode step updates its cache in place)."""
    check_inputs(dt, x, b_mat, c_mat, a, h0, state_out)
    check_devices(x, dt=dt, b_mat=b_mat, c_mat=c_mat, a=a, h0=h0,
                  state_out=state_out)
    b, t, c = x.shape
    n = a.shape[1]
    y = torch.empty_like(x)
    h_out = state_out if state_out is not None else torch.empty(
        (b, c, n), dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        code = lib.selective_scan_launch(
            dt.data_ptr(), x.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
            a.data_ptr(), h0.data_ptr() if h0 is not None else None,
            y.data_ptr(), h_out.data_ptr(), b, t, c, n,
            torch.cuda.current_stream(x.device).cuda_stream)
    if code != 0:
        msg = lib.selective_scan_error_string(code).decode()
        raise RuntimeError(f"selective_scan launch failed: {msg}")
    LAUNCHES["selective_scan"] += 1
    return y, h_out
