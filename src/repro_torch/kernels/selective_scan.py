"""The Mamba mixer's selective scan and its backward for Hopper.

:func:`selective_scan` launches the hand-written CUDA kernel of
``csrc/selective_scan.cu`` (built by ``kernels/_build.py``) on PyTorch's
current stream: one thread a (batch, channel) lane holding its N states in
registers over the whole sequence, ``Bm`` and ``Cm`` staged in shared
memory a tile of time steps at a time.  For training it also writes the
state at the start of every tile of ``CHUNK`` steps, from which
:func:`selective_scan_backward` (``csrc/selective_scan_bwd.cu``: a lane a
thread walking the tiles in reverse, then a second launch that sums the
per-block partials of dBm, dCm and dA in a fixed order) recomputes them.
Both take float32 contiguous CUDA tensors only and raise on anything else;
the plain PyTorch versions are ``kernels/ref.py::selective_scan`` and
``selective_scan_backward``, and ``kernels/ops.py`` picks between the two
by the device of the tensors.  Neither is differentiable by itself:
``kernels/ops.py::SelectiveScanFn`` joins them, and each raises when grad
mode is on and an input requires grad.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

LAUNCHES = _build.LAUNCHES
MAX_STATE = 16      # the kernel keeps N <= 16 states a thread in registers
CHUNK = 64          # steps between the states saved for the backward


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
    lib.selective_scan_launch.argtypes = [ptr] * 9 + [i32] * 4 + [ptr]
    lib.selective_scan_launch.restype = ctypes.c_int
    lib.selective_scan_error_string.argtypes = [ctypes.c_int]
    lib.selective_scan_error_string.restype = ctypes.c_char_p
    return lib


def _ptr(t: torch.Tensor | None):
    return t.data_ptr() if t is not None else None


def selective_scan(dt: torch.Tensor, x: torch.Tensor, b_mat: torch.Tensor,
                   c_mat: torch.Tensor, a: torch.Tensor,
                   h0: torch.Tensor | None = None, *,
                   state_out: torch.Tensor | None = None,
                   chunk_states: bool = False):
    """(y (B, T, C), h_T (B, C, N)) of the recurrence
    ``h_t = exp(dt_t · A) · h_{t-1} + (dt_t · x_t) · Bm_t``,
    ``y_t = Σ_n h_t · Cm_t`` from ``h0`` (zeros when None), in ONE launch.
    ``state_out``, when given, receives h_T and is returned as it; it may
    be ``h0`` itself (a decode step updates its cache in place).  With
    ``chunk_states`` the launch also writes the state at the start of each
    tile of ``CHUNK`` steps, returned third as (B, ceil(T / CHUNK), C, N)."""
    _build.refuse_grad("selective_scan", (dt, x, b_mat, c_mat, a, h0))
    check_inputs(dt, x, b_mat, c_mat, a, h0, state_out)
    check_devices(x, dt=dt, b_mat=b_mat, c_mat=c_mat, a=a, h0=h0,
                  state_out=state_out)
    b, t, c = x.shape
    n = a.shape[1]
    y = torch.empty_like(x)
    h_out = state_out if state_out is not None else torch.empty(
        (b, c, n), dtype=torch.float32, device=x.device)
    chunks = torch.empty((b, -(-t // CHUNK), c, n), dtype=torch.float32,
                         device=x.device) if chunk_states else None
    lib = _library()
    with torch.cuda.device(x.device):
        code = lib.selective_scan_launch(
            dt.data_ptr(), x.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
            a.data_ptr(), _ptr(h0), y.data_ptr(), h_out.data_ptr(),
            _ptr(chunks), b, t, c, n,
            torch.cuda.current_stream(x.device).cuda_stream)
    if code != 0:
        msg = lib.selective_scan_error_string(code).decode()
        raise RuntimeError(f"selective_scan launch failed: {msg}")
    LAUNCHES["selective_scan"] += 1
    return (y, h_out, chunks) if chunk_states else (y, h_out)


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    """The backward's library, with its C signatures declared once."""
    lib = _build.library("selective_scan_bwd")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.selective_scan_bwd_launch.argtypes = [ptr] * 13 + [i32] * 4 + [ptr]
    lib.selective_scan_bwd_launch.restype = ctypes.c_int
    lib.selective_scan_bwd_reduce_launch.argtypes = [ptr] * 5 + [i32] * 4 \
        + [ptr]
    lib.selective_scan_bwd_reduce_launch.restype = ctypes.c_int
    lib.selective_scan_bwd_blocks.argtypes = [i32]
    lib.selective_scan_bwd_blocks.restype = ctypes.c_int
    lib.selective_scan_bwd_error_string.argtypes = [ctypes.c_int]
    lib.selective_scan_bwd_error_string.restype = ctypes.c_char_p
    return lib


def check_backward_inputs(dt: torch.Tensor, x: torch.Tensor,
                          b_mat: torch.Tensor, c_mat: torch.Tensor,
                          a: torch.Tensor, chunks: torch.Tensor,
                          dy: torch.Tensor,
                          dh_t: torch.Tensor | None = None) -> None:
    """Raise ``ValueError`` unless the forward's inputs pass
    :func:`check_inputs`, ``dy`` matches x, ``chunks`` is the forward's
    (B, ceil(T / CHUNK), C, N) and ``dh_t`` (when given) (B, C, N), every
    one float32 and contiguous."""
    check_inputs(dt, x, b_mat, c_mat, a)
    b, t, c = x.shape
    n = a.shape[1]
    for name, v, shape in (("dy", dy, (b, t, c)),
                           ("chunks", chunks, (b, -(-t // CHUNK), c, n)),
                           ("dh_t", dh_t, (b, c, n))):
        if v is None and name == "dh_t":
            continue
        if not isinstance(v, torch.Tensor) or v.dtype != torch.float32 \
                or not v.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor")
        if tuple(v.shape) != shape:
            raise ValueError(f"{name} {tuple(v.shape)}, expected {shape}")


def selective_scan_backward(dt: torch.Tensor, x: torch.Tensor,
                            b_mat: torch.Tensor, c_mat: torch.Tensor,
                            a: torch.Tensor, chunks: torch.Tensor,
                            dy: torch.Tensor,
                            dh_t: torch.Tensor | None = None, *,
                            want_dh0: bool = False):
    """Gradients (ddt, dx, dBm, dCm, dA, dh0) of the scan from ``dy``
    (B, T, C) and ``dh_t`` (B, C, N; zeros when None), the forward's
    inputs and its ``chunks`` (``selective_scan(..., chunk_states=True)``);
    dh0 is None unless ``want_dh0``.  Two launches: the lanes, then the
    fixed-order sums of dBm, dCm and dA."""
    _build.refuse_grad("selective_scan_bwd",
                       (dt, x, b_mat, c_mat, a, chunks, dy, dh_t))
    check_backward_inputs(dt, x, b_mat, c_mat, a, chunks, dy, dh_t)
    check_devices(x, dt=dt, b_mat=b_mat, c_mat=c_mat, a=a, chunks=chunks,
                  dy=dy, dh_t=dh_t)
    b, t, c = x.shape
    n = a.shape[1]
    lib = _bwd_library()
    blocks = lib.selective_scan_bwd_blocks(c)
    f32 = dict(dtype=torch.float32, device=x.device)
    ddt, dx = torch.empty_like(x), torch.empty_like(x)
    dh0 = torch.empty((b, c, n), **f32) if want_dh0 else None
    dbc_part = torch.empty((b, blocks, t, 2 * n), **f32)
    da_part = torch.empty((b, c, n), **f32)
    d_bm, d_cm = torch.empty((b, t, n), **f32), torch.empty((b, t, n), **f32)
    da = torch.empty((c, n), **f32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.selective_scan_bwd_launch(
            dt.data_ptr(), x.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
            a.data_ptr(), chunks.data_ptr(), dy.data_ptr(), _ptr(dh_t),
            ddt.data_ptr(), dx.data_ptr(), _ptr(dh0), dbc_part.data_ptr(),
            da_part.data_ptr(), b, t, c, n, stream)
        if code == 0:
            LAUNCHES["selective_scan_bwd"] += 1
            code = lib.selective_scan_bwd_reduce_launch(
                dbc_part.data_ptr(), da_part.data_ptr(), d_bm.data_ptr(),
                d_cm.data_ptr(), da.data_ptr(), b, t, c, n, stream)
            if code == 0:
                LAUNCHES["selective_scan_bwd_reduce"] += 1
    if code != 0:
        msg = lib.selective_scan_bwd_error_string(code).decode()
        raise RuntimeError(f"selective_scan_bwd launch failed: {msg}")
    return ddt, dx, d_bm, d_cm, da, dh0
