"""The Mamba scan's two kernels at jamba-1.5-large's shape, on the card.

    python -m repro_torch.benchmarks.bench_scan [--quick] [--against DIR]
                                                [--out PATH]

Checks the forward (``csrc/selective_scan.cu``) and the backward
(``csrc/selective_scan_bwd.cu``) against their plain versions
(``kernels/ref.py``) on small cases, every N from 1 to 16, and at the
timed shapes: the forward's h_T and chunk states and every gradient of the
backward bitwise, y within 2e-5.  Then times each with CUDA events over
back-to-back launches (``timing.device_ms``): the forward at a prefill's
(4, 2,048, 16,384, 16) from zeros and a decode step's (4, 1, 16,384, 16)
with its state in place, the backward at the training shape from the
forward's checkpoints.  ``--quick`` times (2, 512, 4,096, 16) instead.

``--against DIR`` also builds ``DIR/selective_scan.cu`` and
``DIR/selective_scan_bwd.cu`` (another version of the two kernels with the
same C interface; one without ``selective_scan_chunk`` saves a state
every 64 steps) with the port's nvcc flags into a temporary directory, and
times both versions in turns in this process: theirs, this, this, theirs.
Also reports what ptxas said of every kernel (registers, stack frame,
spill bytes).  Runs on the card only.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from repro_torch.benchmarks import cli
from repro_torch.benchmarks.timing import (device_ms, selective_scan_bound,
                                           selective_scan_bwd_bound)
from repro_torch.kernels import _build, ref
from repro_torch.kernels import selective_scan as ss

TOL = 2e-5
FULL = (4, 2048, 16384, 16)
QUICK = (2, 512, 4096, 16)
# (B, T, C, N): T = 1, T no multiple of 16 or 64, C no multiple of the
# 128-channel block (nor of a warp's 8), every N from 1 to 16
SMALL = [(2, 1 + 23 * (n % 4), 33 + 40 * n, n) for n in range(1, 17)] \
    + [(3, 300, 130, 16), (1, 64, 256, 8)]


def _inputs(dev, b, t, c, n, given, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = 0.001 + 0.1 * torch.rand((b, t, c), generator=g, device=dev)
    x, bm, cm = (torch.randn(shape, generator=g, device=dev)
                 for shape in ((b, t, c), (b, t, n), (b, t, n)))
    a = -torch.arange(1, n + 1, dtype=torch.float32, device=dev).repeat(c, 1)
    h0 = torch.randn((b, c, n), generator=g, device=dev) if given else None
    return [dt, x, bm, cm, a, h0]


def _err(got, want) -> float:
    """Largest |got - want| over TOL + TOL |want| (1 is the limit)."""
    return ((got - want).abs() / (TOL + TOL * want.abs())).max().item()


def _check(dev, b, t, c, n, seed) -> dict:
    """Forward and backward against their plain versions at one shape."""
    args = _inputs(dev, b, t, c, n, seed % 2 == 0, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    dy = torch.randn((b, t, c), generator=g, device=dev)
    dh_t = torch.randn((b, c, n), generator=g, device=dev) \
        if seed % 3 else None
    y, h, chunks = ss.selective_scan(*args, chunk_states=True)
    want_y, want_h, want_chunks = ref.selective_scan(*args,
                                                     chunk_states=True)
    got = ss.selective_scan_backward(*args[:5], chunks, dy, dh_t,
                                     want_dh0=args[5] is not None)
    want = ref.selective_scan_backward(*args[:5], chunks, dy, dh_t,
                                       want_dh0=args[5] is not None)
    torch.cuda.synchronize()
    return {"shape": [b, t, c, n], "y_of_tol": _err(y, want_y),
            "h_bitwise": bool(torch.equal(h, want_h)),
            "chunks_bitwise": bool(torch.equal(chunks, want_chunks)),
            "grads_bitwise": all(torch.equal(gv, w) for gv, w in
                                 zip(got, want) if w is not None)}


def _other_version(src_dir: Path, out_dir: Path) -> dict:
    """The two kernels of ``src_dir`` built with the port's flags, each
    with its C signatures declared; ``chunk`` its checkpoint spacing."""
    libs = {}
    for name in ("selective_scan", "selective_scan_bwd"):
        target = out_dir / f"{name}.so"
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                        str(target), str(src_dir / f"{name}.cu")],
                       check=True, capture_output=True, text=True)
        libs[name] = ctypes.CDLL(str(target))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fwd, bwd = libs["selective_scan"], libs["selective_scan_bwd"]
    for fn, args in ((fwd.selective_scan_launch, [ptr] * 9 + [i32] * 4),
                     (bwd.selective_scan_bwd_launch, [ptr] * 13 + [i32] * 4),
                     (bwd.selective_scan_bwd_reduce_launch,
                      [ptr] * 5 + [i32] * 4)):
        fn.argtypes, fn.restype = args + [ptr], i32
    bwd.selective_scan_bwd_blocks.argtypes = [i32]
    bwd.selective_scan_bwd_blocks.restype = i32
    chunk = 64
    if hasattr(fwd, "selective_scan_chunk"):
        fwd.selective_scan_chunk.argtypes = []
        fwd.selective_scan_chunk.restype = i32
        chunk = fwd.selective_scan_chunk()
    return {"fwd": fwd, "bwd": bwd, "chunk": chunk}


def _other_calls(other: dict, args, dy):
    """(forward, backward) calls of the other version at ``args``, the
    backward from that version's own checkpoints."""
    dt, x, bm, cm, a, h0 = args
    b, t, c = x.shape
    n = a.shape[1]
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)   # h_T in place of h0 when given, as a decode
    h = h0 if h0 is not None else torch.empty((b, c, n), **f32)
    chunks = torch.empty((b, -(-t // other["chunk"]), c, n), **f32)
    blocks = other["bwd"].selective_scan_bwd_blocks(c)
    ddt, dx = torch.empty_like(x), torch.empty_like(x)
    dbc = torch.empty((b, blocks, t, 2 * n), **f32)
    da_part = torch.empty((b, c, n), **f32)
    d_bm, d_cm = torch.empty((b, t, n), **f32), torch.empty((b, t, n), **f32)
    da = torch.empty((c, n), **f32)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def forward(with_chunks=False):
        code = other["fwd"].selective_scan_launch(
            dt.data_ptr(), x.data_ptr(), bm.data_ptr(), cm.data_ptr(),
            a.data_ptr(), h0.data_ptr() if h0 is not None else None,
            y.data_ptr(), h.data_ptr(),
            chunks.data_ptr() if with_chunks else None, b, t, c, n, stream())
        assert code == 0, code

    def backward():
        code = other["bwd"].selective_scan_bwd_launch(
            dt.data_ptr(), x.data_ptr(), bm.data_ptr(), cm.data_ptr(),
            a.data_ptr(), chunks.data_ptr(), dy.data_ptr(), None,
            ddt.data_ptr(), dx.data_ptr(), None, dbc.data_ptr(),
            da_part.data_ptr(), b, t, c, n, stream())
        code = code or other["bwd"].selective_scan_bwd_reduce_launch(
            dbc.data_ptr(), da_part.data_ptr(), d_bm.data_ptr(),
            d_cm.data_ptr(), da.data_ptr(), b, t, c, n, stream())
        assert code == 0, code

    forward(with_chunks=True)
    return forward, backward


def _turns(this, other, **kw) -> dict:
    """Times of ``this`` and ``other`` taken as other, this, this, other."""
    if other is None:
        return {"ms": [device_ms(this, **kw)]}
    first = device_ms(other, **kw)
    mine = [device_ms(this, **kw), device_ms(this, **kw)]
    return {"ms": mine, "against_ms": [first, device_ms(other, **kw)]}


def _card(device: str | None) -> torch.device:
    dev = torch.device(device or "cuda")
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("bench_scan times the CUDA kernels: it needs a "
                           "card")
    return dev


def run(quick: bool = False, device: str | None = None,
        against: str | None = None) -> dict:
    dev = _card(device)
    _build.build_all(["selective_scan", "selective_scan_bwd"])
    ptxas = {name: _build.ptxas_report(name)
             for name in ("selective_scan", "selective_scan_bwd")}
    cases = [_check(dev, *shape, seed=i) for i, shape in enumerate(SMALL)]
    b, t, c, n = QUICK if quick else FULL
    result = {"card": cli.nvidia_smi(), "shape": [b, t, c, n],
              "ptxas": ptxas, "cases": cases}
    with tempfile.TemporaryDirectory() as tmp:
        other = _other_version(Path(against), Path(tmp)) if against else None
        # a prefill: from zeros, no checkpoints
        args = _inputs(dev, b, t, c, n, False, seed=7)
        dy = torch.randn((b, t, c), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(8))
        y, h = ss.selective_scan(*args)
        want_y, want_h = ref.selective_scan(*args)
        calls = _other_calls(other, args, dy) if other else (None, None)
        result["forward"] = {
            "y_of_tol": _err(y, want_y),
            "h_bitwise": bool(torch.equal(h, want_h)),
            "bound_ms": selective_scan_bound(b, t, c, n)[0],
            **_turns(lambda: ss.selective_scan(*args), calls[0], reps=10,
                     inner=5)}
        del y, h, want_y, want_h
        # the training step's backward, from the forward's checkpoints
        _, _, chunks = ss.selective_scan(*args, chunk_states=True)
        got = ss.selective_scan_backward(*args[:5], chunks, dy)
        want = ref.selective_scan_backward(*args[:5], chunks, dy)
        result["backward"] = {
            "grads_bitwise": all(torch.equal(g, w) for g, w in
                                 zip(got, want) if w is not None),
            "bound_ms": selective_scan_bwd_bound(b, t, c, n)[0],
            **_turns(lambda: ss.selective_scan_backward(*args[:5], chunks,
                                                        dy),
                     calls[1], reps=5, inner=3)}
        del got, want, chunks, calls
        torch.cuda.empty_cache()
        # a decode step: T = 1, the state updated in place
        step = _inputs(dev, b, 1, c, n, True, seed=9)
        state = step[5]
        other_step = _other_calls(other, step, step[1])[0] if other else None
        result["decode_step"] = _turns(
            lambda: ss.selective_scan(*step[:5], state, state_out=state),
            other_step, reps=20, inner=50)
    for part in ("forward", "backward"):
        r = result[part]
        r["share_of_bound"] = r["bound_ms"] / min(r["ms"])
    return result


def ok(result: dict) -> bool:
    """Every case and timed shape as the contract says, and no backward
    kernel spills."""
    cases = result["cases"]
    spills = any(v.get("stack_frame", 0) or v.get("spill_stores", 0)
                 or v.get("spill_loads", 0)
                 for v in result["ptxas"]["selective_scan_bwd"].values())
    return (not spills
            and all(c["y_of_tol"] <= 1 and c["h_bitwise"]
                    and c["chunks_bitwise"] and c["grads_bitwise"]
                    for c in cases)
            and result["forward"]["y_of_tol"] <= 1
            and result["forward"]["h_bitwise"]
            and result["backward"]["grads_bitwise"])


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    against = None
    if "--against" in argv:
        i = argv.index("--against")
        against = argv[i + 1]
        del argv[i:i + 2]
    return cli.main(lambda quick, device: run(quick, device, against),
                    __doc__, argv, ok=ok)


if __name__ == "__main__":
    raise SystemExit(main())
