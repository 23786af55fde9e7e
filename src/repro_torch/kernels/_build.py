"""Build the port's CUDA sources with nvcc at first use; load them with ctypes.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface, so it compiles
in seconds without PyTorch's headers and binds through ``ctypes``.  The
shared library goes to ``build/repro_torch/`` at the repository root, named
by a hash of the source, the headers of ``csrc/`` and the flags: an edited
source or header rebuilds, an unchanged one is loaded as built.  Nothing
here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

# name -> loaded library / seconds its nvcc took (0.0 when it was reused) /
# what nvcc printed (ptxas lists registers, shared memory and spills)
_LIBS: dict[str, ctypes.CDLL] = {}
# launches of each hand-written kernel, counted by its wrapper where it
# launches the kernel (``ops.LAUNCHES`` is this dict)
LAUNCHES: dict[str, int] = {"score_pipeline_banked": 0,
                             "flash_attention": 0,
                             "flash_attention_wgmma": 0,
                             "flash_attention_tf32x3": 0,
                             "quantile_map": 0,
                             "score_pipeline": 0,
                             "decode_attention": 0,
                             "selective_scan": 0,
                             "selective_scan_bwd": 0,
                             "selective_scan_bwd_reduce": 0}
BUILD_SECONDS: dict[str, float] = {}
BUILD_LOGS: dict[str, str] = {}
_LOCK = threading.Lock()


def refuse_grad(kernel: str, tensors, hint: str = "") -> None:
    """Raise ``RuntimeError`` when grad mode is on and a given tensor
    requires grad.  A kernel launched through ctypes returns a tensor with
    no ``grad_fn``, so its output would cut the gradient without an error;
    the JAX package cannot differentiate its Pallas calls either."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel has no backward, and an input "
            f"requires grad{hint}; run it under torch.no_grad()")


def sources() -> list[str]:
    """Names of every CUDA source of the port."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    # every header of csrc/ counts too, so an edited header rebuilds
    src = b"".join(p.read_bytes() for p in
                   [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path, float] | None:
    """Start nvcc for ``name`` unless its library is already built."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target, time.perf_counter()


def _finish(name: str, job) -> None:
    if job is None:
        BUILD_SECONDS.setdefault(name, 0.0)
        return
    proc, tmp, target, t0 = job
    log, _ = proc.communicate()
    BUILD_SECONDS[name] = time.perf_counter() - t0
    BUILD_LOGS[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    target.with_suffix(".log").write_text(log)
    os.replace(tmp, target)  # atomic: a reader never sees half a library


def build_all(names: list[str] | None = None) -> dict[str, float]:
    """Compile every named source (default: all), one nvcc each, all
    started together; returns name -> build seconds."""
    names = sources() if names is None else names
    with _LOCK:
        jobs = {n: _start(n) for n in names if n not in _LIBS}
        for n, job in jobs.items():
            _finish(n, job)
    return {n: BUILD_SECONDS.get(n, 0.0) for n in names}


def build_log(name: str) -> tuple[Path, str]:
    """The built library of ``csrc/<name>.cu`` and what nvcc printed when
    it was built (ptxas's registers, shared memory and spills)."""
    build_all([name])
    target = _target(name)
    return target, target.with_suffix(".log").read_text()


def ptxas_report(name: str) -> dict[str, dict[str, int]]:
    """Each kernel of ``csrc/<name>.cu`` (by its mangled name) and what
    ptxas said of it: ``registers``, ``stack_frame``, ``spill_stores`` and
    ``spill_loads`` (bytes)."""
    return parse_ptxas(build_log(name)[1])


def parse_ptxas(log: str) -> dict[str, dict[str, int]]:
    """:func:`ptxas_report` of what nvcc printed for one build."""
    report: dict[str, dict[str, int]] = {}
    current = None
    for line in log.splitlines():
        found = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?([\w$.]+)'?", line)
        if found:
            current = report.setdefault(found.group(1), {})
            continue
        if current is None:
            continue
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
        if frame:
            current.update(zip(("stack_frame", "spill_stores",
                                "spill_loads"), map(int, frame.groups())))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            current["registers"] = int(regs.group(1))
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(_target(name)))
        return _LIBS[name]
