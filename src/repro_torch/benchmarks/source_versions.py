"""Edited copies of a CUDA source of the port, built and timed in turns on
the card: what ``bench_flash_stages`` (the D = 80 ring depth) and
``bench_flash_tf32`` (the float32 form's ablations) share.

A version is the source with text edits applied, each of which must match
exactly once.  The versions are written to a given directory and built
there with the port's nvcc flags (``csrc/`` on the include path), one nvcc
each, all started together; each build is then loaded with ctypes.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
from pathlib import Path

import torch

from repro_torch.benchmarks.timing import device_ms
from repro_torch.kernels import _build


def edited(text: str, edits) -> str:
    """``text`` with each ``(old, new)`` of ``edits`` applied in turn;
    ``old``, a string or a compiled pattern, must occur exactly once, else
    ``ValueError``."""
    for old, new in edits:
        pattern = old if isinstance(old, re.Pattern) else re.compile(
            re.escape(old))
        found = len(pattern.findall(text))
        if found != 1:
            raise ValueError(f"{pattern.pattern!r} occurs {found} times in "
                             "the source, not once")
        text = pattern.sub(lambda _: new, text)
    return text


def build(source: str, versions: dict, out_dir: Path
          ) -> dict[object, tuple[ctypes.CDLL, str]]:
    """Each version of ``csrc/<source>.cu`` (name -> its edits, ``[]`` for
    the source as it is), built into ``out_dir`` and loaded: name ->
    (library, what nvcc printed).  Raises ``ValueError`` before anything is
    built if an edit does not apply, ``RuntimeError`` if a version does not
    build."""
    text = (_build.CSRC / f"{source}.cu").read_text()
    texts = {name: edited(text, edits) for name, edits in versions.items()}
    jobs = {}
    for name, version in texts.items():
        src = out_dir / f"{source}_{name}.cu"
        src.write_text(version)
        target = src.with_suffix(".so")
        jobs[name] = target, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(target), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {name: proc.communicate()[0] for name, (_, proc) in jobs.items()}
    failed = [name for name, (_, proc) in jobs.items() if proc.returncode]
    if failed:
        raise RuntimeError(f"nvcc failed for {failed[0]}:\n{logs[failed[0]]}")
    return {name: (ctypes.CDLL(str(target)), logs[name])
            for name, (target, _) in jobs.items()}


def ptxas_by_dim(log: str, kernel: str) -> dict[int, dict]:
    """What ptxas reported in ``log`` for each head-dim instantiation
    ``kernel<D>``: D -> {registers, stack_frame_bytes, spill_bytes}."""
    out = {}
    for name, v in _build.parse_ptxas(log).items():
        found = re.search(kernel + r"ILi(\d+)E", name)
        if found:
            out[int(found.group(1))] = {
                "registers": v.get("registers"),
                "stack_frame_bytes": v.get("stack_frame", 0),
                "spill_bytes": v.get("spill_stores", 0)
                + v.get("spill_loads", 0)}
    return out


def within(got: torch.Tensor, want: torch.Tensor, tol: float
           ) -> tuple[float, bool]:
    """The largest |got - want| and whether every element is within
    ``tol + tol * |want|``."""
    diff = (got.float() - want.float()).abs()
    return diff.max().item(), bool(
        (diff <= tol + tol * want.float().abs()).all())


def in_turns(calls: dict, *, reps: int = 20, inner: int = 10
             ) -> dict[object, list[float]]:
    """Each call timed by :func:`device_ms`, the names in order and then in
    reverse: name -> its two times (ms)."""
    ms = {name: [] for name in calls}
    for name in [*calls, *reversed(calls)]:
        ms[name].append(device_ms(calls[name], reps=reps, inner=inner))
    return ms
