"""The tensor-core flash kernel's D = 80 instantiation at two K/V ring
depths, on the card.

    python -m repro_torch.benchmarks.bench_flash_stages [--quick]
                                                        [--out PATH]

``csrc/flash_attention_wgmma.cu`` fixes its K/V ring depth at D = 80 in
one constant, ``kStagesD80``.  This builds the source twice with the
port's nvcc flags into a temporary directory, that constant set to 2 and
to 3 stages (about 101 KB and 141 KB of shared memory a block), checks
each against the plain version (``kernels/ref.py``) within the bf16
tolerance 2e-2, and times both at hubert-xlarge's attention (B = 4, T =
2,048, 16 / 16 heads, D = 80, bidirectional, bf16) with CUDA events in
turns: 2, 3, 3, 2 (``--quick``: B = 1, T = 512).  Reports what ptxas said
of each build (registers, spills).  Runs on the card only.
"""
from __future__ import annotations

import ctypes
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from repro_torch.benchmarks import cli
from repro_torch.benchmarks.timing import attention_bound, device_ms
from repro_torch.kernels import _build, ref
from repro_torch.kernels import flash_attention as fa

FULL = (4, 2048, 2048, 16, 16, 80, False, 0)
QUICK = (1, 512, 512, 16, 16, 80, False, 0)
STAGES = (2, 3)
TOL = 2e-2
CONSTANT = re.compile(r"constexpr int kStagesD80 = \d+;")


def _build_depth(stages: int, out_dir: Path) -> tuple[ctypes.CDLL, str]:
    """The wgmma source with ``kStagesD80 = stages``, built and loaded."""
    src = (_build.CSRC / "flash_attention_wgmma.cu").read_text()
    if len(CONSTANT.findall(src)) != 1:
        raise RuntimeError("kStagesD80 is not one constant in the source")
    path = out_dir / f"flash_attention_wgmma_s{stages}.cu"
    path.write_text(CONSTANT.sub(f"constexpr int kStagesD80 = {stages};",
                                 src))
    target = path.with_suffix(".so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(target), str(path)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {stages} stages:\n"
                           f"{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(target)), proc.stdout + proc.stderr


def _ptxas_d80(log: str) -> dict:
    """Registers and spill bytes ptxas reported for the D = 80 kernel."""
    (found,) = [v for k, v in _build.parse_ptxas(log).items()
                if "flash_attention_wgmma_kernelILi80E" in k]
    return {"registers": found.get("registers"),
            "spill_bytes": found.get("spill_stores", 0)
            + found.get("spill_loads", 0)}


def run(quick: bool = False, device: str | None = None) -> dict:
    dev = torch.device(device or "cuda")
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("bench_flash_stages times the CUDA kernel: it "
                           "needs a card")
    case = QUICK if quick else FULL
    causal = case[6]
    g = torch.Generator(device=dev).manual_seed(124)
    b, t, _, hq, hkv, d = case[:6]
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
               for shape in ((b, t, hq, d), (b, t, hkv, d), (b, t, hkv, d)))
    want = ref.flash_attention(q, k, v, causal=causal).float()
    bound_ms, bound_by, flops = attention_bound(*case, itemsize=2)
    result = {"card": cli.nvidia_smi(), "torch": torch.__version__,
              "shape": list(case), "bound_ms": bound_ms,
              "bound_by": bound_by, "bound_ms_issued": 1.5 * bound_ms,
              "stages": {}}
    with tempfile.TemporaryDirectory() as tmp:
        calls = {}
        for stages in STAGES:
            lib, log = _build_depth(stages, Path(tmp))
            entry = fa._bind(lib, "wgmma")

            def call(entry=entry):
                return fa._launch_form("wgmma", q, k, v, causal=causal,
                                       sliding_window=0, entry=entry)

            got = call().float()
            torch.cuda.synchronize()
            excess = ((got - want).abs() - (TOL + TOL * want.abs())).max()
            calls[stages] = call
            result["stages"][stages] = {
                "ptxas": _ptxas_d80(log),
                "max_abs_err": (got - want).abs().max().item(),
                "within_tolerance": bool(excess <= 0), "ms": []}
        for stages in (*STAGES, *reversed(STAGES)):
            result["stages"][stages]["ms"].append(
                device_ms(calls[stages], reps=20, inner=10))
    for entry in result["stages"].values():
        entry["ms_median"] = statistics.median(entry["ms"])
        entry["tflop_per_s"] = flops / (entry["ms_median"] * 1e-3) / 1e12
    return result


def ok(result: dict) -> bool:
    return all(e["within_tolerance"] and e["ptxas"].get("spill_bytes") == 0
               for e in result["stages"].values())


def main(argv: list[str] | None = None) -> int:
    return cli.main(run, __doc__, argv, ok)


if __name__ == "__main__":
    sys.exit(main())
