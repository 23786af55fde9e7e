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

import re
import statistics
import sys
import tempfile
from pathlib import Path

import torch

from repro_torch.benchmarks import cli, source_versions
from repro_torch.benchmarks.timing import attention_bound
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

FULL = (4, 2048, 2048, 16, 16, 80, False, 0)
QUICK = (1, 512, 512, 16, 16, 80, False, 0)
STAGES = (2, 3)
TOL = 2e-2
CONSTANT = re.compile(r"constexpr int kStagesD80 = \d+;")


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
        built = source_versions.build("flash_attention_wgmma", {
            stages: [(CONSTANT, f"constexpr int kStagesD80 = {stages};")]
            for stages in STAGES}, Path(tmp))
        calls = {}
        for stages, (lib, log) in built.items():
            entry = fa._bind(lib, "wgmma")

            def call(entry=entry):
                return fa._launch_form("wgmma", q, k, v, causal=causal,
                                       sliding_window=0, entry=entry)

            err, ok = source_versions.within(call(), want, TOL)
            calls[stages] = call
            result["stages"][stages] = {
                "ptxas": source_versions.ptxas_by_dim(
                    log, "flash_attention_wgmma_kernel")[80],
                "max_abs_err": err, "within_tolerance": ok}
        for stages, ms in source_versions.in_turns(calls).items():
            result["stages"][stages]["ms"] = ms
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
