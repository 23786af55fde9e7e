"""The float32 tensor-core flash kernel against copies of its source with
one part of the work cut out, on the card.

    python -m repro_torch.benchmarks.bench_flash_tf32 [--quick] [--out PATH]

Builds ``csrc/flash_attention_tf32.cu`` and each copy in ``ABLATIONS``
with the port's nvcc flags into a temporary directory, checks the source
against the plain version (``kernels/ref.py``) within the float32
tolerance 5e-5, and times them all with CUDA events in turns (the source
and each copy, then the same in reverse) at qwen3-8b's float32 prefill
attention (B = 4, T = 2,048, 32 / 8 heads, D = 128, causal) and
hubert-xlarge's (B = 4, T = 2,048, 16 / 16 heads, D = 80, bidirectional);
``--quick``: T = 512.  A copy's output is wrong; its time says what the
part it cuts costs.  Reports what ptxas said of each build (registers,
spills) and each shape's bound (12·D flops a pair at the TF32 rate) with
each version's share of it.  Only the source must be within the tolerance
and spill nothing.  Runs on the card only.
"""
from __future__ import annotations

import statistics
import sys
import tempfile
from pathlib import Path

import torch

from repro_torch.benchmarks import cli, source_versions
from repro_torch.benchmarks.timing import attention_f32_bound
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

SOURCE = "flash_attention_tf32"
SHAPES = {"qwen3_8b": (4, 2048, 2048, 32, 8, 128, True, 0),
          "hubert_xlarge": (4, 2048, 2048, 16, 16, 80, False, 0)}
TOL = 5e-5

_SS_LOOP = """#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) {
        const uint32_t off = (ks % T::kSteps) * 32;
        const int box = ks / T::kSteps;
        wgmma_ss_n32(sacc, desc<T>(q_base + box * kBQ * kRowBytes + off),
                     desc<T>(khi + box * kBK * kRowBytes + off), ks > 0);
      }
"""
_K_LO = "wgmma_rs_n32(sacc, qh[ks], desc<T>(klo + off), 1);"
_K_HI = "wgmma_rs_n32(sacc, qh[ks], desc<T>(khi + off), 1);"
_PV_LO_TERMS = """#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
        wgmma_pv<D>(o, p_lo[j], desc<VT>(vhi + 32 * j));
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
        wgmma_pv<D>(o, p_hi[j], desc<VT>(vlo + 32 * j));
"""
# name -> the (text, replacement) edits of the source that cut one part
# (``source_versions.edited``: each text must occur once)
ABLATIONS = {
    "this": [],
    # S without Q_lo K_hi, the term whose A operand is read from shared
    # memory
    "no_ss_term": [(_SS_LOOP, ""),
                   (_K_LO, _K_LO.replace(", 1);", ", ks > 0);"))],
    # S in one term (Q_hi K_hi): two thirds of S's tensor work cut
    "s_one_term": [(_SS_LOOP, ""), (_K_LO, "(void)klo;"),
                   (_K_HI, _K_HI.replace(", 1);", ", ks > 0);"))],
    # P V in one term (P_hi V_hi)
    "pv_one_term": [(_PV_LO_TERMS, "(void)vlo;\n")],
    # no exponentials in the softmax
    "no_exp": [("sacc[i] = exp2f((sacc[i] - m_safe[r]) * kLog2e);",
                "sacc[i] = (sacc[i] - m_safe[r]) * kLog2e;")],
    # the producer splits nothing: the stages keep what they held
    "no_split": [("e < L::kTileBytes / 16; e += 128", "e < 0; e += 128"),
                 ("e < D * VT::kChunks; e += 128", "e < 0; e += 128")],
}


def run(quick: bool = False, device: str | None = None) -> dict:
    dev = torch.device(device or "cuda")
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("bench_flash_tf32 times the CUDA kernel: it "
                           "needs a card")
    result = {"card": cli.nvidia_smi(), "torch": torch.__version__,
              "versions": {}, "shapes": {}}
    with tempfile.TemporaryDirectory() as tmp:
        built = source_versions.build(SOURCE, ABLATIONS, Path(tmp))
        entries = {}
        for name, (lib, log) in built.items():
            entries[name] = fa._bind(lib, "tf32x3")
            result["versions"][name] = {"ptxas": source_versions.ptxas_by_dim(
                log, "flash_attention_tf32_kernel")}
        for shape_name, shape in SHAPES.items():
            if quick:
                shape = (shape[0], 512, 512, *shape[3:])
            b, tq, tk, hq, hkv, d, causal, _ = shape
            g = torch.Generator(device=dev).manual_seed(7)
            q, k, v = (torch.randn(s, generator=g, device=dev) for s in (
                (b, tq, hq, d), (b, tk, hkv, d), (b, tk, hkv, d)))
            want = ref.flash_attention(q, k, v, causal=causal)
            calls, entry = {}, {"shape": list(shape), "versions": {}}
            for name, bound in entries.items():
                def call(bound=bound):
                    return fa._launch_form("tf32x3", q, k, v, causal=causal,
                                           sliding_window=0, entry=bound)

                err, ok = source_versions.within(call(), want, TOL)
                calls[name] = call
                entry["versions"][name] = {"max_abs_err": err,
                                           "within_tolerance": ok}
            bound_ms, bound_by, _ = attention_f32_bound(*shape)
            entry.update(bound_ms=bound_ms, bound_by=bound_by)
            for name, ms in source_versions.in_turns(calls).items():
                median = statistics.median(ms)
                entry["versions"][name].update(
                    ms=ms, ms_median=median, share_of_bound=bound_ms / median)
            result["shapes"][shape_name] = entry
            del q, k, v, want
    return result


def ok(result: dict) -> bool:
    return (all(s["versions"]["this"]["within_tolerance"]
                for s in result["shapes"].values())
            and all(v["spill_bytes"] == 0 for v in
                    result["versions"]["this"]["ptxas"].values()))


def main(argv: list[str] | None = None) -> int:
    return cli.main(run, __doc__, argv, ok)


if __name__ == "__main__":
    raise SystemExit(main())
