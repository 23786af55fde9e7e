"""Render the one-card dry-run and roofline tables from
``benchmarks/results/dryrun_h100/*.json`` (written by ``launch/dryrun.py``).

  PYTHONPATH=src python -m repro_torch.launch.report [--table roofline|dryrun]

The roofline table: the compute and memory terms at the H100's rates,
the bottleneck, model FLOPs over analytic FLOPs (MF/AF), analytic and
counted FLOPs, bytes a card and whether arguments + temp fit 80 GB.  The
dry-run table: trace seconds, argument and temp bytes, counted FLOPs.  One
card has no collective, so neither table has collective columns.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.dryrun import RESULTS_DIR, TAG
from repro_torch.launch.roofline import HBM_CAPACITY_BYTES

ARCH_ORDER = [
    "internlm2-1.8b", "llama3-405b", "olmoe-1b-7b", "qwen2-vl-7b",
    "hubert-xlarge", "deepseek-coder-33b", "jamba-1.5-large-398b",
    "qwen3-8b", "xlstm-1.3b", "llama4-maverick-400b-a17b",
]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(tag: str = "") -> list[dict]:
    """The committed cells (``<arch>__<shape>__h100[_tag].json``), in the
    reference's order."""
    suffix = f"__{TAG}{('_' + tag) if tag else ''}.json"
    rows = []
    for path in glob.glob(os.path.join(RESULTS_DIR, f"*{suffix}")):
        with open(path) as f:
            rows.append(json.load(f))
    rows.sort(key=lambda r: (ARCH_ORDER.index(r["arch"]),
                             SHAPE_ORDER.index(r["shape"])))
    return rows


def _fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def _fmt_n(x: float | None) -> str:
    return "-" if x is None else f"{x:.2e}"


def _table(hdr: list[str], rows: list[list]) -> str:
    lines = ["| " + " | ".join(hdr) + " |", "|" + "---|" * len(hdr)]
    lines += ["| " + " | ".join(str(c) for c in cells) + " |"
              for cells in rows]
    return "\n".join(lines)


def roofline_table(rows: list[dict]) -> str:
    hdr = ["arch", "shape", "kind", "compute", "memory", "bottleneck",
           "MF/AF", "AF", "counted F", "hbm/card", "fits80G"]
    out = []
    for r in rows:
        rf = r["roofline"]
        resident = r["fits_one_card"]["resident_bytes"]
        fits = ("Y" if resident <= HBM_CAPACITY_BYTES
                else f"N({resident / 1e9:.0f}G)")
        out.append([
            r["arch"], r["shape"], r["kind"],
            _fmt_s(rf["compute_s"]), _fmt_s(rf["memory_s"]),
            rf["bottleneck"], f"{rf['useful_flops_ratio']:.2f}",
            _fmt_n(rf["flops_per_chip"]), _fmt_n(rf["counted_flops"]),
            f"{rf['bytes_per_chip'] / 1e9:.1f}G", fits])
    return _table(hdr, out)


def dryrun_table(rows: list[dict]) -> str:
    hdr = ["arch", "shape", "traced groups", "trace_s", "args/card",
           "temp/card", "counted F", "counted bytes", "kernels"]
    out = []
    for r in rows:
        rf = r["roofline"]
        ma = r["memory_analysis"]
        kernels = ", ".join(f"{k} x{v['calls']:.0f}"
                            for k, v in sorted(r["kernels"].items())) or "-"
        out.append([
            r["arch"], r["shape"],
            f"{'+'.join(map(str, r['traced_groups']))} of {r['n_groups']}",
            f"{r['trace_s']:.1f}",
            f"{ma['argument_bytes'] / 1e9:.2f}G",
            f"{ma['temp_bytes'] / 1e9:.2f}G",
            _fmt_n(rf["counted_flops"]), _fmt_n(rf["counted_bytes"]),
            kernels])
    return _table(hdr, out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="")
    ap.add_argument("--table", default="roofline",
                    choices=["roofline", "dryrun"])
    args = ap.parse_args(argv)
    rows = load(args.tag)
    if args.table == "roofline":
        print(roofline_table(rows))
    else:
        print(dryrun_table(rows))


if __name__ == "__main__":
    main()
