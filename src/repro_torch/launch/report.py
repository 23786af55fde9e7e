"""Render the dry-run and roofline tables from
``benchmarks/results/dryrun_h100/*.json`` (written by ``launch/dryrun.py``).

  PYTHONPATH=src python -m repro_torch.launch.report [--table roofline|dryrun]
  PYTHONPATH=src python -m repro_torch.launch.report --pod pod1|pod2

The roofline table: the compute and memory terms at the H100's rates,
the bottleneck, model FLOPs over analytic FLOPs (MF/AF), analytic and
counted FLOPs, bytes a card and whether arguments + temp fit 80 GB.  The
dry-run table: trace seconds, argument and temp bytes, counted FLOPs.  One
card has no collective, so neither table has collective columns.

``--pod`` reads the pod records (``<arch>__<shape>__h100_pod1.json`` /
``_pod2.json``, one rank of the mesh) beside the one-card ones: per-rank
FLOPs, HBM bytes and collective bytes (the roofline's, an all-reduce
counted twice) with the three terms and the bottleneck, the collectives by
kind, and beside them the reference's HLO collective bytes of the same
cell where its record (``benchmarks/results/dryrun/<arch>__<shape>__podN
.json``) is present: bytes only, its times are the TPU's.

``--pod pod1 --variant opt`` sets each record of a ``--variant`` bundle
(``<arch>__<shape>__h100_pod1_opt.json``) beside the baseline record of
the same cell: resident bytes a rank and whether they fit 80 GB, the
all-gather, all-reduce, reduce-scatter and all-to-all bytes and the
collective term, baseline -> variant.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.dryrun import RESULTS_DIR, TAG
from repro_torch.launch.roofline import HBM_CAPACITY_BYTES

REFERENCE_DIR = os.path.join(RESULTS_DIR, "..", "dryrun")

ARCH_ORDER = [
    "internlm2-1.8b", "llama3-405b", "olmoe-1b-7b", "qwen2-vl-7b",
    "hubert-xlarge", "deepseek-coder-33b", "jamba-1.5-large-398b",
    "qwen3-8b", "xlstm-1.3b", "llama4-maverick-400b-a17b",
]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(tag: str = "", directory: str = RESULTS_DIR) -> list[dict]:
    """The committed cells (``<arch>__<shape>__h100[_tag].json``), in the
    reference's order."""
    suffix = f"__{TAG}{('_' + tag) if tag else ''}.json"
    rows = []
    for path in glob.glob(os.path.join(directory, f"*{suffix}")):
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


def reference_collectives(arch: str, shape: str, pod: str,
                          directory: str | None = REFERENCE_DIR
                          ) -> float | None:
    """The reference's HLO collective bytes a chip of the same cell (its
    ``collective_bytes_per_chip``), or None without its record."""
    if directory is None:
        return None
    path = os.path.join(directory, f"{arch}__{shape}__{pod}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)["roofline"]["collective_bytes_per_chip"]


def _kinds(by_kind: dict, counts: dict) -> str:
    return ", ".join(f"{k} {counts[k]:.0f}x {v / 1e9:.2f}G"
                     for k, v in sorted(by_kind.items()))


def pod_table(rows: list[dict], pod: str,
              reference_dir: str | None = REFERENCE_DIR) -> str:
    hdr = ["arch", "shape", "fsdp", "flops/rank", "hbm/rank", "coll/rank",
           "compute", "memory", "collective", "bottleneck", "args/rank",
           "by kind", "reference HLO coll/chip"]
    out = []
    for r in rows:
        rf = r["roofline"]
        ref = reference_collectives(r["arch"], r["shape"], pod,
                                    reference_dir)
        out.append([
            r["arch"], r["shape"], "Y" if r["fsdp"] else "N",
            _fmt_n(rf["flops_per_chip"]),
            f"{rf['bytes_per_chip'] / 1e9:.2f}G",
            f"{rf['collective_bytes_per_chip'] / 1e9:.2f}G",
            _fmt_s(rf["compute_s"]), _fmt_s(rf["memory_s"]),
            _fmt_s(rf["collective_s"]), rf["bottleneck"],
            f"{r['memory_analysis']['argument_bytes'] / 1e9:.2f}G",
            _kinds(rf["collective_bytes_by_kind"], rf["collective_counts"]),
            "-" if ref is None else f"{ref / 1e9:.2f}G"])
    return _table(hdr, out)


def _pair(a: float, b: float, unit: float = 1e9, fmt: str = "{:.2f}"
          ) -> str:
    return f"{fmt.format(a / unit)} -> {fmt.format(b / unit)}"


def variant_table(pod: str, variant: str,
                  directory: str = RESULTS_DIR) -> str:
    """Each ``variant`` record of ``pod`` beside its baseline record:
    resident GB a rank, fits 80 GB, all-gather / all-reduce /
    reduce-scatter / all-to-all GB and the collective term, baseline ->
    variant."""
    base = {(r["arch"], r["shape"]): r for r in load(pod, directory)}
    hdr = ["arch", "shape", "resident/rank", "fits80G", "all-gather",
           "all-reduce", "reduce-scatter", "all-to-all", "collective"]
    out = []
    for r in load(f"{pod}_{variant}", directory):
        b = base.get((r["arch"], r["shape"]))
        if b is None:
            continue
        kinds = [(b["collectives"]["bytes_by_kind"].get(k, 0.0),
                  r["collectives"]["bytes_by_kind"].get(k, 0.0))
                 for k in ("all-gather", "all-reduce", "reduce-scatter",
                           "all-to-all")]
        fit = ["Y" if x["fits_one_card"]["80GB"] else "N" for x in (b, r)]
        out.append([
            r["arch"], r["shape"],
            _pair(b["fits_one_card"]["resident_bytes"],
                  r["fits_one_card"]["resident_bytes"]),
            " -> ".join(fit), *(_pair(x, y) for x, y in kinds),
            " -> ".join(_fmt_s(x["roofline"]["collective_s"])
                        for x in (b, r))])
    return _table(hdr, out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="")
    ap.add_argument("--table", default="roofline",
                    choices=["roofline", "dryrun"])
    ap.add_argument("--pod", choices=["pod1", "pod2"], default=None,
                    help="the pod records of one rank of that mesh")
    ap.add_argument("--variant", default=None,
                    help="with --pod: a --variant bundle's records beside "
                         "the baseline's")
    args = ap.parse_args(argv)
    if args.pod and args.variant:
        print(variant_table(args.pod, args.variant))
        return
    if args.pod:
        tag = args.pod + (f"_{args.tag}" if args.tag else "")
        print(pod_table(load(tag), args.pod))
        return
    rows = load(args.tag)
    if args.table == "roofline":
        print(roofline_table(rows))
    else:
        print(dryrun_table(rows))


if __name__ == "__main__":
    main()
