"""The command line every benchmark of the port shares.

    python -m repro_torch.benchmarks.<name> [--quick] [--device D] [--out PATH]

prints the benchmark's result as JSON and writes it to ``--out`` when one
is given; without ``--device`` the benchmark runs on the card or raises.
"""
from __future__ import annotations

import argparse
import json
import subprocess
from typing import Callable


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main(run: Callable[..., dict], doc: str, argv: list[str] | None = None,
         ok: Callable[[dict], bool] | None = None) -> int:
    """Parse ``argv``, call ``run(quick=, device=)``, print (and write) its
    result; exit code 1 when ``ok`` rejects the result."""
    parser = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    parser.add_argument("--quick", action="store_true",
                        help="the reference's quick sizes")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card, or fail)")
    parser.add_argument("--out", default=None,
                        help="write the result as JSON to this path")
    args = parser.parse_args(argv)
    result = run(quick=args.quick, device=args.device)
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0 if ok is None or ok(result) else 1
