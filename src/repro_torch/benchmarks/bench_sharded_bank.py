"""Tenant-sharded transform banks: per-shard residency and dispatch
throughput.

The port's counterpart of the reference's ``benchmarks/bench_sharded_bank.py``,
at its sizes and seed: K = 4 experts, N = 256 knots, batch 8,192 (2,048
with ``--quick``), tenants T in {256, 1,024, 4,096} ({256, 1,024}), shards
S in {1, 2, 4, 8}, ``default_rng(0)``.

  * **residency** — a shard holds ``Tl·(2K+2N)·4`` bank bytes, 1/S of the
    dense bank at round-robin occupancy: at S = 8, 66,560 / 266,240 /
    1,064,960 bytes against the dense 532,480 / 2,129,920 / 8,519,680;
  * **throughput** — the shard-bucketed dispatch against the dense launch
    at the same batch: host wall time of a whole round trip (the dense row
    uploads the window, launches the banked kernel once and downloads the
    scores; the sharded row buckets and packs on the host first, then does
    the same over every shard's rows in ONE launch).

Every sharded row is checked BITWISE equal to the dense launch before it is
timed, and on the card each call is held to one banked launch; each row
reports its launches a call and the ``banked_path`` the launch took (which
of the kernel's two forms ``kernels/score_pipeline.py::banked_path``
picks for the rows and the bank the launch reads).  On the card (the
default) the times are the card's; with ``--device cpu`` the same code runs
the plain versions on the CPU: that run shows the entry point works and
measures nothing of the card.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_sharded_bank \\
        [--quick] [--device cpu] [--out PATH]
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from repro_torch.benchmarks import cli
from repro_torch.core.transforms import ShardedTransformBank, TransformBank
from repro_torch.device import resolve_device, to_numpy
from repro_torch.kernels import ops
from repro_torch.kernels import score_pipeline as sp
from repro_torch.launch.mesh import make_tenant_mesh
from repro_torch.serving.server import ShardedBankDispatcher, _shape_bucket

K, N = 4, 256
SHARD_COUNTS = (1, 2, 4, 8)


def _timeit(fn, repeat: int) -> float:
    """Mean host seconds of ``fn`` over ``repeat`` calls after a warm-up
    call (each call ends with its scores on the host)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(repeat):
        fn()
    return (time.perf_counter() - t0) / repeat


def random_bank(rng, t: int, device) -> TransformBank:
    """The reference benchmark's bank: uniform betas and weights, sorted
    uniform tables (drawn in float64, stored in float32)."""
    return TransformBank(*(torch.tensor(a, dtype=torch.float32, device=device)
                           for a in (
        rng.uniform(0.05, 1.0, (t, K)), rng.uniform(0.1, 2.0, (t, K)),
        np.sort(rng.uniform(0, 1, (t, N)), -1),
        np.sort(rng.uniform(0, 1, (t, N)), -1))))


def _path(dev, t: int, m: int) -> str:
    """The form of the banked kernel one launch of M rows over a T-row bank
    takes ("plain" on the CPU, where no kernel launches)."""
    if dev.type != "cuda":
        return "plain"
    return sp.banked_path(t, N, m, *sp.card(dev))


def _launched(fn) -> tuple[np.ndarray, int]:
    """``fn()`` and the banked launches it made."""
    before = ops.LAUNCHES["score_pipeline_banked"]
    out = fn()
    return out, ops.LAUNCHES["score_pipeline_banked"] - before


def sharded_row(disp: ShardedBankDispatcher, sbank: ShardedTransformBank,
                scores: np.ndarray, tid: np.ndarray, dense: np.ndarray,
                repeat: int) -> dict:
    """One sharded configuration: bitwise parity with ``dense`` (raises
    otherwise), launches a call, the kernel form, the time."""
    dev = disp.mesh.device
    got, launches = _launched(lambda: disp(scores, tid, sbank))
    differ = int(np.sum(got.view(np.uint32) != dense.view(np.uint32)))
    if differ:
        raise RuntimeError(f"S={sbank.num_shards}, T={sbank.num_rows}: "
                           f"{differ} of {len(tid)} scores differ from the "
                           f"dense launch")
    if dev.type == "cuda" and launches != 1:
        raise RuntimeError(f"a sharded dispatch made {launches} banked "
                           f"launches")
    counts = np.bincount(sbank.shard_of[tid], minlength=sbank.num_shards)
    rows = sbank.num_shards * _shape_bucket(int(counts.max()))  # S·Bs
    secs = _timeit(lambda: disp(scores, tid, sbank), repeat)
    return {"us_per_batch": secs * 1e6, "events_per_s": len(tid) / secs,
            "launches_per_call": launches, "launch_rows": rows,
            "banked_path": _path(dev, sbank.num_shards * sbank.rows_per_shard,
                                 rows),
            "bitwise_parity": True}


def run(quick: bool = False, device: torch.device | str | None = None
        ) -> dict:
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    b = 2048 if quick else 8192
    tenant_counts = (256, 1024) if quick else (256, 1024, 4096)
    repeat = 5 if quick else 10
    rng = np.random.default_rng(0)

    rows: list[dict] = []
    for t in tenant_counts:
        bank = random_bank(rng, t, dev)
        dense_bytes = t * (2 * K + 2 * N) * 4
        scores = rng.uniform(0, 1, (b, K)).astype(np.float32)
        tid = rng.integers(0, t, b)
        tid32 = tid.astype(np.int32)

        def dense_call():
            return to_numpy(ops.score_pipeline_banked(
                torch.from_numpy(scores).to(dev),
                torch.from_numpy(tid32).to(dev), bank.betas, bank.weights,
                bank.src_quantiles, bank.ref_quantiles))

        dense, launches = _launched(dense_call)
        dense_s = _timeit(dense_call, repeat)
        rows.append({
            "tenants": t, "shards": 0, "path": "dense",
            "us_per_batch": dense_s * 1e6, "events_per_s": b / dense_s,
            "resident_bytes": dense_bytes, "residency_ratio": 1.0,
            "launches_per_call": launches, "launch_rows": b,
            "banked_path": _path(dev, t, b), "bitwise_parity": True})

        for s in SHARD_COUNTS:
            sbank = ShardedTransformBank.from_dense(bank, s)
            disp = ShardedBankDispatcher(make_tenant_mesh(s, dev))
            rows.append({
                "tenants": t, "shards": s, "path": "sharded",
                **sharded_row(disp, sbank, scores, tid, dense, repeat),
                "resident_bytes": sbank.per_shard_bytes,
                "residency_ratio": sbank.per_shard_bytes / dense_bytes})

    t_max, s_max = tenant_counts[-1], SHARD_COUNTS[-1]
    by = {(r["tenants"], r["shards"]): r for r in rows}
    smax_row = by[(t_max, s_max)]
    return {
        "device": torch.cuda.get_device_name(dev) if cuda else str(dev),
        "nvidia_smi": cli.nvidia_smi() if cuda else None,
        "quick": quick,
        "timer": ("host clock of whole round trips (window up, one launch, "
                  "scores down)" if cuda else "host clock of a CPU run of "
                  "the plain versions: no number of the card"),
        "batch": b, "experts": K, "knots": N,
        "tenant_counts": list(tenant_counts),
        "shard_counts": list(SHARD_COUNTS),
        "rows": rows,
        "max_tenants": t_max, "max_shards": s_max,
        "residency_ratio_at_smax": smax_row["residency_ratio"],
        "per_shard_bytes_at_smax": smax_row["resident_bytes"],
        "us_per_batch_smax": smax_row["us_per_batch"],
        "events_per_s_smax": smax_row["events_per_s"],
        # >= 1.0 means the S=1 sharded path costs no more than dense
        "throughput_ratio_s1": (by[(t_max, 1)]["events_per_s"]
                                / by[(t_max, 0)]["events_per_s"]),
        "all_bitwise_parity": all(r["bitwise_parity"] for r in rows),
    }


def main(argv: list[str] | None = None) -> int:
    return cli.main(run, __doc__, argv)


if __name__ == "__main__":
    sys.exit(main())
