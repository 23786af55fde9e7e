"""The tiered tenant-bank store: bounded device residency at 10^3..10^6
tenants.

The port's counterpart of the reference's ``benchmarks/bench_tiered_bank.py``,
at its sizes and seeds: K = 4 experts, N = 256 knots, 384 hot slots, 127
victim slots and the prior row (512 device rows), tenants swept over 1,024,
10,000, 100,000 and 1,000,000 (1,024 and 10,000 with ``--quick``).

  * **parity** — before anything is timed, a 1,024-event window over 1,024
    tenants through the tiered store (all cold: staged into the victim
    cache in passes) is bitwise equal to the dense bank of the same rows;
  * **residency** — device bytes are ``(hot + victims + 1)·(2K+2N)·4``,
    1,064,960 at every size, while the host store grows with the tenants;
  * **hot throughput** — events/s of a dispatch whose rows all sit in hot
    slots (one slot remap, one banked kernel launch, the window's upload
    and the scores' download), at batch 8,192 (2,048), beside the S = 8
    sharded dispatch of a 4,096-row bank at the same batch, K and N,
    measured in the same run (the reference's baseline: its
    ``bench_sharded_bank``'s widest row);
  * **stalls** — a 95/5 hot/cold mix at batch 2,048 (1,024), 4 windows (2),
    without and with the engine's prefetch before each dispatch: the share
    of events that waited on a synchronous host->device page-in.  With the
    prefetch, every event that still stalls must be one whose row the same
    window's prefetch evicted (the reference's clock picks victim slots
    without sparing rows the window already has resident); that happens
    only while the tenants are few enough for a window to find its cold
    rows still cached, so at the largest size the prefetched share must be
    0.  Each size's inputs come from seeds of its own (``size_inputs``), so
    the JAX store can be run on the same windows;
  * **staging off the lock** — p99 dispatch time on the mix at 100,000
    tenants (10,000), 200 windows of 512 (40), while a thread prefetches
    random rows without pause: ``overlap_staging`` off (the copy under the
    dispatch lock) against on (built outside it, swapped in under it), with
    the overlapped run's ``staging_conflicts``.

Every banked kernel launch of the tiered stores is counted (on the card)
and held to their dispatches plus extra passes; the launches of the dense
bank (the parity oracle) and of the sharded baseline are not among them.

Host rows are cumulative sums of seeded positive float32 draws, so 10^6
rows of 256 knots build in seconds.  On the card (the default) times are
host wall time of whole dispatches (each ends in a device sync).  With
``--device cpu`` the same code runs the plain versions on the CPU: that
run shows the entry point works and measures nothing of the card.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_tiered_bank \\
        [--quick] [--device cpu] [--out PATH]
"""
from __future__ import annotations

import gc
import sys
import threading
import time

import numpy as np
import torch

from repro_torch.benchmarks import cli
from repro_torch.core.transforms import ShardedTransformBank, TransformBank
from repro_torch.device import resolve_device, to_numpy
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_tenant_mesh
from repro_torch.serving.server import ShardedBankDispatcher
from repro_torch.serving.tiering import (
    HostBankStore,
    TieredBankStore,
    TieringConfig,
)

K, N = 4, 256
HOT, VICTIMS = 384, 127


def _timeit(fn, repeat: int) -> float:
    """Mean host seconds of ``fn`` over ``repeat`` calls after a warm-up
    call (each call ends in a device sync)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(repeat):
        fn()
    return (time.perf_counter() - t0) / repeat


def monotone_rows(rng, t: int, n: int) -> np.ndarray:
    """(t, n) sorted tables ending at 1 without an O(t·n log n) sort: a
    cumulative sum of positive float32 increments in [1e-3, 1)."""
    q = rng.random((t, n), dtype=np.float32)
    q *= np.float32(1.0 - 1e-3)
    q += np.float32(1e-3)
    np.cumsum(q, axis=1, dtype=np.float32, out=q)
    q /= q[:, -1:]
    return q


def host_store(rng, t: int, k: int = K, n: int = N) -> HostBankStore:
    return HostBankStore(
        rng.uniform(0.05, 1.0, (t, k)).astype(np.float32),
        rng.uniform(0.1, 2.0, (t, k)).astype(np.float32),
        monotone_rows(rng, t, n), monotone_rows(rng, t, n))


def _mixes(rng, t: int, hot_ids: np.ndarray, batch: int, windows: int
           ) -> list[np.ndarray]:
    """Windows of the 95/5 mix: 95% from the hot set, 5% uniform."""
    return [np.where(rng.random(batch) < 0.95, rng.choice(hot_ids, batch),
                     rng.integers(0, t, batch)) for _ in range(windows)]


def stall_rate(store: TieredBankStore, mixes, raws, *, prefetch: bool
               ) -> float:
    """Share of the events of ``mixes`` that stalled on a synchronous
    host->device page-in, with or without the engine's prefetch first.
    With the prefetch, raises unless every stalled event's row was resident
    before the window's prefetch and evicted by it."""
    ev0 = store.metrics["events"]
    st0 = store.metrics["stalled_events"]
    for mix in mixes:
        if prefetch:
            need = np.unique(mix)
            need = need[store.host.admitted[need]]
            was = np.isin(need, store.resident_rows())
            store.prefetch(mix)            # the engine's anti-stall hook
            cold = ~np.isin(need, store.resident_rows())
            if np.any(cold & ~was):
                raise RuntimeError(f"the prefetch left {int(np.sum(cold & ~was))}"
                                   f" cold rows of its window cold")
            s0 = store.metrics["stalled_events"]
        store.dispatch(raws[:len(mix)], mix)
        if prefetch:
            stalled = store.metrics["stalled_events"] - s0
            evicted = int(np.isin(mix, need[cold]).sum())
            if stalled != evicted:
                raise RuntimeError(f"{stalled} events stalled after the "
                                   f"prefetch; {evicted} have rows it evicted")
    ev = store.metrics["events"] - ev0
    return (store.metrics["stalled_events"] - st0) / max(ev, 1)


def size_inputs(i: int, t: int, b: int, b_mix: int, windows: int) -> dict:
    """The inputs of the sweep's ``i``-th size (``t`` tenants), from seeds
    of its own: the host rows, the hot set and its window, and the mixes of
    the runs without and with prefetch."""
    rng = np.random.default_rng(10 + i)
    host = host_store(rng, t)
    hot_ids = np.arange(min(HOT, t))
    raws = rng.uniform(0, 1, (b, K)).astype(np.float32)
    tid_hot = rng.choice(hot_ids, b)
    mix_raws = rng.uniform(0, 1, (b_mix, K)).astype(np.float32)
    mix_rng = np.random.default_rng(100 + i)
    mixes = _mixes(mix_rng, t, hot_ids, b_mix, windows)
    return {"host": host, "hot_ids": hot_ids, "raws": raws,
            "tid_hot": tid_hot, "mix_raws": mix_raws, "mixes": mixes,
            "mixes_prefetched": _mixes(mix_rng, t, hot_ids, b_mix, windows)}


def size_run(store, inputs: dict, repeat: int) -> dict:
    """The sweep's sequence at one size: promote the hot set, time the hot
    window, then the stall rates without prefetch, a rebalance, and with
    prefetch.  ``store`` is any tiered store over ``inputs["host"]``'s rows
    (the JAX package's too)."""
    hot_ids = inputs["hot_ids"]
    store.tracker.record(hot_ids)          # declare the hot working set
    store.rebalance()                      # ... and promote it
    if len(store.hot_rows()) != len(hot_ids):
        raise RuntimeError("the hot set was not promoted")
    raws, tid_hot = inputs["raws"], inputs["tid_hot"]
    hot_s = _timeit(lambda: store.dispatch(raws, tid_hot), repeat)
    if store.metrics["cold_miss_stalls"]:
        raise RuntimeError("a pure hot-path dispatch stalled")
    srate = stall_rate(store, inputs["mixes"], inputs["mix_raws"],
                       prefetch=False)
    store.rebalance()                      # re-pin the hot set
    prate = stall_rate(store, inputs["mixes_prefetched"], inputs["mix_raws"],
                       prefetch=True)
    return {"us_per_batch_hot": hot_s * 1e6,
            "events_per_s_hot": len(tid_hot) / hot_s,
            "stall_rate_mixed": srate, "stall_rate_prefetched": prate}


def p99_under_churn(rng, t: int, dev, *, overlap: bool, batch: int,
                    windows: int) -> tuple[float, int, dict]:
    """p99 dispatch ms on the 95/5 mix while a thread prefetches random
    rows without pause.  ``overlap=False`` holds the dispatch lock across
    every prefetch's copy; ``overlap=True`` builds the staged view outside
    it.  Returns (p99 ms, staging_conflicts, the store's counters)."""
    store = TieredBankStore(host_store(rng, t), TieringConfig(
        hot_capacity=HOT, victim_capacity=VICTIMS, overlap_staging=overlap),
        device=dev)
    hot_ids = np.arange(HOT)
    store.tracker.record(hot_ids)
    store.rebalance()
    raws = rng.uniform(0, 1, (batch, K)).astype(np.float32)
    mixes = _mixes(rng, t, hot_ids, batch, windows)
    # np.random.Generator is not thread-safe: pre-draw the churner's rows
    churn = [rng.integers(0, t, 64) for _ in range(512)]
    stop = threading.Event()

    def churner():
        i = 0
        while not stop.is_set():
            store.prefetch(churn[i % len(churn)])
            i += 1

    store.dispatch(raws, mixes[0])          # warm, untimed
    th = threading.Thread(target=churner, daemon=True)
    th.start()
    lat = []
    try:
        for mix in mixes:
            t0 = time.perf_counter()
            store.dispatch(raws, mix)
            lat.append(time.perf_counter() - t0)
    finally:
        stop.set()
        th.join()
    return (float(np.percentile(lat, 99) * 1e3),
            int(store.metrics["staging_conflicts"]), dict(store.metrics))


SHARDS = 8


def _sharded_baseline(rng, dev, b: int, repeat: int) -> float:
    """events/s of the S = 8 sharded dispatch at batch ``b`` over a
    4,096-row bank (``bench_sharded_bank``'s widest row, the reference's
    baseline): bucket and pack on the host, upload the window, ONE banked
    launch over every shard's rows, download the scores."""
    t = 4096
    bank = TransformBank(*(torch.tensor(a, device=dev) for a in (
        rng.uniform(0.05, 1.0, (t, K)).astype(np.float32),
        rng.uniform(0.1, 2.0, (t, K)).astype(np.float32),
        monotone_rows(rng, t, N), monotone_rows(rng, t, N))))
    raws = rng.uniform(0, 1, (b, K)).astype(np.float32)
    tid = rng.integers(0, t, b)
    sbank = ShardedTransformBank.from_dense(bank, SHARDS)
    disp = ShardedBankDispatcher(make_tenant_mesh(SHARDS, dev))
    return b / _timeit(lambda: disp(raws, tid, sbank), repeat)


def _passes(metrics: dict) -> int:
    """Banked kernel launches a tiered store made: one a dispatch, one more
    an extra pass."""
    return int(metrics["dispatches"] + metrics["extra_passes"])


def run(quick: bool = False, device: torch.device | str | None = None
        ) -> dict:
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    b = 2048 if quick else 8192
    b_mix = 1024 if quick else 2048        # ~5% cold fits the victim cache
    tenant_counts = (1_024, 10_000) if quick \
        else (1_024, 10_000, 100_000, 1_000_000)
    repeat = 3 if quick else 10
    windows = 2 if quick else 4
    cfg = TieringConfig(hot_capacity=HOT, victim_capacity=VICTIMS)
    rng = np.random.default_rng(0)
    launched = passes = 0                  # of the tiered stores only

    def banked() -> int:
        return ops.LAUNCHES["score_pipeline_banked"]

    # bitwise parity against the dense bank (smallest size, all cold)
    t0 = tenant_counts[0]
    host = host_store(rng, t0)
    store = TieredBankStore(host, cfg, device=dev)
    raws = rng.uniform(0, 1, (1024, K)).astype(np.float32)
    tid = rng.integers(0, t0, 1024)
    l0 = banked()
    got, _ = store.dispatch(raws, tid)
    launched += banked() - l0
    passes += _passes(store.metrics)
    dense = host.dense_bank(0, dev)
    want = to_numpy(ops.score_pipeline_banked(
        torch.from_numpy(raws).to(dev),
        torch.from_numpy(tid.astype(np.int32)).to(dev), dense.betas,
        dense.weights, dense.src_quantiles, dense.ref_quantiles))
    differ = int(np.sum(got.view(np.uint32) != want.view(np.uint32)))
    if differ:
        raise RuntimeError(f"tiered scores differ from the dense bank's in "
                           f"{differ} of 1024 events")
    parity_passes = store.metrics["extra_passes"] + 1
    del store, host, dense

    sharded_eps = _sharded_baseline(rng, dev, b, repeat)
    rows: list[dict] = []
    for i, t in enumerate(tenant_counts):
        t_build = time.perf_counter()
        inputs = size_inputs(i, t, b, b_mix, windows)
        store = TieredBankStore(inputs["host"], cfg, device=dev)
        build_s = time.perf_counter() - t_build
        l0 = banked()
        row = size_run(store, inputs, repeat)
        launched += banked() - l0
        passes += _passes(store.metrics)
        rows.append({
            "tenants": t, "device_bytes": store.device_bytes,
            "host_bytes": store.host_bytes, "host_build_s": build_s, **row,
            "prefetched_rows": store.metrics["prefetched_rows"],
            "staged_rows": store.metrics["staged_rows"],
            "stalled_events": store.metrics["stalled_events"]})
        del store, inputs
        gc.collect()
    if len({r["device_bytes"] for r in rows}) != 1:
        raise RuntimeError("device bytes grew with the tenants")
    last = rows[-1]
    if last["stall_rate_prefetched"] != 0.0:
        raise RuntimeError(f"prefetched windows stalled at {last['tenants']} "
                           f"tenants: {last['stall_rate_prefetched']}")
    for r in rows:
        if r["stall_rate_prefetched"] >= r["stall_rate_mixed"]:
            raise RuntimeError(f"prefetch did not cut the stalls: {r}")

    # staging off the lock: p99 dispatch under a concurrent prefetch churn
    t_churn = 10_000 if quick else 100_000
    churn_w = 40 if quick else 200
    churn_b = 512
    churn = {}
    for overlap in (False, True):
        l0 = banked()
        churn[overlap] = p99_under_churn(rng, t_churn, dev, overlap=overlap,
                                         batch=churn_b, windows=churn_w)
        launched += banked() - l0
        passes += _passes(churn[overlap][2])
    p99_locked, _, m_locked = churn[False]
    p99_overlap, conflicts, m_overlap = churn[True]
    if cuda and launched != passes:
        raise RuntimeError(f"the tiered stores launched the banked kernel "
                           f"{launched} times for {passes} passes")

    return {
        "device": torch.cuda.get_device_name(dev) if cuda else str(dev),
        "nvidia_smi": cli.nvidia_smi() if cuda else None,
        "quick": quick,
        "timer": ("host clock of whole dispatches (each ends in a device "
                  "sync)" if cuda else "host clock of a CPU run of the plain "
                  "versions: no number of the card"),
        "batch": b, "experts": K, "knots": N, "hot_capacity": HOT,
        "victim_capacity": VICTIMS, "mix_batch": b_mix,
        "mix_windows": windows,
        "bitwise_parity_events": 1024, "parity_passes": parity_passes,
        "rows": rows,
        "sharded_s8_events_per_s_t4096": sharded_eps,
        "hot_vs_sharded_s8_ratio": last["events_per_s_hot"] / sharded_eps,
        "churn_tenants": t_churn, "churn_batch": churn_b,
        "churn_windows": churn_w,
        "p99_ms_dispatch_locked_staging": p99_locked,
        "p99_ms_dispatch_overlap_staging": p99_overlap,
        "staging_p99_speedup": p99_locked / p99_overlap,
        "staging_conflicts_overlap": conflicts,
        "churn_prefetched_rows": {
            "locked": m_locked["prefetched_rows"],
            "overlap": m_overlap["prefetched_rows"]},
        # banked kernel launches of the tiered stores' dispatches (0 on the
        # CPU, where the plain version runs) and their passes
        "dispatch_launches": launched, "dispatch_passes": passes,
    }


def main(argv: list[str] | None = None) -> int:
    return cli.main(run, __doc__, argv)


if __name__ == "__main__":
    sys.exit(main())
