#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  — card name, power limit, and the nvcc build of every kernel of
             the port from the sources in this checkout.
2. kernel  — each kernel against its plain PyTorch version on the card at
             the realistic size (65,536 events, K=8, 4,096 bank rows, N=256):
             tenant layouts, a partial tail, flat segments, ties on knots,
             out-of-support and NaN scores, out-of-range ids, M=1; then its
             time beside the plain version's and the memory/compute bound.
3. serve   — the port's main path, ``MuseServer.score_batch``, over the
             FraudWorld ensemble (3 experts, 16 features, N=256) with 64
             tenant predictors and a shadow candidate: mixed-tenant windows
             of 1,024 requests through the hand-written kernel, checked
             against the same traffic through the plain version, with a
             T^Q refresh published mid-run.
4. kernels — every kernel of the port with its launches on the main path,
             its error and its times at the main path's shapes.

Any failed check raises, so the script exits non-zero; it also exits
non-zero, printing no result, without CUDA or outside the repository.  The
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

TOL = 2e-5            # the reference's f32 kernel tolerance
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores
SLEEP_CYCLES = 20_000_000   # keeps the card busy while launches queue up


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def device_ms(fn, *, reps: int = 20, inner: int = 50) -> float:
    """Median over ``reps`` of the card's time per call of ``fn``, from CUDA
    events around ``inner`` back-to-back calls queued behind a busy card
    (so the host's launch cost is not what is timed)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def banked_bound(m: int, k: int, t: int, n: int) -> tuple[float, str]:
    """Least time for the banked pipeline: each input read once and the
    output written once, over the memory rate, against its float32 work
    (9K + N + 10 operations a row) over the card's float32 rate."""
    nbytes = m * k * 4 + m * 4 + m * 4 + t * (2 * k + 2 * n) * 4
    ops = m * (9 * k + n + 10)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


# ---------------------------------------------------------------- phase 1
def phase_device() -> tuple[str, str]:
    import torch
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    seconds = _build.build_all()
    regs = {name: [ln.strip() for ln in log.splitlines()
                   if "registers" in ln or "spill" in ln]
            for name, log in _build.BUILD_LOGS.items()}
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": seconds, "build_wall_s": time.perf_counter() - t0,
          "ptxas": regs})
    return torch.cuda.get_device_name(0), smi


# ---------------------------------------------------------------- phase 2
def _bank(rng, t, k, n, dev):
    import numpy as np
    import torch

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    return (f32(rng.uniform(0.05, 1.0, (t, k))),
            f32(rng.uniform(0.1, 2.0, (t, k))),
            f32(np.sort(rng.uniform(0, 1, (t, n)), axis=-1)),
            f32(np.sort(rng.uniform(0, 1, (t, n)), axis=-1)))


def _compare(name, got, want, *, exact=False) -> float:
    import torch

    got, want = got.cpu(), want.cpu()
    check(got.shape == want.shape, f"{name}: shape")
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    check(torch.equal(nan_g, nan_w), f"{name}: NaN rows differ")
    fin = ~nan_w
    err = (got[fin] - want[fin]).abs().max().item() if fin.any() else 0.0
    if exact:
        check(torch.equal(got[fin], want[fin]), f"{name}: not bitwise equal")
    check(err <= TOL, f"{name}: max abs err {err} > {TOL}")
    return err


def phase_kernel(dev) -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import score_pipeline as sp

    m, k, t, n = 65_536, 8, 4_096, 256
    rng = np.random.default_rng(0)
    bank = _bank(rng, t, k, n, dev)
    betas, weights, src, refq = bank

    def scores(rows, lo=0.0, hi=1.0):
        return torch.tensor(rng.uniform(lo, hi, (rows, k)).astype(np.float32),
                            device=dev)

    def ids(a):
        return torch.tensor(np.asarray(a, np.int32), device=dev)

    y = scores(m)
    layouts = {
        "sorted": ids(np.repeat(np.arange(t), m // t)),
        "interleaved": ids(np.arange(m) % t),
        "random": ids(rng.integers(0, t, m)),
    }
    errs = {}
    for name, tid in layouts.items():
        errs[name] = _compare(name, sp.score_pipeline_banked(y, tid, *bank),
                              ref.score_pipeline_banked(y, tid, *bank))

    # partial tail: 17 rows past a whole number of 8-row blocks, edge-padded
    tail = ids(np.concatenate([rng.integers(0, t, m), np.full(17, 5)]))
    y_tail = scores(m + 17)
    errs["partial_tail"] = _compare(
        "partial_tail", sp.score_pipeline_banked(y_tail, tail, *bank),
        ref.score_pipeline_banked(y_tail, tail, *bank))

    # flat source segments and fully degenerate tables
    flat = src.clone()
    flat[:, 40:90] = flat[:, 40:41]
    flat[::7] = 0.5
    fbank = (betas, weights, flat, refq)
    tid = layouts["random"]
    errs["flat_segments"] = _compare(
        "flat_segments", sp.score_pipeline_banked(y, tid, *fbank),
        ref.score_pipeline_banked(y, tid, *fbank))

    # ties: identity T^C and A (agg == score) with scores ON the knots of a
    # table whose flat segment has a jump in the reference: the bucket must
    # be the exact count, so the outputs must be bitwise equal
    knots = np.linspace(0, 1, n).astype(np.float32)
    knots[100:120] = knots[100]
    tie_bank = (torch.ones(1, 1, device=dev), torch.ones(1, 1, device=dev),
                torch.tensor(knots[None], device=dev),
                torch.tensor(np.sort(rng.uniform(0, 1, n)).astype(
                    np.float32)[None], device=dev))
    y_tie = torch.tensor(knots[:, None], device=dev)
    tid_tie = torch.zeros(n, dtype=torch.int32, device=dev)
    errs["ties_on_knots"] = _compare(
        "ties_on_knots", sp.score_pipeline_banked(y_tie, tid_tie, *tie_bank),
        ref.score_pipeline_banked(y_tie, tid_tie, *tie_bank), exact=True)

    # aggregates far outside every table's support (clip to the edges)
    narrow = (betas, weights, 0.4 + 0.2 * src, refq)
    y_out = torch.cat([scores(m // 2, 0.0, 0.02), scores(m // 2, 0.98, 1.0)])
    errs["out_of_support"] = _compare(
        "out_of_support", sp.score_pipeline_banked(y_out, tid, *narrow),
        ref.score_pipeline_banked(y_out, tid, *narrow))

    # NaN scores come out NaN in the same rows
    y_nan = y.clone()
    y_nan[::13, 3] = float("nan")
    errs["nan_scores"] = _compare(
        "nan_scores", sp.score_pipeline_banked(y_nan, tid, *bank),
        ref.score_pipeline_banked(y_nan, tid, *bank))

    # one row
    errs["m1"] = _compare("m1", sp.score_pipeline_banked(y[:1], tid[:1], *bank),
                          ref.score_pipeline_banked(y[:1], tid[:1], *bank))

    # out-of-range ids: the kernel reads no bank memory and scores NaN; the
    # other rows are unaffected (the plain gather would fault, so it only
    # sees the in-range rows)
    bad = tid.clone()
    bad[::11] = t + 3
    bad[5::17] = -1
    got = sp.score_pipeline_banked(y, bad, *bank)
    out = (bad < 0) | (bad >= t)
    check(bool(torch.isnan(got[out]).all()), "out-of-range ids score NaN")
    errs["out_of_range_ids"] = _compare(
        "out_of_range_ids", got[~out],
        ref.score_pipeline_banked(y[~out], bad[~out], *bank))
    torch.cuda.synchronize()

    y_r, tid_r = y, layouts["random"]
    kernel_ms = device_ms(lambda: sp.score_pipeline_banked(y_r, tid_r, *bank))
    plain_ms = device_ms(lambda: ref.score_pipeline_banked(y_r, tid_r, *bank),
                         inner=10)
    bound_ms, bound_by = banked_bound(m, k, t, n)
    result = {"phase": "kernel", "name": "score_pipeline_banked",
              "shape": {"M": m, "K": k, "T": t, "N": n},
              "max_abs_err": max(errs.values()), "errors": errs,
              "ties_bitwise": True, "out_of_range_ids": "NaN",
              "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "library_ms": None,
              "timing": "CUDA events, median of 20 runs of back-to-back "
                        "launches queued behind a busy card; bank warm in L2"}
    emit(result)
    return result


# ---------------------------------------------------------------- phase 3
GROUP = ("m1", "m2", "m3")
N_TENANTS = 64
WINDOW = 1024
N_WINDOWS = 10


def _serve_setup(dev):
    import dataclasses

    import numpy as np
    from repro_torch.core.routing import (
        Condition, Intent, RoutingTable, ScoringRule, ShadowRule)
    from repro_torch.experiments.fraud_world import FraudWorld
    from repro_torch.serving.server import MuseServer, ServerConfig
    from repro_torch.serving.types import ScoringRequest
    from repro_torch.training.data import FraudEventStream, TenantProfile

    world = FraudWorld.build(seed=0)
    rng = np.random.default_rng(1)
    streams = [FraudEventStream(TenantProfile(
        f"tenant{i:02d}", fraud_rate=float(rng.uniform(0.002, 0.02)),
        feature_shift=float(rng.uniform(-0.3, 0.5)), seed=1000 + i))
        for i in range(N_TENANTS)]
    specs = [world.predictor_spec(f"p{i}", GROUP, world.custom_quantile_map(
        GROUP, s.sample(4096)[0])) for i, s in enumerate(streams)]
    cand = dataclasses.replace(
        world.predictor_spec("cand", GROUP, world.custom_quantile_map(
            GROUP, world.client.sample(4096)[0])), weights=(2.0, 1.0, 1.0))
    routing = RoutingTable(
        tuple(ScoringRule(Condition(tenants=(f"tenant{i:02d}",)), f"p{i}")
              for i in range(N_TENANTS)),
        (ShadowRule(Condition(tenants=tuple(f"tenant{i:02d}"
                                            for i in range(8))), ("cand",)),),
        version="v1")

    def server(fused: bool) -> MuseServer:
        s = MuseServer(routing, ServerConfig(fused_kernel=fused), device=dev)
        factories = world.model_factories(dev)
        for spec in specs + [cand]:
            s.deploy(spec, factories)
        return s

    feats = [s.sample(N_WINDOWS * WINDOW)[0] for s in streams]
    tenants = rng.integers(0, N_TENANTS, (N_WINDOWS, WINDOW))
    windows = [[ScoringRequest(Intent(tenant=f"tenant{t:02d}"),
                               feats[t][w * WINDOW + j],
                               request_id=w * WINDOW + j)
                for j, t in enumerate(tenants[w])] for w in range(N_WINDOWS)]
    return world, server, windows


def _live_bank(server):
    """(predictor names, bank) of the server's largest cached bank."""
    key = max(server.plane.banks, key=len)
    return key, server.plane.banks[key].bank


def _drive(server, windows, refresh):
    """Score every window, publishing ``refresh(server)`` after the middle
    one; returns per-window responses and host seconds per window."""
    out, secs = [], []
    for w, reqs in enumerate(windows):
        t0 = time.perf_counter()
        out.append(server.score_batch(reqs))
        secs.append(time.perf_counter() - t0)
        if w == N_WINDOWS // 2 - 1:
            refresh(server)
    return out, secs


def _stage_ms(server, reqs, reps: int = 5) -> dict:
    """Median host milliseconds of each stage of one single-group window,
    run as ``score_batch`` runs them, each stage ended by a device sync."""
    import numpy as np
    import torch

    samples: dict[str, list[float]] = {}
    for _ in range(reps):
        marks = [("start", time.perf_counter())]

        def mark(name):
            torch.cuda.synchronize()
            marks.append((name, time.perf_counter()))

        plane = server.plane
        res = [server.routing.resolve(r.intent) for r in reqs]
        mark("route")
        idxs, names, cache = list(range(len(reqs))), [r.live for r in res], {}
        raws = server.run_models(reqs, idxs, names, cache, plane)
        mark("run_models")
        scores, bank, tid = server.apply_transforms(raws, names, plane)
        mark("apply_transforms")
        server.build_responses(reqs, idxs, names, scores, raws, bank,
                               server.routing.version, 0.0)
        mark("build_responses")
        server.track(reqs, idxs, names, raws, bank, tid)
        mark("track")
        server._run_shadows(reqs, res, cache, plane)
        mark("shadows")
        for (_, a), (name, b) in zip(marks, marks[1:]):
            samples.setdefault(name, []).append((b - a) * 1e3)
    return {name: float(np.median(v)) for name, v in samples.items()}


def phase_serve(dev) -> tuple[dict, dict]:
    import numpy as np
    import torch
    from repro_torch.kernels import ops

    world, make_server, windows = _serve_setup(dev)
    fused, plain = make_server(True), make_server(False)
    before = {}

    def refresh(server):
        # T^Q_v1 for tenant00's predictor, fitted on the fused server's live
        # stream, published to both servers; the bank it replaces is kept
        if "qm" not in before:
            before["qm"] = server.fit_custom_quantile_map(
                "tenant00", "p0", world.ref_quantiles)
            before["key"], before["bank"] = _live_bank(server)
        server.publish_quantile_maps({"p0": before["qm"]})

    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    resp, secs = _drive(fused, windows, refresh)
    launches = dict(ops.LAUNCHES)
    metrics = dict(fused.metrics)
    resp_plain, secs_plain = _drive(plain, windows, refresh)

    check(launches["score_pipeline_banked"] == metrics["kernel_dispatches"]
          > 0, f"launches {launches} == kernel_dispatches "
          f"{metrics['kernel_dispatches']}")
    half = N_WINDOWS // 2
    err = 0.0
    for w, (reqs, a, b) in enumerate(zip(windows, resp, resp_plain)):
        sa = np.array([r.score for r in a])
        sb = np.array([r.score for r in b])
        check(bool(np.isfinite(sa).all() and (sa >= 0).all()
                   and (sa <= 1).all()), f"window {w}: scores in [0, 1]")
        check([r.predictor for r in a] ==
              [f"p{int(q.intent.tenant[6:])}" for q in reqs],
              f"window {w}: predictors as routed")
        gens = {r.bank_generation for r in a}
        check(gens == {0 if w < half else 1}, f"window {w}: generation {gens}")
        err = max(err, float(np.abs(sa - sb).max()))
    check(err <= TOL, f"fused vs plain max abs err {err}")

    # the refresh changed tenant00's scores: its rows after the publish,
    # rescored under the replaced bank, come out different
    rows = [r for w in range(half, N_WINDOWS)
            for q, r in zip(windows[w], resp[w])
            if q.intent.tenant == "tenant00"]
    check(len(rows) > 0, "tenant00 has traffic after the refresh")
    key, old_bank = before["key"], before["bank"]
    raws = torch.tensor([r.raw_scores for r in rows], device=dev)
    idx = torch.full((len(rows),), key.index("p0"), dtype=torch.int32,
                     device=dev)
    old = old_bank(raws, idx).cpu().numpy()
    moved = float(np.abs(old - np.array([r.score for r in rows])).max())
    check(moved > 1e-4, f"refreshed T^Q moved tenant00's scores ({moved})")

    lat = np.array(secs[1:]) * 1e3
    stages = _stage_ms(fused, windows[-1])
    result = {
        "phase": "serve", "windows": N_WINDOWS, "window_requests": WINDOW,
        "tenants": N_TENANTS, "experts": len(GROUP),
        "launches": launches, "metrics": metrics,
        "max_abs_err_vs_plain": err, "refresh_max_score_change": moved,
        "events_per_s": (N_WINDOWS - 1) * WINDOW / sum(secs[1:]),
        "p50_window_ms": float(np.percentile(lat, 50)),
        "p99_window_ms": float(np.percentile(lat, 99)),
        "first_window_ms": secs[0] * 1e3,
        "plain_events_per_s": (N_WINDOWS - 1) * WINDOW / sum(secs_plain[1:]),
        "timing": "host clock per score_batch window (ends in a device "
                  "sync), first window excluded",
        "stage_ms": stages,
        "bank_generation": metrics["bank_generation"],
        "shadow_records": metrics["shadow_evals"]}
    emit(result)

    # the main path's own kernel shapes: the live bank and a live window
    key, bank = _live_bank(fused)
    last = resp[-1]
    row_of = {n: i for i, n in enumerate(key)}
    main = {"raws": torch.tensor([r.raw_scores for r in last], device=dev),
            "idx": torch.tensor([row_of[r.predictor] for r in last],
                                dtype=torch.int32, device=dev),
            "bank": (bank.betas, bank.weights, bank.src_quantiles,
                     bank.ref_quantiles)}
    return result, main


# ---------------------------------------------------------------- phase 4
def phase_kernels(kernel: dict, serve: dict, main: dict) -> None:
    from repro_torch.kernels import ref
    from repro_torch.kernels import score_pipeline as sp

    raws, idx, bank = main["raws"], main["idx"], main["bank"]
    m, k = raws.shape
    t, n = bank[2].shape
    err = _compare("main_path", sp.score_pipeline_banked(raws, idx, *bank),
                   ref.score_pipeline_banked(raws, idx, *bank))
    ms = device_ms(lambda: sp.score_pipeline_banked(raws, idx, *bank))
    plain_ms = device_ms(lambda: ref.score_pipeline_banked(raws, idx, *bank),
                         inner=10)
    bound_ms, bound_by = banked_bound(m, k, t, n)
    emit({"kernels": [{
        "name": "score_pipeline_banked", "route": "cuda",
        "source": "src/repro_torch/csrc/score_pipeline_banked.cu",
        "replaces": "src/repro/kernels/score_pipeline.py:122",
        "launches": serve["launches"]["score_pipeline_banked"],
        "max_abs_err": max(err, kernel["max_abs_err"]),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        "shape": {"M": m, "K": k, "T": t, "N": n},
        "realistic": {key: kernel[key] for key in
                      ("shape", "ms", "plain_ms", "bound_ms", "bound_by")},
    }]})


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              f"({src / 'repro_torch'} is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    dev = torch.device("cuda")
    name, smi = phase_device()
    kernel = phase_kernel(dev)
    serve, main_shapes = phase_serve(dev)
    phase_kernels(kernel, serve, main_shapes)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
