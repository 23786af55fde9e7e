"""The async banked dispatch engine against the synchronous ``ServerBatcher``.

The port's counterpart of the reference's ``benchmarks/bench_async_engine.py``,
at its sizes and seeds: 32 tenants (16 with ``--quick``), each routed to its
own predictor over one group of three MLP experts (64 -> 512 -> 512 -> 1,
tanh, sigmoid), T^Q tables of 128 knots, 16,384 events (12,288) of random
features in base windows of 128 and adaptive windows up to 2,048.  Five
runs serve the same traffic on identically built servers, every serving
shape warmed first:

  * ``sync``           — ``ServerBatcher`` flushing fixed windows of 128;
  * ``engine_fixed``   — ``AsyncDispatchEngine``, fixed windows (stage
    overlap only);
  * ``engine_adaptive``— the engine with adaptive windows (the backlog
    dispatched as one window while the model stage is busy);
  * ``track_off`` / ``track_on`` — the adaptive engine with quantile
    tracking off, and with fused device tracking
    (``ServerConfig(track_device=True)``).

The experts run one matmul over the whole (bucketed) window, as the
reference's do, so adaptive windows give the larger matmuls.  On the card
cuBLAS picks its GEMM by the window's row count, so a row's raw scores can
differ in their last bits between window sizes: the runs are held to each
other within 2e-5 (raw scores and scores), and each response is held
bitwise to its own raw scores replayed through the banked kernel in one
launch (the audit contract: that checks routing, generation stamps and
order), and within 2e-5 to the plain version.  Tracking must never touch a
score: wherever ``track_off`` and ``track_on`` have bitwise equal raw
scores, their scores are bitwise equal.  The banked kernel launches once a
window, and each run's count of launches (the timed stream's only) is held
to its windows.  The device tracker must count every event (the timed ones
and the warm-ups).  The engine's three stage threads all use the device's
default stream.

On the card (the default) the events/s are host wall time over the timed
stream, each run ended by the engine's drain (whose responses are numpy, so
every window ended in a device sync).  With ``--device cpu`` the same code
runs the plain versions on the CPU: that run shows the entry point works
and measures nothing of the card.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_async_engine \\
        [--quick] [--device cpu] [--out PATH]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch.core.predictor import PredictorSpec
from repro_torch.core.routing import Condition, Intent, RoutingTable, ScoringRule
from repro_torch.core.transforms import QuantileMap, TransformBank
from repro_torch.device import resolve_device, to_numpy
from repro_torch.kernels import ops, ref
from repro_torch.serving import (
    AsyncDispatchEngine,
    MicroBatcher,
    MuseServer,
    ServerBatcher,
    ServerConfig,
)
from repro_torch.serving.types import ScoringRequest

DIM = 64
HIDDEN = 512
N_EXPERTS = 3
KNOTS = 128
TOL = 2e-5


def mlp_model(seed: int, device: torch.device, hidden: int = HIDDEN,
              dim: int = DIM):
    """A 3-layer scorer with the reference benchmark's weights (seeded
    numpy normal(0, 0.3)), one matmul a layer over the whole window."""
    rng = np.random.default_rng(seed)

    def weight(shape):
        return torch.tensor(rng.normal(0, 0.3, shape), dtype=torch.float32,
                            device=device)

    w1, w2, w3 = weight((dim, hidden)), weight((hidden, hidden)), \
        weight((hidden, 1))

    def score(x):
        x = torch.as_tensor(np.asarray(x, np.float32)).to(device)
        h = torch.tanh(x @ w1)
        h = torch.tanh(h @ w2)
        return torch.sigmoid((h @ w3)[:, 0])

    return score


def build_server(n_tenants: int, device: torch.device,
                 config: ServerConfig | None = None) -> MuseServer:
    """One predictor per tenant over a shared expert group: a mixed-tenant
    window is one call of each expert and ONE banked kernel launch."""
    factories = {f"m{k}": (lambda k=k: mlp_model(k, device))
                 for k in range(N_EXPERTS)}
    rules = tuple(ScoringRule(Condition(tenants=(f"t{i}",)), f"p{i}")
                  for i in range(n_tenants)) + \
        (ScoringRule(Condition(), "p0"),)
    qs = torch.linspace(0.0, 1.0, KNOTS)
    server = MuseServer(RoutingTable(rules, version="v1"), config,
                        device=device)
    group = tuple(f"m{k}" for k in range(N_EXPERTS))
    for i in range(n_tenants):
        server.deploy(
            PredictorSpec(f"p{i}", group, (0.2, 0.3, 0.1),
                          (1.0,) * N_EXPERTS, QuantileMap(qs, qs ** 2)),
            factories)
    return server


def requests(feats: np.ndarray, n_tenants: int) -> list[ScoringRequest]:
    return [ScoringRequest(intent=Intent(tenant=f"t{i % n_tenants}"),
                           features=feats[i])
            for i in range(len(feats))]


def _warm(server: MuseServer, n_tenants: int, sizes: list[int]) -> None:
    """Run every serving shape (base window + each adaptive growth bucket)
    before the clock starts — the rollout warm-up discipline."""
    rng = np.random.default_rng(9)
    for s in sizes:
        feats = rng.normal(0, 1, (s, DIM)).astype(np.float32)
        server.score_batch(requests(feats, n_tenants))


def _nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _banked_launches() -> int:
    return ops.LAUNCHES["score_pipeline_banked"]


def _held(name: str, server: MuseServer, reqs, out, bank,
          dev: torch.device) -> tuple[np.ndarray, np.ndarray]:
    """One run's responses in request order, each held bitwise to its own
    raw scores replayed through the banked kernel (one launch, outside the
    run's count) and within ``TOL`` to the plain version.  Returns the
    run's (scores, raw scores)."""
    by_id = {r.request_id: r for r in out}
    if len(out) != len(reqs) or len(by_id) != len(reqs):
        raise RuntimeError(f"{name}: {len(out)} responses for {len(reqs)} "
                           f"requests")
    resp = [by_id[q.request_id] for q in reqs]
    want_pred = [server.routing.resolve(q.intent).live for q in reqs]
    if [r.predictor for r in resp] != want_pred:
        raise RuntimeError(f"{name}: a response names another predictor")
    if {r.bank_generation for r in resp} != {bank.generation}:
        raise RuntimeError(f"{name}: generations "
                           f"{sorted({r.bank_generation for r in resp})}")
    scores = np.asarray([r.score for r in resp], np.float32)
    raws = np.asarray([r.raw_scores for r in resp], np.float32)
    tid = np.asarray([int(r.predictor[1:]) for r in resp], np.int32)
    raws_d = torch.from_numpy(raws).to(dev)
    tid_d = torch.from_numpy(tid).to(dev)
    params = (bank.betas, bank.weights, bank.src_quantiles,
              bank.ref_quantiles)
    replay = to_numpy(ops.score_pipeline_banked(raws_d, tid_d, *params))
    differ = int(np.sum(replay.view(np.uint32) != scores.view(np.uint32)))
    if differ:
        raise RuntimeError(f"{name}: {differ} scores differ from their raw "
                           f"scores replayed through the banked kernel")
    plain = to_numpy(ref.score_pipeline_banked(raws_d, tid_d, *params))
    err = float(np.max(np.abs(plain - scores)))
    if not err <= TOL:
        raise RuntimeError(f"{name}: max abs err {err} against the plain "
                           f"version")
    return scores, raws


def run(quick: bool = False, device: torch.device | str | None = None
        ) -> dict:
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    n_tenants = 16 if quick else 32
    n_events = 12288 if quick else 16384
    base_batch, cap = 128, 2048
    sizes = [base_batch]
    while sizes[-1] * 2 <= cap:
        sizes.append(sizes[-1] * 2)
    rng = np.random.default_rng(0)
    feats = rng.normal(0, 1, (n_events, DIM)).astype(np.float32)
    runs: dict[str, tuple] = {}
    launches: dict[str, int] = {}
    windows: dict[str, list[int]] = {}
    seconds: dict[str, float] = {}

    def held_launches(name: str, launched: int, dispatched: int,
                      n_windows: int) -> None:
        """The banked kernel launched once a window of the timed stream
        (on the card; on the CPU the plain version runs and counts none)."""
        if dispatched != n_windows or (cuda and launched != n_windows):
            raise RuntimeError(f"{name}: {launched} launches and "
                               f"{dispatched} dispatches for {n_windows} "
                               f"windows")
        launches[name] = launched

    # synchronous baseline: ServerBatcher flushes fixed windows
    server_sync = build_server(n_tenants, dev)
    _warm(server_sync, n_tenants, sizes)
    sb = ServerBatcher(server_sync,
                       MicroBatcher(max_batch=base_batch, max_wait_ms=1e9))
    reqs_sync = requests(feats, n_tenants)
    out_sync: list = []
    flushed: list[int] = []
    l0, d0 = _banked_launches(), server_sync.metrics["kernel_dispatches"]
    t0 = time.perf_counter()
    for r in reqs_sync:
        done = sb.submit(r)
        if done:
            out_sync.extend(done)
            flushed.append(len(done))
    tail = sb.drain()
    out_sync.extend(tail)
    seconds["sync"] = time.perf_counter() - t0
    if tail:
        flushed.append(len(tail))
    held_launches("sync", _banked_launches() - l0,
                  server_sync.metrics["kernel_dispatches"] - d0, len(flushed))
    windows["sync"] = flushed
    runs["sync"] = (server_sync, reqs_sync, out_sync)

    def engine_run(name: str, config: ServerConfig | None, adaptive: bool):
        server = build_server(n_tenants, dev, config)
        _warm(server, n_tenants, sizes)
        engine = AsyncDispatchEngine(
            server, max_batch=base_batch, max_wait_ms=1e9,
            adaptive_batch_cap=cap if adaptive else None)
        engine.submit_many(requests(feats[:base_batch], n_tenants))
        engine.drain(timeout=300.0)
        engine.window_log.clear()
        reqs = requests(feats, n_tenants)
        l0, d0 = _banked_launches(), server.metrics["kernel_dispatches"]
        t0 = time.perf_counter()
        engine.submit_many(reqs)
        out = engine.drain(timeout=600.0)
        seconds[name] = time.perf_counter() - t0
        launched = _banked_launches() - l0
        dispatched = server.metrics["kernel_dispatches"] - d0
        windows[name] = [w["size"] for w in engine.window_log]
        errors = list(engine.errors)
        engine.close()
        if errors:
            raise RuntimeError(f"engine stage errors: {errors[:3]}")
        held_launches(name, launched, dispatched, len(windows[name]))
        if sum(windows[name]) != n_events:
            raise RuntimeError(f"{name}: windows hold {sum(windows[name])} "
                               f"of {n_events} events")
        runs[name] = (server, reqs, out)

    engine_run("engine_fixed", None, False)
    engine_run("engine_adaptive", None, True)
    engine_run("track_off", ServerConfig(track_quantiles=False), True)
    engine_run("track_on", ServerConfig(track_device=True), True)
    server_on = runs["track_on"][0]
    staged = int(server_on.metrics["track_staged_windows"])
    if staged <= 0:
        raise RuntimeError("the device tracker staged no window")
    # estimator_streams() is the host-pull boundary: everything staged on
    # the device (warm-ups + timed stream) materializes, nothing lost
    tracked = sum(e.count for e in server_on.estimator_streams().values())
    want_tracked = n_events + sum(sizes) + base_batch
    if tracked != want_tracked:
        raise RuntimeError(f"tracked {tracked} events, want {want_tracked}")

    # every response against its own raw scores through the kernel, then
    # the runs against each other
    bank = TransformBank.from_params(
        [(p.betas, p.weights, p.src_quantiles, p.ref_quantiles)
         for p in (server_sync.predictors[f"p{i}"].pipeline
                   for i in range(n_tenants))], device=dev)
    held = {name: _held(name, server, reqs, out, bank, dev)
            for name, (server, reqs, out) in runs.items()}
    scores_sync, raws_sync = held["sync"]
    raw_rows_differ, max_err = {}, {}
    for name, (scores, raws) in held.items():
        raw_rows_differ[name] = int(np.sum(np.any(
            raws.view(np.uint32) != raws_sync.view(np.uint32), axis=1)))
        max_err[name] = float(max(np.max(np.abs(raws - raws_sync)),
                                  np.max(np.abs(scores - scores_sync))))
        if not max_err[name] <= TOL:
            raise RuntimeError(f"{name}: max abs err {max_err[name]} "
                               f"against the sync run")
    (s_off, r_off), (s_on, r_on) = held["track_off"], held["track_on"]
    same_raws = np.all(r_off.view(np.uint32) == r_on.view(np.uint32), axis=1)
    touched = int(np.sum(s_off[same_raws].view(np.uint32)
                         != s_on[same_raws].view(np.uint32)))
    if touched:
        raise RuntimeError(f"tracking changed {touched} scores of rows with "
                           f"bitwise equal raw scores")

    return {
        "device": torch.cuda.get_device_name(dev) if cuda else str(dev),
        "nvidia_smi": _nvidia_smi() if cuda else None,
        "quick": quick,
        "timer": ("host clock over the timed stream, ended by the engine's "
                  "drain (each window ends in a device sync)"
                  if cuda else "host clock of a CPU run of the plain "
                  "versions: no number of the card"),
        "tenants": n_tenants, "events": n_events, "base_batch": base_batch,
        "adaptive_cap": cap, "knots": KNOTS,
        "events_per_s": {name: n_events / dt for name, dt in seconds.items()},
        "speedup_fixed_vs_sync": seconds["sync"] / seconds["engine_fixed"],
        "speedup_adaptive_vs_sync":
            seconds["sync"] / seconds["engine_adaptive"],
        "tracking_on_off_ratio": seconds["track_off"] / seconds["track_on"],
        "window_sizes": {name: sorted(set(w)) for name, w in windows.items()},
        "windows": {name: len(w) for name, w in windows.items()},
        # banked kernel launches of each run's timed stream, one a window
        "launches": launches,
        "track_staged_windows": staged,
        "track_spills": int(server_on._tracker.spills),
        "tracked_events": tracked,
        # rows whose raw scores are not the sync run's bits (cuBLAS picks
        # its GEMM by the window's rows), and each run's max abs err
        # against the sync run over raw scores and scores
        "raw_rows_differ_vs_sync": raw_rows_differ,
        "max_abs_err_vs_sync": max_err,
        "track_on_off_rows_same_raws": int(same_raws.sum()),
        "replayed_bitwise_runs": sorted(held),
    }


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
