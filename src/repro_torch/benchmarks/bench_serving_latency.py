"""Serving latency and throughput of the scoring data plane, and the
transform's share of it (the paper's "negligible overhead" claim).

The port's counterpart of the reference's ``benchmarks/bench_serving_latency.py``
at its sizes and seeds: ``FraudWorld.build(seed=5)``, one predictor over the
three experts m1-m3 with the cold-start T^Q (one Beta-mixture trial),
``warm_up`` at batch 1 / 16 / 64 / 256, then ``MuseServer.score_batch`` at
those batch sizes, 60 calls each (20 with ``--quick``), requests drawn from
``default_rng(0)``:

  * **path** — host wall time of one ``score_batch`` call (routing, the
    experts, ONE banked kernel launch, responses, tracking; it ends with the
    scores on the host), and events/s;
  * **transform alone** — Eq. 2 on 4,096 rows through ``ops.score_pipeline``
    (the shared-parameter kernel, ``csrc/score_pipeline.cu``): host wall time
    of 50 back-to-back launches ended by a device sync, over 50 (the
    reference times its jitted pipeline the same way), and on the card the
    kernel's own time from CUDA events;
  * ``transform_share_of_path_pct`` — the reference's formula: the
    transform's ns an event over the path's at batch 256.

The kernel's scores are checked against the plain ``score_pipeline`` within
2e-5 (the run raises otherwise).  On the card (the default) the times are
the card's; with ``--device cpu`` the same code runs the plain versions on
the CPU: that run shows the entry point works and measures nothing of the
card.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_serving_latency \\
        [--quick] [--device cpu] [--out PATH]
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from repro_torch.benchmarks import cli, timing
from repro_torch.core.routing import Condition, Intent, RoutingTable, ScoringRule
from repro_torch.device import resolve_device
from repro_torch.experiments.fraud_world import DIM, FraudWorld
from repro_torch.kernels import ops, ref
from repro_torch.serving.server import MuseServer
from repro_torch.serving.types import ScoringRequest
from repro_torch.serving.warmup import warm_up

ENSEMBLE = ("m1", "m2", "m3")
BATCHES = (1, 16, 64, 256)
PIPELINE_ROWS = 4096
TOL = 2e-5


def _timeit(fn, *args, repeat: int = 50, sync=None) -> float:
    """The reference's timer: one warm-up call, then mean host seconds over
    ``repeat`` back-to-back calls, ended by ``sync`` (the device's)."""
    fn(*args)
    t0 = time.perf_counter()
    for _ in range(repeat):
        fn(*args)
    if sync is not None:
        sync()
    return (time.perf_counter() - t0) / repeat


def run(quick: bool = False, device: torch.device | str | None = None
        ) -> dict:
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else None
    world = FraudWorld.build(seed=5)
    table = RoutingTable((ScoringRule(Condition(), "p"),), version="v1")
    server = MuseServer(table, device=dev)
    qm = world.coldstart_quantile_map(ENSEMBLE, n_trials=1)
    server.deploy(world.predictor_spec("p", ENSEMBLE, qm),
                  world.model_factories(dev))
    warm_up(server, DIM, batch_sizes=BATCHES)

    before = dict(ops.LAUNCHES)
    rng = np.random.default_rng(0)
    results: dict = {}
    for bs in BATCHES:
        reqs = [ScoringRequest(intent=Intent(tenant="t"),
                               features=rng.normal(0, 1, DIM).astype(np.float32))
                for _ in range(bs)]
        per_call = _timeit(server.score_batch, reqs,
                           repeat=20 if quick else 60)
        results[f"batch_{bs}"] = {"latency_ms": per_call * 1e3,
                                  "events_per_s": bs / per_call}

    # the transformation pipeline alone, on the device: the kernel
    n = PIPELINE_ROWS
    raw = torch.tensor(rng.uniform(0, 1, (n, len(ENSEMBLE))),
                       dtype=torch.float32, device=dev)
    betas = torch.tensor([world.experts[m].beta for m in ENSEMBLE],
                         dtype=torch.float32, device=dev)
    weights = torch.ones(len(ENSEMBLE), dtype=torch.float32, device=dev)
    src, refq = (qm.src_quantiles.to(dev), qm.ref_quantiles.to(dev))
    args = (raw, betas, weights, src, refq)
    err = float((ops.score_pipeline(*args) - ref.score_pipeline(*args))
                .abs().max())
    if not err <= TOL:
        raise RuntimeError(f"score_pipeline off its plain version by {err}")
    t_pipe = _timeit(lambda: ops.score_pipeline(*args), sync=sync)
    results["transform_pipeline_4096"] = {
        "latency_ms": t_pipe * 1e3, "ns_per_event": t_pipe / n * 1e9,
        "kernel_ms": timing.device_ms(lambda: ops.score_pipeline(*args))
        if cuda else None,
        "max_abs_err_vs_plain": err}
    full_per_event_us = results["batch_256"]["latency_ms"] * 1e3 / 256
    tf_per_event_us = t_pipe / n * 1e6
    results["transform_share_of_path_pct"] = \
        100.0 * tf_per_event_us / full_per_event_us
    launches = {k: ops.LAUNCHES[k] - before[k] for k in before}
    results.update({
        "device": torch.cuda.get_device_name(dev) if cuda else str(dev),
        "nvidia_smi": cli.nvidia_smi() if cuda else None,
        "quick": quick,
        "timer": ("host clock; the kernel's time from CUDA events" if cuda
                  else "host clock of a CPU run of the plain versions: no "
                  "number of the card"),
        "launches": launches,
        "kernel_dispatches": server.metrics["kernel_dispatches"]})
    return results


def main(argv: list[str] | None = None) -> int:
    return cli.main(run, __doc__, argv)


if __name__ == "__main__":
    sys.exit(main())
