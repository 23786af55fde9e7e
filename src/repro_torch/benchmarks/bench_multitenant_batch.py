"""Mixed-tenant micro-batch throughput: one banked launch against a loop of
per-predictor launches.

The port's counterpart of the reference's
``benchmarks/bench_multitenant_batch.py`` at its sizes and seed: 64 tenants
x 1,024 events (16 x 256 with ``--quick``), K = 4 experts, N = 256 knots,
``default_rng(0)``, 20 repeats (5):

  * **banked** — the whole mixed-tenant batch in ONE launch of the banked
    kernel (``csrc/score_pipeline_banked.cu``);
  * **per-predictor loop** — the seed's path: one launch of the
    shared-parameter kernel (``csrc/score_pipeline.cu``) per tenant present
    in the batch, over that tenant's rows (64 launches);
  * **parity** — the banked kernel against the plain banked version (the
    tables are sorted, so bitwise is expected and reported), each loop
    launch against the plain ``score_pipeline``, all within 2e-5 (the run
    raises otherwise);
  * **tracking** — one batched ``StreamingQuantileEstimator.update`` of the
    batch's 1,024 values against 1,024 one-element updates (host numpy).

Times are host wall time over the repeats, ended by a device sync (the
reference's timer).  On the card (the default) they are the card's; with
``--device cpu`` the same code runs the plain versions on the CPU: that run
shows the entry point works and measures nothing of the card.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_multitenant_batch \\
        [--quick] [--device cpu] [--out PATH]
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from repro_torch.benchmarks import cli
from repro_torch.core.quantiles import StreamingQuantileEstimator
from repro_torch.device import resolve_device, to_numpy
from repro_torch.kernels import ops, ref

TOL = 2e-5


def _timeit(fn, repeat: int, sync=None) -> float:
    """The reference's timer: one warm-up call, then mean host seconds over
    ``repeat`` back-to-back calls, ended by ``sync`` (the device's)."""
    fn()
    if sync is not None:
        sync()
    t0 = time.perf_counter()
    for _ in range(repeat):
        fn()
    if sync is not None:
        sync()
    return (time.perf_counter() - t0) / repeat


def run(quick: bool = False, device: torch.device | str | None = None
        ) -> dict:
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else None
    rng = np.random.default_rng(0)
    t = 16 if quick else 64          # tenants
    b = 256 if quick else 1024       # events in the micro-batch
    k, n = 4, 256                    # experts, quantile knots
    repeat = 5 if quick else 20

    def f32(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    betas = f32(rng.uniform(0.05, 1.0, (t, k)))
    weights = f32(rng.uniform(0.1, 2.0, (t, k)))
    src = f32(np.sort(rng.uniform(0, 1, (t, n)), axis=-1))
    refq = f32(np.sort(rng.uniform(0, 1, (t, n)), axis=-1))
    scores = f32(rng.uniform(0, 1, (b, k)))
    tid_np = rng.integers(0, t, b).astype(np.int32)
    tid = torch.from_numpy(tid_np).to(dev)
    before = dict(ops.LAUNCHES)

    # --- banked: ONE launch for the whole mixed-tenant batch --------------
    def banked():
        return ops.score_pipeline_banked(scores, tid, betas, weights, src,
                                         refq)

    t_banked = _timeit(banked, repeat, sync)

    # --- seed path: one shared-parameter launch per predictor -------------
    rows_per_tenant = [np.flatnonzero(tid_np == i) for i in range(t)]
    score_rows = [scores[torch.from_numpy(r).to(dev)] for r in rows_per_tenant]
    present = [i for i in range(t) if len(rows_per_tenant[i])]

    def per_predictor_loop():
        return [ops.score_pipeline(score_rows[i], betas[i], weights[i],
                                   src[i], refq[i]) for i in present]

    t_loop = _timeit(per_predictor_loop, repeat, sync)

    # --- parity: each kernel against its plain version --------------------
    got = to_numpy(banked())
    want = to_numpy(ref.score_pipeline_banked(scores, tid, betas, weights,
                                              src, refq))
    max_err = float(np.max(np.abs(got - want)))
    loop_err = loop_vs_banked = 0.0
    for i, out in zip(present, per_predictor_loop()):
        plain = ref.score_pipeline(score_rows[i], betas[i], weights[i],
                                   src[i], refq[i])
        loop_err = max(loop_err, float((out - plain).abs().max()))
        loop_vs_banked = max(loop_vs_banked, float(np.max(np.abs(
            to_numpy(out) - got[rows_per_tenant[i]]))))
    if not (max_err <= TOL and loop_err <= TOL):
        raise RuntimeError(f"kernels off their plain versions: banked "
                           f"{max_err}, per-predictor {loop_err}")

    # --- quantile tracking: one batched update vs element-at-a-time -------
    agg = np.asarray(rng.uniform(0, 1, b))
    est_batched = StreamingQuantileEstimator(capacity=1 << 16)
    t_upd_batched = _timeit(lambda: est_batched.update(agg), repeat)
    est_scalar = StreamingQuantileEstimator(capacity=1 << 16)

    def scalar_updates():
        for x in agg:
            est_scalar.update(np.asarray([x]))

    t_upd_scalar = _timeit(scalar_updates, max(1, repeat // 5))
    launches = {key: ops.LAUNCHES[key] - before[key] for key in before}
    return {
        "device": torch.cuda.get_device_name(dev) if cuda else str(dev),
        "nvidia_smi": cli.nvidia_smi() if cuda else None,
        "quick": quick,
        "timer": ("host clock over back-to-back launches, ended by a device "
                  "sync" if cuda else "host clock of a CPU run of the plain "
                  "versions: no number of the card"),
        "tenants": t,
        "batch": b,
        "experts": k, "knots": n,
        "loop_launches_per_call": len(present),
        "us_banked": t_banked * 1e6,
        "us_per_predictor_loop": t_loop * 1e6,
        "kernel_speedup": t_loop / t_banked,
        "events_per_s_banked": b / t_banked,
        "events_per_s_loop": b / t_loop,
        "max_abs_err_vs_oracle": max_err,
        "bitwise_vs_oracle": bool(np.array_equal(got.view(np.uint32),
                                                 want.view(np.uint32))),
        "max_abs_err_loop_vs_plain": loop_err,
        # the two kernels sum the weights in their own orders
        "max_abs_diff_loop_vs_banked": loop_vs_banked,
        "us_quantile_update_batched": t_upd_batched * 1e6,
        "us_quantile_update_scalar": t_upd_scalar * 1e6,
        "quantile_update_speedup": t_upd_scalar / t_upd_batched,
        "launches": launches,
    }


def main(argv: list[str] | None = None) -> int:
    return cli.main(run, __doc__, argv)


if __name__ == "__main__":
    sys.exit(main())
