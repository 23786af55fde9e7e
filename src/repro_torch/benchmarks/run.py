"""Run every benchmark of the port, one per paper table or figure and one
per layer, in the reference's order (``benchmarks/run.py``).

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--quick] \\
        [--device cpu] [--out DIR]

Prints ``name,us_per_call,derived`` CSV rows, one per headline of each
benchmark (the kernel microbenchmark gives one row a kernel), as the
reference's runner does; ``us_per_call`` is the host wall time of the
whole benchmark where the reference's row has it, else the benchmark's
own headline time.  With ``--out DIR`` each benchmark's full result is
written to ``DIR/<name>.json`` (the kernels' to ``DIR/kernels.json``);
without it nothing is written.  The
root ``BENCH_*.json`` mirrors belong to the reference and are not written
here.  Without ``--device`` every benchmark runs on the card, or raises.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from repro_torch.benchmarks import (bench_appendix_a, bench_async_engine,
                                    bench_attack_campaign,
                                    bench_fig4_quantile_update,
                                    bench_fig5_rollout,
                                    bench_fig6_model_update,
                                    bench_fleet_refresh, bench_kernels,
                                    bench_multitenant_batch,
                                    bench_serving_latency,
                                    bench_sharded_bank,
                                    bench_table1_calibration,
                                    bench_tiered_bank)


def _timed(fn, **kw) -> tuple[dict, float]:
    """A benchmark's result and its host wall time in microseconds."""
    t0 = time.perf_counter()
    result = fn(**kw)
    return result, (time.perf_counter() - t0) * 1e6


def _benchmarks(quick: bool, device):
    """Yield (name, result, row) for each benchmark: its CSV row as
    (us_per_call, derived), or for the kernels a list of named rows
    (name, us_per_call, derived)."""
    kw = {"quick": quick, "device": device}

    r, dt = _timed(bench_table1_calibration.run, **kw)
    yield "table1_calibration", r, (dt, (
        f"mean_expert_ece_change_pct={r['mean_expert_ece_change_pct']:.1f};"
        f"ensemble_ece_change_pct={r['ensemble_ece_change_pct']:.1f};"
        f"paper=-80_to_-98_and_-90.8"))

    r, dt = _timed(bench_fig4_quantile_update.run, **kw)
    yield "fig4_quantile_update", r, (dt, (
        f"raw_mass_first_bin={r['raw_mass_in_first_bin']:.3f};"
        f"v0_max_high_bin_err={r['v0_max_abs_rel_err_high_bins']:.2f};"
        f"v1_max_mid_bin_err={r['v1_max_abs_rel_err_mid_bins']:.3f}"))

    r = bench_fig4_quantile_update.run_refresh(**kw)
    yield "fig4_fleet_refresh", r, (r["wall_ms_at_max"] * 1e3, (
        f"tenants={r['max_tenants']};"
        f"us_per_tenant={r['us_per_tenant_at_max']:.1f};"
        f"atomic_generations={r['rows'][-1]['generation']}"))

    r, dt = _timed(bench_fig6_model_update.run, **kw)
    yield "fig6_model_update", r, (dt, (
        f"recall_p1={r['recall_p1']:.4f};recall_p2={r['recall_p2']:.4f};"
        f"monotone_recall_invariant="
        f"{abs(r['recall_p1.5'] - r['recall_p2']) < 1e-9};"
        f"p15_max_err={r['p15_max_abs_err']:.2f};"
        f"p2_max_err={r['p2_max_abs_err']:.2f};"
        f"alert_rate_p15={r['alert_rate_p1.5']:.4f};"
        f"alert_rate_p2={r['alert_rate_p2']:.4f};psi_p2={r['psi_p2']:.3f}"))

    r, dt = _timed(bench_fig5_rollout.run, **kw)
    yield "fig5_rollout", r, (dt, (
        f"pod_peak={r['pod_peak']};min_ready={r['min_ready']};"
        f"p99_latency_ms={r['latency_p99_ms']:.2f};"
        f"final_version={r['final_version']}"))

    r, dt = _timed(bench_appendix_a.run, **kw)
    worst = min(row["coverage_at_n"] for row in r["rows"])
    yield "appendix_a_samplesize", r, (dt, (
        f"worst_coverage_at_n={worst:.3f};nominal=0.95;"
        f"rows={len(r['rows'])}"))

    r = bench_serving_latency.run(**kw)
    yield "serving_latency", r, (r["batch_1"]["latency_ms"] * 1e3, (
        f"events_per_s_b256={r['batch_256']['events_per_s']:.0f};"
        f"transform_share_pct={r['transform_share_of_path_pct']:.2f}"))

    r = bench_multitenant_batch.run(**kw)
    yield "multitenant_batch", r, (r["us_banked"], (
        f"kernel_speedup={r['kernel_speedup']:.1f}x;"
        f"events_per_s_banked={r['events_per_s_banked']:.0f};"
        f"quantile_update_speedup={r['quantile_update_speedup']:.1f}x;"
        f"max_abs_err={r['max_abs_err_vs_oracle']:.2e}"))

    r = bench_sharded_bank.run(**kw)
    yield "sharded_bank", r, (r["us_per_batch_smax"], (
        f"tenants={r['max_tenants']};shards={r['max_shards']};"
        f"residency_ratio={r['residency_ratio_at_smax']:.3f};"
        f"throughput_ratio_s1={r['throughput_ratio_s1']:.2f}x;"
        f"bitwise_parity={r['all_bitwise_parity']}"))

    r = bench_tiered_bank.run(**kw)
    last = r["rows"][-1]
    yield "tiered_bank", r, (last["us_per_batch_hot"], (
        f"tenants={last['tenants']};"
        f"device_kb={last['device_bytes'] / 1024:.0f};"
        f"hot_events_per_s={last['events_per_s_hot']:.0f};"
        f"hot_vs_s8={r['hot_vs_sharded_s8_ratio']:.2f}x;"
        f"stall_rate_mixed={last['stall_rate_mixed']:.4f};"
        f"stall_rate_prefetched={last['stall_rate_prefetched']:.4f};"
        f"p99_ms_locked_staging="
        f"{r['p99_ms_dispatch_locked_staging']:.2f};"
        f"p99_ms_overlap_staging="
        f"{r['p99_ms_dispatch_overlap_staging']:.2f}"))

    r = bench_fleet_refresh.run(**kw)
    yield "fleet_refresh", r, (r["wall_ms_at_max"] * 1e3, (
        f"replicas={r['max_replicas']};streams={r['tenants']};"
        f"merge_ms={r['merge_ms_at_max']:.1f};"
        f"publish_ms={r['publish_ms_at_max']:.1f};"
        f"refit_ratio_max_vs_min={r['refit_ratio_max_vs_min']:.2f};"
        f"all_within_bound={r['all_within_bound']}"))

    r = bench_attack_campaign.run(**kw)
    yield "attack_campaign", r, (r["us_per_event_attack"], (
        f"p99_quiet_ms={r['p99_ms_quiet']:.2f};"
        f"p99_attack_ms={r['p99_ms_attack']:.2f};"
        f"p99_ratio={r['p99_ratio_attack_vs_quiet']:.2f};"
        f"audit_us_per_event={r['audit_us_per_event']:.2f};"
        f"attack_refreshes={r['attack_refreshes']}"))

    r = bench_async_engine.run(**kw)
    eps = r["events_per_s"]
    yield "async_engine", r, (1e6 / eps["engine_adaptive"], (
        f"speedup={r['speedup_adaptive_vs_sync']:.2f}x;"
        f"speedup_fixed_windows={r['speedup_fixed_vs_sync']:.2f}x;"
        f"events_per_s_async={eps['engine_adaptive']:.0f};"
        f"events_per_s_sync={eps['sync']:.0f};"
        f"tracking_on_off_ratio={r['tracking_on_off_ratio']:.2f};"
        f"tenants={r['tenants']}"))

    r = bench_kernels.run(**kw)
    rows = []
    for name, e in r["entries"].items():
        derived = f"allclose={e['kernel_allclose']}"
        if "skip_rate_sorted" in e:
            derived += (f";skip_rate_sorted={e['skip_rate_sorted']:.2f}"
                        f";skip_rate_adversarial="
                        f"{e['skip_rate_adversarial']:.2f}")
        rows.append((f"kernel_{name}", e["us_per_call"], derived))
    yield "kernels", r, rows


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--quick", action="store_true",
                        help="the reference's quick sizes")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card, or fail)")
    parser.add_argument("--out", default=None,
                        help="write each benchmark's result into DIR")
    args = parser.parse_args(argv)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    print("name,us_per_call,derived", flush=True)
    t_all = time.perf_counter()
    for bench, result, row in _benchmarks(args.quick, args.device):
        rows = row if isinstance(row, list) else [(bench, *row)]
        for name, us, derived in rows:
            print(f"{name},{us:.3f},{derived}", flush=True)
        if args.out:
            with open(os.path.join(args.out, f"{bench}.json"), "w") as f:
                json.dump(result, f, indent=1)
                f.write("\n")
    print(f"\n# total bench time: {time.perf_counter() - t_all:.1f}s",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
