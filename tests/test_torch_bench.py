"""The port's benchmarks and their timing module, on the CPU.

``python -m repro_torch.benchmarks.bench_kernels --quick --device cpu``
runs in a subprocess and writes its five entries, each agreeing with its
plain version (on the CPU ``ops`` runs the plain versions, so this shows
the entry point works; it measures nothing of the card); the async-engine,
tiered-store, sharded-bank, serving-latency and multi-tenant-batch
benchmarks, and the seven of the paper's tables and figures, run the same
way at their quick sizes.  The
least-time bounds of ``benchmarks/timing.py`` are checked against the byte
and operation counts written out by hand.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro_torch.benchmarks import timing

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENTRIES = {"quantile_map_16k": "quantile_map",
           "score_pipeline_16kx8": "score_pipeline",
           "score_pipeline_banked_16kx8": "score_pipeline_banked",
           "flash_attention_256": "flash_attention",
           "decode_attention_4096": "decode_attention"}


def test_quick_cpu_run_writes_five_entries(tmp_path):
    out = tmp_path / "bench.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.bench_kernels",
         "--quick", "--device", "cpu", "--out", str(out)],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr
    result = json.loads(out.read_text())
    assert json.loads(proc.stdout) == result
    assert result["device"] == "cpu" and result["nvidia_smi"] is None
    assert {n: e["kernel"] for n, e in result["entries"].items()} == ENTRIES
    for name, entry in result["entries"].items():
        assert entry["kernel_allclose"] is True, name
        assert entry["max_abs_err"] == 0.0, name   # plain against plain
        assert entry["bound_by"] in ("bytes", "operations")
        assert entry["us_per_call"] > 0 and entry["bound_us"] > 0
    banked = result["entries"]["score_pipeline_banked_16kx8"]
    assert banked["skip_rate_sorted"] == 1.0
    assert banked["skip_rate_adversarial"] == 0.0
    # on the CPU no hand-written kernel launches
    assert set(result["launches"].values()) == {0}
    # one count per kernel; the flash entry's wrapper also counts the
    # tensor-core forms it picks on the card
    assert set(result["launches"]) == set(ENTRIES.values()) | {
        "flash_attention_wgmma", "flash_attention_tf32x3"}


def _quick_cpu(module, tmp_path):
    out = tmp_path / f"{module}.json"
    proc = subprocess.run(
        [sys.executable, "-m", f"repro_torch.benchmarks.{module}",
         "--quick", "--device", "cpu", "--out", str(out)],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr
    result = json.loads(out.read_text())
    assert json.loads(proc.stdout) == result
    assert result["device"] == "cpu" and result["nvidia_smi"] is None
    assert result["quick"] is True
    return result


def test_async_engine_quick_cpu_run(tmp_path):
    """The engine benchmark at the reference's quick sizes: five runs of
    the same 12,288 events, every response bitwise its own raw scores
    replayed through the banked pipeline, the runs within 2e-5 of each
    other, a dispatch a window (the run raises otherwise), every event of
    the device-tracking run tracked."""
    result = _quick_cpu("bench_async_engine", tmp_path)
    assert result["tenants"] == 16 and result["events"] == 12288
    runs = {"sync", "engine_fixed", "engine_adaptive", "track_off",
            "track_on"}
    assert set(result["events_per_s"]) == set(result["replayed_bitwise_runs"]) \
        == set(result["windows"]) == set(result["launches"]) == runs
    assert all(v > 0 for v in result["events_per_s"].values())
    assert result["window_sizes"]["engine_fixed"] == [128]
    assert result["windows"]["sync"] == result["windows"]["engine_fixed"] \
        == 12288 // 128
    assert max(result["window_sizes"]["engine_adaptive"]) <= 2048
    # the CPU runs the plain version: no kernel launch is counted
    assert set(result["launches"].values()) == {0}
    assert all(e <= 2e-5 for e in result["max_abs_err_vs_sync"].values())
    assert result["tracked_events"] == 12288 + sum(
        128 << i for i in range(5)) + 128
    assert result["track_staged_windows"] > 0


def test_tiered_bank_quick_cpu_run(tmp_path):
    """The tiered-store benchmark at the reference's quick sizes: bitwise
    parity with the dense bank (the run raises otherwise), device bytes
    fixed by the configuration, stalls cut by the prefetch."""
    result = _quick_cpu("bench_tiered_bank", tmp_path)
    rows = result["rows"]
    assert [r["tenants"] for r in rows] == [1024, 10_000]
    assert {r["device_bytes"] for r in rows} == {512 * (2 * 4 + 2 * 256) * 4}
    assert rows[-1]["host_bytes"] == 10_000 * (2 * 4 + 2 * 256) * 4
    for r in rows:
        assert r["stall_rate_prefetched"] < r["stall_rate_mixed"]
    assert rows[-1]["stall_rate_prefetched"] == 0.0
    assert result["p99_ms_dispatch_locked_staging"] > 0
    assert result["p99_ms_dispatch_overlap_staging"] > 0
    assert result["parity_passes"] > 1       # 1,024 cold rows, 127 victims
    assert result["dispatch_launches"] == 0  # the plain version on the CPU
    assert result["dispatch_passes"] > 0


def test_tiered_bank_baseline_is_the_sharded_dispatch(tmp_path):
    """The tiered benchmark's baseline is the S = 8 sharded dispatch at its
    batch, K and N, measured in the same run (the reference's baseline)."""
    result = _quick_cpu("bench_tiered_bank", tmp_path)
    assert result["sharded_s8_events_per_s_t4096"] > 0
    assert result["hot_vs_sharded_s8_ratio"] == pytest.approx(
        result["rows"][-1]["events_per_s_hot"]
        / result["sharded_s8_events_per_s_t4096"])


def test_sharded_bank_quick_cpu_run(tmp_path):
    """The sharded-bank benchmark at the reference's quick sizes: every
    sharded row bitwise equal to the dense launch (the run raises
    otherwise), resident bytes exactly 1/S of the dense bank."""
    result = _quick_cpu("bench_sharded_bank", tmp_path)
    rows = result["rows"]
    assert result["batch"] == 2048 and result["tenant_counts"] == [256, 1024]
    assert [(r["tenants"], r["shards"]) for r in rows] == [
        (t, s) for t in (256, 1024) for s in (0, 1, 2, 4, 8)]
    for r in rows:
        dense = r["tenants"] * (2 * 4 + 2 * 256) * 4
        assert r["resident_bytes"] == dense // max(r["shards"], 1)
        assert r["residency_ratio"] == 1 / max(r["shards"], 1)
        assert r["bitwise_parity"] is True and r["events_per_s"] > 0
        assert r["launches_per_call"] == 0      # the plain version on the CPU
        assert r["banked_path"] == "plain"
    assert result["per_shard_bytes_at_smax"] == 266_240
    assert result["all_bitwise_parity"] is True


def test_serving_latency_quick_cpu_run(tmp_path):
    """The serving-latency benchmark: the path at four batch sizes, the
    transform alone at 4,096 rows within 2e-5 of its plain version, and
    the transform's share of the path by the reference's formula."""
    result = _quick_cpu("bench_serving_latency", tmp_path)
    for bs in (1, 16, 64, 256):
        row = result[f"batch_{bs}"]
        assert row["latency_ms"] > 0
        assert row["events_per_s"] == pytest.approx(
            bs / row["latency_ms"] * 1e3)
    pipe = result["transform_pipeline_4096"]
    assert pipe["max_abs_err_vs_plain"] == 0.0 and pipe["kernel_ms"] is None
    share = 100.0 * (pipe["latency_ms"] / 4096) / (
        result["batch_256"]["latency_ms"] / 256)
    assert result["transform_share_of_path_pct"] == pytest.approx(share)
    assert set(result["launches"].values()) == {0}
    # warm-up (two calls of each batch) plus 21 calls of each batch
    assert result["kernel_dispatches"] == 4 * 21


def test_multitenant_batch_quick_cpu_run(tmp_path):
    """The banked launch against the per-predictor loop at the reference's
    quick sizes: both agree with their plain versions."""
    result = _quick_cpu("bench_multitenant_batch", tmp_path)
    assert (result["tenants"], result["batch"]) == (16, 256)
    assert result["loop_launches_per_call"] == 16
    assert result["max_abs_err_vs_oracle"] == 0.0
    assert result["bitwise_vs_oracle"] is True
    assert result["max_abs_err_loop_vs_plain"] == 0.0
    assert result["max_abs_diff_loop_vs_banked"] <= 2e-5
    assert result["us_banked"] > 0 and result["us_per_predictor_loop"] > 0
    assert result["quantile_update_speedup"] > 1.0
    assert set(result["launches"].values()) == {0}


# the paper's tables and figures: one fact of each quick result beside the
# checks every CLI run gets (their parity with the reference:
# tests/test_torch_paper_figs.py and tests/test_torch_paper_fleet.py)
PAPER_CLI = {
    "bench_table1_calibration": lambda r: len(r["rows"]) == 7,
    "bench_fig4_quantile_update": lambda r: (
        r["refresh"]["max_tenants"] == 64
        and r["tq_vs_plain"]["v1"]["scores"] == 60_000),
    "bench_fig6_model_update": lambda r: r["recall_p1.5"] == r["recall_p2"],
    "bench_fig5_rollout": lambda r: r["invariants_ok"] is True,
    "bench_appendix_a": lambda r: len(r["rows"]) == 8,
    "bench_fleet_refresh": lambda r: r["all_within_bound"] is True,
    "bench_attack_campaign": lambda r: r["attack_refreshes"] > 0,
}


@pytest.mark.parametrize("module", sorted(PAPER_CLI))
def test_paper_benchmark_quick_cpu_run(module, tmp_path):
    """``python -m repro_torch.benchmarks.<module> --quick --device cpu
    --out PATH`` prints the result it writes, on the CPU, launching no
    kernel."""
    result = _quick_cpu(module, tmp_path)
    assert PAPER_CLI[module](result)
    assert set(result.get("launches", {0: 0}).values()) == {0}


def test_bounds_count_bytes_and_operations():
    hbm, f32, bf16 = (timing.HBM_BYTES_PER_S, timing.F32_FLOPS,
                      timing.BF16_FLOPS)
    m, k, n, t = 65_536, 8, 256, 64
    # the exact bucket is a search: ceil(log2 N) + 1 compares, and 10
    # operations of interpolation and clip
    assert [timing._tq_ops(x) for x in (2, 33, 256, 4096)] == [12, 17, 19, 23]
    ms, by = timing.quantile_map_bound(m, n, 4)
    nbytes = 2 * m * 4 + 2 * n * 4
    assert by == "bytes" and ms == pytest.approx(nbytes / hbm * 1e3)
    assert m * 19 / f32 < nbytes / hbm
    ms, by = timing.score_pipeline_bound(m, k, n, 4)
    nbytes = m * k * 4 + m * 4 + (2 * k + 2 * n) * 4
    assert by == "bytes" and ms == pytest.approx(nbytes / hbm * 1e3)
    ms, by = timing.banked_bound(m, k, t, n)
    nbytes = m * k * 4 + 2 * m * 4 + t * (2 * k + 2 * n) * 4
    assert by == "bytes" and ms == pytest.approx(nbytes / hbm * 1e3)
    # bf16 scores halve the bytes of the scores and results
    assert timing.quantile_map_bound(m, 16, 2)[0] < \
        timing.quantile_map_bound(m, 16, 4)[0]


def test_attention_bounds():
    # qwen3-8b's decode: 4 x 2,064 valid positions, 32/8 heads of 128, bf16
    ms, by = timing.decode_bound([2064] * 4, 32, 8, 128, 2)
    nbytes = 2 * 4 * 2064 * 8 * 128 * 2 + 2 * 4 * 32 * 128 * 2 + 16
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert ms == pytest.approx(0.0101, abs=5e-5)
    # a row of length 0 reads no cache
    assert timing.decode_bound([0, 10], 8, 2, 64, 2)[0] == pytest.approx(
        timing.decode_bound([10], 8, 2, 64, 2)[0] + 2 * 8 * 64 * 2 / 3.35e12
        * 1e3 + 4 / 3.35e12 * 1e3)
    # qwen3-8b's prefill: causal, 4 x 2,048, 32/8 heads of 128
    ms, by, flops = timing.attention_bound(4, 2048, 2048, 32, 8, 128, True,
                                           0, 2)
    assert flops == 4.0 * 4 * 32 * 128 * (2048 * 2049 // 2)
    assert by == "operations" and ms == pytest.approx(
        flops / timing.BF16_FLOPS * 1e3)
    # float32 inputs: the same flops at the float32 rate
    ms32, by32, flops32 = timing.attention_bound(4, 2048, 2048, 32, 8, 128,
                                                 True, 0, 4)
    assert flops32 == flops and by32 == "operations"
    assert ms32 == pytest.approx(flops / timing.F32_FLOPS * 1e3)


def test_tf32x3_issued_reading():
    """Float32 attention to float32's accuracy is three TF32 terms on each
    product: 12*D flops a visible pair at the dense TF32 rate, the least
    time the card needs, under the 4*D reading on the CUDA cores."""
    qwen3 = (4, 2048, 2048, 32, 8, 128, True, 0)
    ms, by, flops = timing.attention_f32_bound(*qwen3)
    assert flops == 12.0 * 4 * 32 * 128 * (2048 * 2049 // 2)
    assert flops == pytest.approx(412.5e9, rel=1e-3)
    assert by == "operations" and ms == pytest.approx(flops / 495e12 * 1e3)
    assert ms == pytest.approx(0.833, abs=5e-4)
    cuda_cores = timing.attention_bound(*qwen3, 4)[0]
    assert cuda_cores == pytest.approx(2.052, abs=5e-4) and ms < cuda_cores
    # hubert-xlarge in float32: bidirectional, 4 x 2,048, 16/16 heads of 80
    ms, by, flops = timing.attention_f32_bound(4, 2048, 2048, 16, 16, 80,
                                               False, 0)
    assert flops == 12.0 * 4 * 16 * 80 * 2048 * 2048
    assert by == "operations" and ms == pytest.approx(0.521, abs=5e-4)
