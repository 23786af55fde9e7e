"""The port's kernel microbenchmark and its timing module, on the CPU.

``python -m repro_torch.benchmarks.bench_kernels --quick --device cpu``
runs in a subprocess and writes its five entries, each agreeing with its
plain version (on the CPU ``ops`` runs the plain versions, so this shows
the entry point works; it measures nothing of the card).  The least-time
bounds of ``benchmarks/timing.py`` are checked against the byte and
operation counts written out by hand.
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
    # tensor-core form it picks on the card
    assert set(result["launches"]) == set(ENTRIES.values()) | {
        "flash_attention_wgmma"}


def test_bounds_count_bytes_and_operations():
    hbm, f32, bf16 = (timing.HBM_BYTES_PER_S, timing.F32_FLOPS,
                      timing.BF16_FLOPS)
    m, k, n, t = 65_536, 8, 256, 64
    ms, by = timing.quantile_map_bound(m, n, 4)
    assert by == "operations" and ms == pytest.approx(m * (n + 10) / f32 * 1e3)
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

