"""The port's benchmark runner, ``python -m repro_torch.benchmarks.run``,
on the CPU at the quick sizes: a CSV row for each benchmark in the
reference runner's order, one JSON a benchmark in ``--out``, and nothing
written anywhere else (the repository's root and result files included).
"""
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
ROWS = ["table1_calibration", "fig4_quantile_update", "fig4_fleet_refresh",
        "fig6_model_update", "fig5_rollout", "appendix_a_samplesize",
        "serving_latency", "multitenant_batch", "sharded_bank",
        "tiered_bank", "fleet_refresh", "attack_campaign", "async_engine",
        "kernel_quantile_map_16k", "kernel_score_pipeline_16kx8",
        "kernel_score_pipeline_banked_16kx8", "kernel_flash_attention_256",
        "kernel_decode_attention_4096"]
FILES = {name for name in ROWS if not name.startswith("kernel_")} \
    | {"kernels"}


def _snapshot() -> dict:
    """Every file at the repository's root and under benchmarks/, with its
    modification time (bytecode caches aside: other test processes import
    the reference's benchmarks meanwhile)."""
    files = [*ROOT.glob("*"), *(ROOT / "benchmarks").rglob("*")]
    return {str(f): f.stat().st_mtime_ns for f in files
            if f.is_file() and "__pycache__" not in f.parts}


def test_runner_prints_every_row_and_writes_only_its_out_dir(tmp_path):
    out, cwd = tmp_path / "out", tmp_path / "cwd"
    cwd.mkdir()
    before = _snapshot()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.run", "--quick",
         "--device", "cpu", "--out", str(out)],
        capture_output=True, text=True, timeout=900, cwd=cwd,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0] == "name,us_per_call,derived"
    rows = [line.split(",", 2) for line in lines[1:]]
    assert [r[0] for r in rows] == ROWS
    assert all(float(r[1]) > 0 and r[2] for r in rows)
    derived = dict((r[0], r[2]) for r in rows)
    assert "all_within_bound=True" in derived["fleet_refresh"]
    assert "final_version=v1" in derived["fig5_rollout"]
    assert {f.stem for f in out.iterdir()} == FILES
    assert all(f.suffix == ".json" for f in out.iterdir())
    fig4 = json.loads((out / "fig4_quantile_update.json").read_text())
    assert fig4["device"] == "cpu" and fig4["quick"] is True
    kernels = json.loads((out / "kernels.json").read_text())
    assert len(kernels["entries"]) == 5
    assert list(cwd.iterdir()) == []
    assert _snapshot() == before
