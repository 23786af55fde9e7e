"""The port stands alone: no JAX, no reference package, no silent CPU.

* Every ``repro_torch`` module imports, and a CPU ``score_batch`` runs
  (with eager and with device tracking, through an estimator checkpoint),
  in a process where importing ``jax`` fails; afterwards no ``repro``
  module is loaded.
* Each module the port copies from the reference (routing, registry,
  quantiles, types, data, shadow, batching, warmup, metrics, drift,
  rollout, decision_loop, calibration, hotness, the async engine, the
  model config schema and the architecture registry) equals its source once ``repro.`` imports are
  rewritten to ``repro_torch.``, apart from the listed lines, so a copy
  that drifts fails here.
* No source of the port imports the reference's top-level ``benchmarks``
  package.
* No source of the port calls PyTorch's fused attention operator: the
  attention kernels are the port's own (the kernel microbenchmark lives in
  the package, so it is covered too).
* An entry point given no device on a machine without CUDA raises instead
  of running on the CPU.
"""
import os
import pathlib
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

# copied module -> the lines of the copy that may differ from the source
# (the quantiles copy drops change-history tags from two docstring lines)
COPIES = {
    "core/routing.py": (),
    "core/registry.py": (),
    "core/quantiles.py": (
        "exact checkpoint (reservoir + recent ring), merges per",
        "        The fleet calibration plane's wire format IS the exact",
    ),
    "serving/types.py": (),
    "training/data.py": (),
    "serving/shadow.py": (),
    "serving/batching.py": (),
    "serving/warmup.py": (),
    "core/metrics.py": (),
    "serving/drift.py": (),
    "serving/rollout.py": (),
    "serving/decision_loop.py": (),
    "core/hotness.py": (),
    # a docstring link names the port's rollout module
    "serving/engine.py": (
        "    (``score_batch``) so a :class:`~repro_torch.serving.rollout."
        "Replica` can serve",),
    # torch tensors for the candidate map; docstring links name the port
    "serving/calibration.py": (
        "     (:func:`repro_torch.core.quantiles.batch_sample_quantiles`): "
        "reservoirs are",
        "    (:class:`~repro_torch.serving.server.StaleGenerationError`), "
        "so a late ack",
        "accumulate in the :class:`~repro_torch.kernels.quantile_track."
        "DeviceQuantileTracker`",
        "import numpy as np",
        "import torch",
        "                    src_quantiles=torch.as_tensor(src, "
        "dtype=torch.float32),",
        "                    ref_quantiles=torch.as_tensor(ref, "
        "dtype=torch.float32))",
    ),
    "models/config.py": (),
    # the registry names the port's config modules
    "configs/__init__.py": tuple(
        f'    "{arch}": "repro_torch.configs.{mod}",' for arch, mod in (
            ("internlm2-1.8b", "internlm2_1_8b"),
            ("llama3-405b", "llama3_405b"),
            ("olmoe-1b-7b", "olmoe_1b_7b"),
            ("qwen2-vl-7b", "qwen2_vl_7b"),
            ("hubert-xlarge", "hubert_xlarge"),
            ("deepseek-coder-33b", "deepseek_coder_33b"),
            ("jamba-1.5-large-398b", "jamba_1_5_large_398b"),
            ("qwen3-8b", "qwen3_8b"),
            ("xlstm-1.3b", "xlstm_1_3b"),
            ("llama4-maverick-400b-a17b", "llama4_maverick_400b_a17b"))),
    **{f"configs/{name}.py": () for name in (
        "shapes", "deepseek_coder_33b", "hubert_xlarge", "internlm2_1_8b",
        "jamba_1_5_large_398b", "llama3_405b", "llama4_maverick_400b_a17b",
        "olmoe_1b_7b", "qwen2_vl_7b", "qwen3_8b", "xlstm_1_3b")},
}


def _rewrite(text: str) -> str:
    return re.sub(r"^(\s*)(from|import) repro\.", r"\1\2 repro_torch.",
                  text, flags=re.M)


@pytest.mark.parametrize("module", sorted(COPIES))
def test_copied_module_has_not_drifted(module):
    want = _rewrite((SRC / "repro" / module).read_text())
    got = (SRC / "repro_torch" / module).read_text()
    want_lines, got_lines = want.splitlines(), got.splitlines()
    assert len(got_lines) == len(want_lines)
    assert got.endswith("\n") == want.endswith("\n")
    changed = [g for w, g in zip(want_lines, got_lines) if w != g]
    assert changed == list(COPIES[module])


SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys
    sys.modules["jax"] = None          # any `import jax` now fails
    import numpy as np
    import torch
    import repro_torch

    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")]
    for name in names:
        importlib.import_module(name)
    import repro_torch.benchmarks.bench_kernels as bench
    assert callable(bench.run) and "repro_torch.benchmarks.bench_kernels" \
        in names
    assert {"repro_torch.kernels.quantile_track",
            "repro_torch.training.checkpoint",
            "repro_torch.core.metrics", "repro_torch.core.adaptation",
            "repro_torch.serving.drift", "repro_torch.serving.calibration",
            "repro_torch.serving.rollout",
            "repro_torch.serving.decision_loop",
            "repro_torch.serving.audit",
            "repro_torch.examples.model_update_lifecycle",
            "repro_torch.core.hotness", "repro_torch.serving.engine",
            "repro_torch.serving.tiering",
            "repro_torch.benchmarks.bench_async_engine",
            "repro_torch.benchmarks.bench_tiered_bank",
            "repro_torch.launch.mesh",
            "repro_torch.benchmarks.bench_sharded_bank",
            "repro_torch.benchmarks.bench_serving_latency",
            "repro_torch.benchmarks.bench_multitenant_batch",
            *(f"repro_torch.benchmarks.{m}" for m in (
                "paper", "bench_table1_calibration",
                "bench_fig4_quantile_update", "bench_fig6_model_update",
                "bench_fig5_rollout", "bench_appendix_a",
                "bench_fleet_refresh", "bench_attack_campaign", "run")),
            "repro_torch.examples.quickstart",
            "repro_torch.models.moe", "repro_torch.models.xlstm",
            "repro_torch.examples.serve_e2e",
            "repro_torch.training.optimizer", "repro_torch.training.train",
            "repro_torch.launch.train",
            "repro_torch.examples.train_fraud_scorer",
            *(f"repro_torch.launch.{m}" for m in (
                "specs", "roofline", "dryrun", "report"))} <= set(names)

    from repro_torch.core.predictor import PredictorSpec
    from repro_torch.core.routing import (Condition, Intent, RoutingTable,
                                          ScoringRule)
    from repro_torch.core.transforms import QuantileMap
    from repro_torch.serving.server import MuseServer
    from repro_torch.serving.types import ScoringRequest

    rng = np.random.default_rng(0)
    w = rng.normal(0, 1, (2, 8)).astype(np.float32)
    factories = {f"m{i}": (lambda i=i: lambda x: 1 / (1 + np.exp(-(x @ w[i]))))
                 for i in range(2)}
    rules = (ScoringRule(Condition(tenants=("a",)), "pa"),
             ScoringRule(Condition(), "pb"))
    server = MuseServer(RoutingTable(rules, version="v1"), device="cpu")
    for name, weights in (("pa", (1.0, 1.0)), ("pb", (2.0, 1.0))):
        server.deploy(PredictorSpec(name, ("m0", "m1"), (0.2, 0.5), weights,
                                    QuantileMap.identity(32)), factories)
    reqs = [ScoringRequest(Intent(tenant="ab"[i % 2]),
                           rng.normal(0, 1, 8).astype(np.float32))
            for i in range(16)]
    out = server.score_batch(reqs)
    assert [r.predictor for r in out] == ["pa", "pb"] * 8
    assert all(0.0 <= r.score <= 1.0 for r in out)
    assert server.metrics["kernel_dispatches"] == 1

    # fused device tracking and the estimator checkpoints, jax blocked
    import tempfile
    from repro_torch.serving.server import ServerConfig
    tracked = MuseServer(RoutingTable(rules, version="v1"),
                         ServerConfig(track_device=True), device="cpu")
    for name, weights in (("pa", (1.0, 1.0)), ("pb", (2.0, 1.0))):
        tracked.deploy(PredictorSpec(name, ("m0", "m1"), (0.2, 0.5), weights,
                                     QuantileMap.identity(32)), factories)
    assert [r.score for r in tracked.score_batch(reqs)] == \
        [r.score for r in out]
    assert tracked._tracker.pending_total() == 16
    with tempfile.TemporaryDirectory() as tmp:
        tracked.save_estimators(tmp, step=3)
        assert server.restore_estimators(tmp) == 2
    assert tracked._tracker.pending_total() == 0
    assert {k: e.count for k, e in server.estimator_streams().items()} == \
        {("a", "pa"): 8, ("b", "pb"): 8}

    # the model-update lifecycle, jax blocked: a fleet refresh, a decision
    # audited and replayed through the banked pipeline
    from repro_torch.serving import (AuditLog, DecisionLoop, DecisionPolicy,
                                     FleetCalibrationController,
                                     GenerationLedger, RefreshPolicy,
                                     Replica, ReplicaSet)
    rs = ReplicaSet([Replica(0, server, "v1", ready=True)])
    fleet = FleetCalibrationController(rs, np.linspace(0, 1, 32),
                                       RefreshPolicy(alert_rate=0.3,
                                                     rel_error=0.9))
    assert fleet.refresh_fleet().fleet_generation >= 0
    log, ledger = AuditLog(), GenerationLedger(device="cpu")
    ledger.record_replicas(rs)
    loop = DecisionLoop(DecisionPolicy(), np.linspace(0, 1, 32), audit=log)
    loop.process(reqs, rs.dispatch(reqs, stream="c"))
    check = log.verify(ledger)
    assert check.ok and check.replayed == 16, check.failures

    # the async engine over a tiered server, jax blocked
    from repro_torch.serving import AsyncDispatchEngine, TieringConfig
    tiered = MuseServer(RoutingTable(rules, version="v1"),
                        ServerConfig(tiering=TieringConfig(
                            hot_capacity=1, victim_capacity=1)),
                        device="cpu")
    for name, weights in (("pa", (1.0, 1.0)), ("pb", (2.0, 1.0))):
        tiered.deploy(PredictorSpec(name, ("m0", "m1"), (0.2, 0.5), weights,
                                    QuantileMap.identity(32)), factories)
    engine = AsyncDispatchEngine(tiered, max_batch=8, max_wait_ms=1e9)
    assert [r.score for r in engine.score_batch(reqs)] == \
        [r.score for r in out]
    engine.close()
    assert tiered.tier_metrics()["events"] == 16

    # the sharded server and tiering over it, jax blocked
    for config in (ServerConfig(tenant_shards=2),
                   ServerConfig(tenant_shards=2, tiering=TieringConfig(
                       hot_capacity=1, victim_capacity=1))):
        sharded = MuseServer(RoutingTable(rules, version="v1"), config,
                             device="cpu")
        for name, weights in (("pa", (1.0, 1.0)), ("pb", (2.0, 1.0))):
            sharded.deploy(PredictorSpec(name, ("m0", "m1"), (0.2, 0.5),
                                         weights, QuantileMap.identity(32)),
                           factories)
        assert [r.score for r in sharded.score_batch(reqs)] == \
            [r.score for r in out]
        assert sharded.metrics["shard_dispatches"] == 1

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import Model
    model = Model(get_smoke_config("qwen3-8b"), device="cpu", seed=1)
    lm = model(torch.zeros((2, 8), dtype=torch.long))
    assert lm.logits.shape == (2, 8, 512) and lm.risk_score.shape == (2,)
    assert callable(serve.main)
    loaded = [m for m in sys.modules if m in ("repro", "benchmarks")
              or m.startswith(("repro.", "benchmarks."))]
    assert not loaded, loaded
    assert sys.modules["jax"] is None
    print("MODULES", len(names))
""")


def test_port_runs_with_jax_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(SRC)}, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split("MODULES")[1]) >= 20


def _port_python_files() -> list[pathlib.Path]:
    return [*(SRC / "repro_torch").rglob("*.py"), ROOT / "chip_smoke.py"]


def test_sources_import_neither_jax_nor_the_reference():
    pattern = re.compile(r"^\s*(import jax|from jax|import repro\b|"
                         r"from repro[ .])", re.M)
    offenders = [str(f) for f in _port_python_files()
                 if pattern.search(f.read_text())]
    assert not offenders


def test_sources_do_not_import_the_reference_benchmarks():
    pattern = re.compile(r"^\s*(import|from) benchmarks\b", re.M)
    offenders = [str(f) for f in _port_python_files()
                 if pattern.search(f.read_text())]
    assert not offenders


def test_no_source_calls_fused_attention():
    files = [f for f in (SRC / "repro_torch").rglob("*")
             if f.is_file() and f.suffix in (".py", ".cu", ".cuh", ".h")]
    offenders = [str(f) for f in files
                 if "scaled_dot_product_attention" in f.read_text()]
    assert len(files) >= 40 and not offenders
    names = {f.relative_to(SRC / "repro_torch").as_posix() for f in files}
    assert {"benchmarks/bench_kernels.py", "benchmarks/timing.py",
            "csrc/decode_attention.cu", "kernels/quantile_track.py",
            "training/checkpoint.py"} <= names


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable here")
    from repro_torch.core.routing import RoutingTable
    from repro_torch.experiments.fraud_world import Expert
    from repro_torch.serving.server import MuseServer

    with pytest.raises(RuntimeError, match="device='cpu'"):
        MuseServer(RoutingTable(()))
    expert = Expert("m", 0.5, torch.zeros(4).numpy(), 0.0,
                    torch.ones(4).numpy())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        expert.score_fn()
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import Model

    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(get_smoke_config("qwen3-8b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "qwen3-8b", "--smoke"])
    from repro_torch.benchmarks import bench_kernels

    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_kernels.run(quick=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_kernels.main(["--quick"])
    from repro_torch.kernels.quantile_track import DeviceQuantileTracker

    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceQuantileTracker(lambda key, chunks: None)
    # the model-update lifecycle: the audit ledger, the label fits and the
    # example take the card by default; the calibration controllers take no
    # device of their own, they publish through a server, which does
    from repro_torch.core import adaptation
    from repro_torch.examples import model_update_lifecycle
    from repro_torch.serving.audit import GenerationLedger

    with pytest.raises(RuntimeError, match="device='cpu'"):
        GenerationLedger()
    scores, labels = np.full((4, 2), 0.5), np.zeros(4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        adaptation.fit_aggregation_weights(scores, labels)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        adaptation.generalized_correction_betas(scores, labels)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model_update_lifecycle.main([])
    # the tiered store and the two serving benchmarks
    from repro_torch.benchmarks import bench_async_engine, bench_tiered_bank
    from repro_torch.serving.tiering import HostBankStore, TieredBankStore

    host = HostBankStore(np.ones((2, 1)), np.ones((2, 1)),
                         np.zeros((2, 2)), np.ones((2, 2)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TieredBankStore(host)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_async_engine.run(quick=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_tiered_bank.main(["--quick"])
    # the tenant mesh, the composed store and the three benchmarks of the
    # sharded and main paths
    from repro_torch.benchmarks import (bench_multitenant_batch,
                                        bench_serving_latency,
                                        bench_sharded_bank)
    from repro_torch.launch.mesh import make_tenant_mesh
    from repro_torch.serving.tiering import ShardedTieredBankStore

    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_tenant_mesh(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShardedTieredBankStore(host, 2)
    for bench in (bench_sharded_bank, bench_serving_latency,
                  bench_multitenant_batch):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bench.run(quick=True)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bench.main(["--quick"])
    # the paper's tables and figures, the runner and the quickstart
    from repro_torch.benchmarks import (bench_appendix_a,
                                        bench_attack_campaign,
                                        bench_fig4_quantile_update,
                                        bench_fig5_rollout,
                                        bench_fig6_model_update,
                                        bench_fleet_refresh,
                                        bench_table1_calibration)
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.examples import quickstart

    for bench in (bench_table1_calibration, bench_fig4_quantile_update,
                  bench_fig6_model_update, bench_fig5_rollout,
                  bench_appendix_a, bench_fleet_refresh,
                  bench_attack_campaign):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bench.run(quick=True)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bench.main(["--quick"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_fig4_quantile_update.run_refresh(quick=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_run.main(["--quick"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.main([])
    # the end-to-end serving driver over transformer experts (MoE included)
    from repro_torch.examples import serve_e2e

    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_e2e.main([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "olmoe-1b-7b", "--smoke"])
    # training: the launcher and the example
    from repro_torch.examples import train_fraud_scorer
    from repro_torch.launch import train

    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--smoke"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_fraud_scorer.main([])


def test_kernels_layer_loads_no_model_code():
    """The data plane's kernels know nothing of the model zoo: importing
    ``kernels.ops`` loads no ``repro_torch.models`` module."""
    code = ("import sys, repro_torch.kernels.ops; "
            "print(sorted(m for m in sys.modules "
            "if m.startswith('repro_torch.models')))")
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(SRC)}, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
