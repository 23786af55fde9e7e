"""The port's serving benchmarks of the paper's figures against the
reference's, on the CPU at the reference's quick sizes: Fig. 4's fleet
refresh (``run_refresh``), Fig. 5's rolling update, the fleet calibration
plane and the attack campaign.

Each reference ``run(quick=True)`` runs once a module, JAX on the CPU,
with its banked Pallas kernel in interpret mode (``pallas.load`` supplied
for this module only, as ``tests/test_torch_server.py`` does) and with the
two modules that write ``benchmarks/results/BENCH_*.json`` pointed at a
temporary directory, so no committed file changes.  The port runs the
plain versions (``device="cpu"``).  The results are compared key by key
over the reference's keys: discrete outputs (counts, pods, ready replicas,
generations, refreshed streams, refreshes, audit entries, the bound)
exactly, statistics within the tolerance stated beside each comparison,
timings not at all.
"""
import pytest

from repro_torch.benchmarks import (bench_attack_campaign,
                                    bench_fig4_quantile_update,
                                    bench_fig5_rollout, bench_fleet_refresh,
                                    paper)

# the timings of each result, which are not compared
REFRESH_TIMES = frozenset({"wall_ms", "refit_ms", "validate_ms", "publish_ms",
                           "us_per_tenant", "wall_ms_at_max",
                           "us_per_tenant_at_max"})
ROLLOUT_TIMES = frozenset({"latency_p50_ms", "latency_p99_ms",
                           "latency_max_ms", "warmup_seconds_per_replica"})
FLEET_TIMES = frozenset({"wall_ms", "merge_ms", "refit_ms", "validate_ms",
                         "publish_ms", "publish_ms_per_replica",
                         "wall_ms_at_max", "merge_ms_at_max",
                         "publish_ms_at_max", "refit_ratio_max_vs_min"})
ATTACK_TIMES = frozenset({"p50_ms", "p99_ms", "us_per_event",
                          "audit_us_per_event", "p99_ms_quiet",
                          "p99_ms_attack", "p99_ratio_attack_vs_quiet",
                          "us_per_event_attack"})


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference benchmark's quick result, computed once a module,
    with ``pallas.load`` supplied and ``RESULTS_PATH`` redirected."""
    import importlib
    import pathlib

    import jax
    from jax.experimental import pallas as pl

    out = tmp_path_factory.mktemp("reference_results")
    cache = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(pathlib.Path(__file__).resolve().parents[1]))
        if not hasattr(pl, "load"):
            mp.setattr(pl, "load", lambda ref, idx, **_: ref[idx],
                       raising=False)
        for name in ("bench_fleet_refresh", "bench_attack_campaign"):
            mod = importlib.import_module(f"benchmarks.{name}")
            mp.setattr(mod, "RESULTS_PATH", str(out / f"{name}.json"))

        def get(name, fn="run"):
            if (name, fn) not in cache:
                mod = importlib.import_module(f"benchmarks.{name}")
                cache[name, fn] = getattr(mod, fn)(quick=True)
            return cache[name, fn]

        yield get
    jax.clear_caches()


def _no_launches(result):
    assert result["device"] == "cpu" and result["nvidia_smi"] is None
    assert result["quick"] is True
    assert set(result["launches"].values()) == {0}


def test_fig4_fleet_refresh_matches_reference(reference):
    """Tenant counts, samples and the one published generation of each
    pass exactly; the run raises unless every stream refreshed.  Nothing
    else is a statistic."""
    want = reference("bench_fig4_quantile_update", "run_refresh")
    got = bench_fig4_quantile_update.run_refresh(quick=True, device="cpu")
    assert paper.differences(want, got, skip=REFRESH_TIMES) == []
    assert [r["tenants"] for r in got["rows"]] == [4, 16, 64]
    assert all(r["generation"] == 1 for r in got["rows"])
    _no_launches(got)


def test_fig5_rollout_matches_reference(reference):
    """The pod timeline exactly: samples, baseline, peak, final, the fewest
    ready replicas, the versions seen; the invariants of the reference's
    ``main`` hold."""
    want = reference("bench_fig5_rollout")
    got = bench_fig5_rollout.run(quick=True, device="cpu")
    assert paper.differences(want, got, skip=ROLLOUT_TIMES) == []
    assert got["invariants_ok"] is True
    assert got["min_ready"] >= got["pod_baseline"] == got["pod_final"] == 3
    assert got["versions_seen"] == ["v0", "v1"]
    _no_launches(got)


def test_fleet_refresh_matches_reference(reference):
    """Replicas, streams, events and fleet generations exactly.  The worst
    rank error is compared exactly too: the merged reservoirs are the same
    numpy draws and the published tables the same float32 rounding of the
    same float64 quantiles.  ``all_within_bound`` holds."""
    want = reference("bench_fleet_refresh")
    got = bench_fleet_refresh.run(quick=True, device="cpu")
    assert paper.differences(want, got, skip=FLEET_TIMES) == []
    assert got["all_within_bound"] is True
    assert [r["fleet_generation"] for r in got["rows"]] == [1, 1, 1]
    _no_launches(got)


def test_attack_campaign_matches_reference(reference):
    """Windows, audit entries, refreshes a regime and the ledger's
    generations exactly (the drift controller's PSI decisions see scores
    that agree with the reference's; a refresh is a discrete event, so any
    difference there would show).  Every audited decision replays bit for
    bit through the banked pipeline (the run raises otherwise), from a
    ledger that archived every generation served."""
    want = reference("bench_attack_campaign")
    got = bench_attack_campaign.run(quick=True, device="cpu")
    assert paper.differences(want, got, skip=ATTACK_TIMES) == []
    assert got["attack_refreshes"] == want["attack_refreshes"] > 0
    for regime in ("quiet", "attack"):
        r = got[regime]
        assert r["audit_replayed_bitwise"] == r["audit_entries"] \
            == 2 * (30 + 4) * 128
        assert r["audit_replay_launches"] == 0        # plain on the CPU
        assert set(r["ledger_generations"]) <= set(r["audit_generations"])
        assert r["audit_generations"][0] == 0
    _no_launches(got)
