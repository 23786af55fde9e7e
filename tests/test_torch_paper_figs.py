"""The port's benchmarks of the paper's Table 1, Fig. 4, Fig. 6 and
Appendix A against the reference's, on the CPU at the reference's quick
sizes.

Each reference ``run(quick=True)`` runs once a module (JAX on the CPU);
the port's ``run(quick=True, device="cpu")`` runs the plain versions.  The
two results are compared key by key over the reference's keys
(``repro_torch.benchmarks.paper.differences``): discrete outputs exactly,
statistics within the tolerance stated beside each comparison.  None of
these four has a timing among its keys.
"""
import numpy as np
import pytest
import torch

from repro_torch.benchmarks import (bench_appendix_a,
                                    bench_fig4_quantile_update,
                                    bench_fig6_model_update,
                                    bench_table1_calibration, paper)
from repro_torch.core.metrics import bin_relative_error
from repro_torch.core.transforms import QuantileMap


@pytest.fixture(scope="module")
def reference():
    """The reference benchmark module's quick result, computed once."""
    import importlib
    import pathlib

    cache = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(pathlib.Path(__file__).resolve().parents[1]))

        def get(name):
            if name not in cache:
                mod = importlib.import_module(f"benchmarks.{name}")
                cache[name] = mod.run(quick=True)
            return cache[name]

        yield get


def _no_launches(result):
    assert result["device"] == "cpu" and result["nvidia_smi"] is None
    assert result["quick"] is True
    assert set(result["launches"].values()) == {0}


def test_table1_matches_reference(reference):
    """T^C is the same float32 expression on bitwise-equal expert scores in
    both packages, and ECE and Brier are the same numpy code.  rtol 1e-6:
    should either backend contract T^C into a fused multiply-add, a
    corrected score moves by an ulp (6e-8 relative), and each statistic
    averages 80,000 of them."""
    want = reference("bench_table1_calibration")
    got = bench_table1_calibration.run(quick=True, device="cpu")
    assert paper.differences(want, got, rtol=1e-6) == []
    assert [r["dataset_predictor"] for r in got["rows"]] == [
        r["dataset_predictor"] for r in want["rows"]]
    assert got["ensemble_ece_change_pct"] < -80.0     # the paper's claim
    _no_launches(got)


def test_fig4_matches_reference(reference):
    """Every statistic of Fig. 4 counts scores in bins.  The samples, the
    aggregates and both T^Q tables are bitwise equal across the packages,
    and T^Q differs only at or past the last knot, where the port gives
    exactly qr[-1] and the reference one ulp from it (the last-knot rule),
    inside the last bin, which holds qr[-1].  So no score changes bin and
    the statistics are compared exactly."""
    want = reference("bench_fig4_quantile_update")
    got = bench_fig4_quantile_update.run(quick=True, device="cpu")
    assert paper.differences(want, got) == []
    _no_launches(got)
    # on the CPU ``ops.quantile_map`` IS the plain version
    assert set(got["tq_vs_plain"]) == {"v0", "v1"}
    for name, check in got["tq_vs_plain"].items():
        assert check["scores"] == (120_000 if name == "v0" else 60_000)
        assert check["max_abs_err"] == 0.0 and check["bin_changes"] == 0
        assert check["on_knot_equal"] is True


def test_fig6_matches_reference(reference):
    """Fig. 6's bin errors, recalls, alert rates and PSI all count scores
    against bin edges or thresholds; as for Fig. 4 no score changes side,
    so they are compared exactly.  The monotone-T^Q invariant (p1.5 and p2
    recall equal) holds in the port's run."""
    want = reference("bench_fig6_model_update")
    got = bench_fig6_model_update.run(quick=True, device="cpu")
    assert paper.differences(want, got) == []
    assert got["recall_p1.5"] == got["recall_p2"]
    _no_launches(got)
    assert set(got["tq_vs_plain"]) == {"p1", "p1.5", "p2"}
    # p1 maps the very sample its table was fitted on: its extremes (and
    # any exact sample a level lands on) sit on knots, bitwise equal
    assert got["tq_vs_plain"]["p1"]["on_knot_scores"] >= 2
    assert all(c["on_knot_equal"] and c["max_abs_err"] == 0.0
               for c in got["tq_vs_plain"].values())


def test_appendix_a_matches_reference(reference):
    """The same numpy draws from the same seed: exact."""
    want = reference("bench_appendix_a")
    got = bench_appendix_a.run(quick=True, device="cpu")
    assert paper.differences(want, got) == []
    assert len(got["rows"]) == 8      # every n is under the quick cut


def test_score_bins_are_the_histogram_bins():
    """``paper.score_bins`` counts as ``np.histogram`` over the Fig. 4/6
    edges does, the edges themselves and 1.0 included."""
    rng = np.random.default_rng(0)
    s = np.concatenate([rng.uniform(0, 1, 5000), paper.BIN_EDGES,
                        np.nextafter(paper.BIN_EDGES, 2.0)])
    s = s[(s >= 0) & (s <= 1)].astype(np.float32)
    counts, _ = np.histogram(s.astype(np.float64), bins=paper.BIN_EDGES)
    assert np.array_equal(np.bincount(paper.score_bins(s), minlength=10),
                          counts)
    assert list(paper.score_bins(np.array([-0.1, 1.1]))) == [-1, 10]


def test_apply_quantile_map_reports_knots_and_bins():
    """On the CPU the launch and the plain version are one function: no
    error, no bin change; scores placed on the knots are counted, and the
    mapped scores give ``bin_relative_error`` its counts."""
    n = 64
    src = torch.linspace(0, 1, n) ** 2
    qm = QuantileMap(src, torch.linspace(0, 1, n))
    scores = np.concatenate([np.random.default_rng(1).uniform(0, 1, 999),
                             src[:5].numpy()])
    out, check = paper.apply_quantile_map(qm, scores, torch.device("cpu"))
    assert out.dtype == np.float32 and out.shape == scores.shape
    assert check == {"scores": 1004, "max_abs_err": 0.0,
                     "on_knot_scores": check["on_knot_scores"],
                     "on_knot_equal": True, "bin_changes": 0,
                     "bin_changes_max_edge_gap": None}
    assert check["on_knot_scores"] >= 5
    res = bin_relative_error(out, np.linspace(0, 1, n), n_bins=10)
    assert res["counts"].sum() == 1004


@pytest.mark.parametrize("want, got, kw, n", [
    ({"a": 1.0, "b": [1, "x"]}, {"a": 1.0 + 1e-9, "b": [1, "x"], "c": 2},
     {"atol": 1e-8}, 0),
    ({"a": 1.0}, {"a": 1.1}, {"rtol": 0.05}, 1),
    ({"a": True}, {"a": 1}, {}, 1),
    ({"a": float("nan"), "b": None}, {"a": float("nan"), "b": None}, {}, 0),
    ({"a": [1, 2]}, {"a": [1]}, {}, 1),
    ({"a": 1, "t": 1.0}, {"t": 9.0}, {"skip": frozenset({"t"})}, 1),
])
def test_differences_walks_the_wanted_keys(want, got, kw, n):
    assert len(paper.differences(want, got, **kw)) == n
