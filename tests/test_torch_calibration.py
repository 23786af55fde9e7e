"""The calibration plane of the port, alone and against the JAX package.

* ``core/adaptation.py``: ``torch.autograd`` fits agree with the
  reference's ``jax.grad`` fits within 1e-5 on the same inputs (the largest
  difference on these cases was 2.4e-7 on the CPU).
* ``CalibrationController``: a JAX server (``fused_kernel=False``, so no
  Pallas kernel runs) and a port server restored from the same estimator
  checkpoint give equal reports (status, reasons, PSI, realized rates),
  bitwise equal refit tables and the same generations; scores after the
  publish agree within 2e-5.
* The control-plane invariants of the reference's
  ``tests/test_calibration_refresh.py``, on the port: the Eq.-5 gate, the
  no-op publish, a degenerate stream rejected while the others ship, the
  peer veto, recent-shift coverage, the ``only`` filter widened to the
  predictor, the decommission purge, a generation bump with immutable
  banks, an in-flight dispatch on the old generation, refit properties,
  and the fused path equal to the plain banked path across a swap.
* ``DriftMonitor`` / ``CalibrationRefreshController.tick`` on the same
  streams raise the same alarms and publish the same generations as the
  reference's.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import adaptation as jadapt
from repro.core import routing as jrouting
from repro.core.quantiles import StreamingQuantileEstimator as JEstimator
from repro.core.transforms import QuantileMap as JQuantileMap
from repro.serving import calibration as jcal
from repro.serving import drift as jdrift
from repro.serving import server as jserver
from repro.serving import types as jtypes
from repro_torch.core import adaptation
from repro_torch.core import routing as trouting
from repro_torch.core.predictor import PredictorSpec
from repro_torch.core.quantiles import (
    StreamingQuantileEstimator,
    batch_sample_quantiles,
    required_sample_size,
)
from repro_torch.core.transforms import QuantileMap, score_pipeline
from repro_torch.serving import drift, types as ttypes
from repro_torch.serving.calibration import (CalibrationController,
                                             RefreshPolicy)
from repro_torch.serving.drift import (CalibrationRefreshController,
                                       realized_alert_rate)
from repro_torch.serving.server import MuseServer, ServerConfig

DIM = 8
TOL = dict(rtol=2e-5, atol=2e-5)
REF = np.linspace(0.0, 1.0, 64) ** 2
GATE = required_sample_size(0.05, 0.5)
# |port - reference| bound on the fitted weights and betas
ADAPT_TOL = 1e-5


# ------------------------------------------------------------ adaptation
def _labelled(seed: int, n: int = 3000, k: int = 3):
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < 0.1).astype(np.float32)
    raw = np.clip(rng.beta(2, 8, (n, k)) + 0.3 * y[:, None]
                  * rng.uniform(0.5, 1.5, k), 1e-4, 1 - 1e-4)
    return raw.astype(np.float32), y


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_aggregation_weights_matches_the_reference(seed):
    raw, y = _labelled(seed)
    got = adaptation.fit_aggregation_weights(raw, y, device="cpu")
    want = jadapt.fit_aggregation_weights(raw, y)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.max(np.abs(got - np.asarray(want))) <= ADAPT_TOL
    assert got.sum() == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize("seed,nominal", [(0, None), (1, (0.2, 0.5, 0.9)),
                                          (2, (0.05, 0.1, 1.0))])
def test_generalized_correction_betas_matches_the_reference(seed, nominal):
    raw, y = _labelled(seed)
    nom = None if nominal is None else np.asarray(nominal)
    got = adaptation.generalized_correction_betas(raw, y, nominal_betas=nom,
                                                  device="cpu")
    want = jadapt.generalized_correction_betas(raw, y, nominal_betas=nom)
    assert np.max(np.abs(got - np.asarray(want))) <= ADAPT_TOL
    assert ((got >= 1e-4) & (got <= 1.0)).all()


def test_adaptation_short_runs_match_step_for_step():
    raw, y = _labelled(4, n=500)
    for steps in (1, 2, 7):
        np.testing.assert_allclose(
            adaptation.fit_aggregation_weights(raw, y, steps=steps,
                                               device="cpu"),
            jadapt.fit_aggregation_weights(raw, y, steps=steps),
            rtol=0, atol=1e-6)


# --------------------------------------------------------------- fixtures
def _linear_model(seed: int, dim: int = DIM):
    w = np.random.default_rng(seed).normal(0, 1, dim).astype(np.float32)

    def score(x):
        return 1.0 / (1.0 + np.exp(-(np.asarray(x, np.float32) @ w)))

    return score


FACTORIES = {f"m{i}": (lambda i=i: _linear_model(i)) for i in (1, 2, 3)}


def _rules(mod, n_tenants, shadow=False):
    rules = tuple(mod.ScoringRule(mod.Condition(tenants=(f"t{i}",)), f"p{i}")
                  for i in range(n_tenants)) + \
        (mod.ScoringRule(mod.Condition(), "p0"),)
    shadows = (mod.ShadowRule(mod.Condition(tenants=("t0",)), ("p-sh",)),) \
        if shadow else ()
    return mod.RoutingTable(rules, shadows, version="v1")


def _fleet(n_tenants=3, *, shadow=False, fused=True) -> MuseServer:
    """The reference's control-plane fixture on the port: one predictor per
    tenant over a shared {m1,m2} group, identity maps, on the CPU."""
    server = MuseServer(
        _rules(trouting, n_tenants, shadow),
        ServerConfig(refresh_alert_rate=0.05, refresh_rel_error=0.5,
                     fused_kernel=fused), device="cpu")
    for i in range(n_tenants):
        server.deploy(PredictorSpec(f"p{i}", ("m1", "m2"), (0.2, 0.4),
                                    (1.0, 1.0), QuantileMap.identity(64)),
                      FACTORIES)
    if shadow:
        server.deploy(PredictorSpec("p-sh", ("m1", "m2"), (0.5, 0.9),
                                    (2.0, 1.0), QuantileMap.identity(64)),
                      FACTORIES)
    return server


def _jfleet(n_tenants=3) -> jserver.MuseServer:
    from repro.core.predictor import PredictorSpec as JSpec
    server = jserver.MuseServer(
        _rules(jrouting, n_tenants),
        jserver.ServerConfig(refresh_alert_rate=0.05, refresh_rel_error=0.5,
                             fused_kernel=False))
    for i in range(n_tenants):
        server.deploy(JSpec(f"p{i}", ("m1", "m2"), (0.2, 0.4), (1.0, 1.0),
                            JQuantileMap.identity(64)), FACTORIES)
    return server


def _policy(**kw) -> RefreshPolicy:
    return RefreshPolicy(**{**dict(alert_rate=0.05, rel_error=0.5,
                                   n_levels=64), **kw})


def _inject(server, tenant, pred, samples, seed=0, estimator=None, **kw):
    est = (estimator or StreamingQuantileEstimator)(
        capacity=kw.pop("capacity", 65536), seed=seed, **kw)
    est.update(samples)
    server._estimators[(tenant, pred)] = est
    return est


def _req(tenant, seed, mod=ttypes, routing=trouting):
    rng = np.random.default_rng(seed)
    return mod.ScoringRequest(intent=routing.Intent(tenant=tenant),
                              features=rng.normal(0, 1, DIM).astype(
                                  np.float32))


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


# ------------------------------------- controller against the reference
def _streams(rng):
    """Per-stream samples that exercise every verdict: two healthy streams,
    a degenerate one, a thin one and a peer whose recent ring shifted."""
    return {
        ("t0", "p0"): (rng.beta(2, 5, GATE + 300), {}),
        ("t1", "p1"): (rng.beta(3, 4, GATE + 500), {}),
        ("t2", "p2"): (np.full(GATE + 50, 0.37), {}),
        ("t9", "p1"): (np.concatenate([rng.beta(3, 4, 8000),
                                       rng.uniform(0.9, 1.0, 600)]),
                       dict(capacity=512, recent_capacity=512)),
        ("t8", "p0"): (0.1 + 0.4 * rng.beta(2, 5, GATE // 3), {}),
    }


def _restored_pair(tmp_path, seed):
    """A JAX server and a port server restored from ONE checkpoint file."""
    rng = np.random.default_rng(seed)
    src = _fleet(3)
    for i, (key, (data, kw)) in enumerate(_streams(rng).items()):
        _inject(src, *key, data, seed=i, **kw)
    src.save_estimators(str(tmp_path), step=1)
    js, ts = _jfleet(3), _fleet(3)
    assert js.restore_estimators(str(tmp_path)) == \
        ts.restore_estimators(str(tmp_path)) == 5
    return js, ts


@pytest.mark.parametrize("seed", [0, 1])
def test_controller_matches_the_reference_from_one_checkpoint(tmp_path,
                                                              seed):
    js, ts = _restored_pair(tmp_path, seed)
    kw = dict(alert_rate=0.05, rel_error=0.5, n_levels=64)
    jres = jcal.CalibrationController(js, REF, jcal.RefreshPolicy(**kw)) \
        .refresh_fleet()
    tres = CalibrationController(ts, REF, RefreshPolicy(**kw)) \
        .refresh_fleet()
    key = lambda r: (r.tenant, r.predictor)
    got = sorted(tres.reports, key=key)
    want = sorted(jres.reports, key=key)
    assert [(r.tenant, r.predictor, r.samples, r.status, r.reasons)
            for r in got] == \
        [(r.tenant, r.predictor, r.samples, r.status, r.reasons)
         for r in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.psi, w.psi)
        np.testing.assert_array_equal(g.realized_alert_rate,
                                      w.realized_alert_rate)
    assert {r.status for r in got} >= {"refreshed", "rejected", "not_ready"}
    assert tres.generation == jres.generation == ts.bank_generation == \
        js.bank_generation == 1
    for name in ts.predictors:
        tp, jp = ts.predictors[name].pipeline, js.predictors[name].pipeline
        assert np.array_equal(_bits(tp.src_quantiles), _bits(jp.src_quantiles))
        assert np.array_equal(_bits(tp.ref_quantiles), _bits(jp.ref_quantiles))
    # scoring after the publish: within the reference's f32 tolerance
    reqs = [_req(f"t{i % 3}", 50 + i) for i in range(24)]
    jreqs = [_req(f"t{i % 3}", 50 + i, jtypes, jrouting) for i in range(24)]
    got_s = [r.score for r in ts.score_batch(reqs)]
    want_s = [r.score for r in js.score_batch(jreqs)]
    np.testing.assert_allclose(got_s, want_s, **TOL)


def test_recent_fit_window_matches_the_reference(tmp_path):
    js, ts = _restored_pair(tmp_path, 2)
    kw = dict(alert_rate=0.05, rel_error=0.5, n_levels=32,
              fit_window="recent")
    jres = jcal.CalibrationController(js, REF, jcal.RefreshPolicy(**kw)) \
        .refresh_fleet(only={("t1", "p1")})
    tres = CalibrationController(ts, REF, RefreshPolicy(**kw)) \
        .refresh_fleet(only={("t1", "p1")})
    assert [(r.tenant, r.status, r.reasons) for r in tres.reports] == \
        [(r.tenant, r.status, r.reasons) for r in jres.reports]
    assert tres.generation == jres.generation


# --------------------------------------------------- control-plane (port)
class TestRefreshControlPlane:
    def test_eq5_gate_blocks_thin_streams(self):
        server = _fleet(2)
        rng = np.random.default_rng(0)
        _inject(server, "t0", "p0", rng.uniform(0, 1, GATE + 10))
        _inject(server, "t1", "p1", rng.uniform(0, 1, GATE // 4))
        res = CalibrationController(server, REF, _policy()).refresh_fleet()
        assert [(r.tenant, r.predictor) for r in res.refreshed] == \
            [("t0", "p0")]
        assert [(r.tenant, r.predictor) for r in res.not_ready] == \
            [("t1", "p1")]
        assert res.not_ready[0].reasons == ("eq5_gate",)
        assert server.bank_generation == res.generation == 1

    def test_no_ready_streams_is_a_noop_publish(self):
        server = _fleet(1)
        res = CalibrationController(server, REF, _policy()).refresh_fleet()
        assert res.reports == ()
        assert res.generation == server.bank_generation == 0

    def test_degenerate_stream_rejected_others_ship(self):
        server = _fleet(2)
        rng = np.random.default_rng(1)
        _inject(server, "t0", "p0", rng.uniform(0, 1, GATE + 50))
        _inject(server, "t1", "p1", np.full(GATE + 50, 0.37))
        old = server.predictors["p1"].pipeline.src_quantiles
        res = CalibrationController(server, REF, _policy()).refresh_fleet()
        assert [(r.tenant, r.predictor) for r in res.refreshed] == \
            [("t0", "p0")]
        (rej,) = res.rejected
        assert (rej.tenant, rej.predictor) == ("t1", "p1")
        assert "degenerate_support" in rej.reasons
        assert server.predictors["p1"].pipeline.src_quantiles is old
        assert server.bank_generation == 1

    def test_poisoned_peer_vetoes_and_healthy_peer_is_reported(self):
        server = _fleet(1)      # p0 serves t0 and (catch-all) t9
        rng = np.random.default_rng(12)
        _inject(server, "t0", "p0", rng.uniform(0, 0.5, GATE + 50))
        est = StreamingQuantileEstimator(capacity=256, seed=4,
                                         recent_capacity=2048)
        est.update(rng.uniform(0.0, 0.5, 500_000))
        est.update(rng.uniform(0.8, 0.95, 2048))
        server._estimators[("t9", "p0")] = est
        old = server.predictors["p0"].pipeline.src_quantiles
        res = CalibrationController(server, REF, _policy()).refresh_fleet()
        assert res.refreshed == []
        by_tenant = {r.tenant: r for r in res.reports}
        assert by_tenant["t0"].reasons == ("vetoed_by_peer",)
        assert "support_coverage_recent" in by_tenant["t9"].reasons
        assert server.predictors["p0"].pipeline.src_quantiles is old
        assert server.bank_generation == 0

    def test_recent_shift_fails_support_coverage(self):
        server = _fleet(2)
        rng = np.random.default_rng(8)
        _inject(server, "t0", "p0", rng.uniform(0, 1, GATE + 50))
        est = StreamingQuantileEstimator(capacity=256, seed=3,
                                         recent_capacity=2048)
        est.update(rng.uniform(0.0, 0.4, 500_000))
        est.update(rng.uniform(0.7, 0.9, 2048))
        server._estimators[("t1", "p1")] = est
        res = CalibrationController(server, REF, _policy()).refresh_fleet()
        (rej,) = [r for r in res.rejected if r.tenant == "t1"]
        assert "support_coverage_recent" in rej.reasons
        assert [(r.tenant, r.predictor) for r in res.refreshed] == \
            [("t0", "p0")]

    def test_only_filter_is_widened_to_the_predictor(self):
        server = _fleet(1)      # p0 serves t0 and catch-all t9
        rng = np.random.default_rng(11)
        _inject(server, "t0", "p0", rng.uniform(0, 1, GATE + 50))
        _inject(server, "t9", "p0", np.full(GATE + 50, 0.42), seed=1)
        res = CalibrationController(server, REF, _policy()).refresh_fleet(
            only={("t0", "p0")})
        assert res.refreshed == []
        assert {r.tenant for r in res.reports} == {"t0", "t9"}
        assert server.bank_generation == 0
        # and another predictor's streams are not even reported
        server = _fleet(2)
        for i in range(2):
            _inject(server, f"t{i}", f"p{i}", rng.uniform(0, 1, GATE + 50),
                    seed=i)
        res = CalibrationController(server, REF, _policy()).refresh_fleet(
            only={("t1", "p1")})
        assert [(r.tenant, r.predictor) for r in res.reports] == \
            [("t1", "p1")]

    def test_decommission_purges_estimator_streams(self):
        server = _fleet(2)
        _inject(server, "t0", "p0",
                np.random.default_rng(10).uniform(0, 1, GATE + 50))
        server.decommission("p0")
        assert ("t0", "p0") not in server.estimator_streams()
        server.deploy(PredictorSpec("p0", ("m1", "m2"), (0.2, 0.4),
                                    (1.0, 1.0), QuantileMap.identity(64)),
                      FACTORIES)
        assert server.estimator_streams() == {}
        res = CalibrationController(server, REF, _policy()).refresh_fleet()
        assert res.reports == ()

    def test_generation_bumps_and_banks_are_immutable(self):
        server = _fleet(3)
        server.score_batch([_req(f"t{i}", i) for i in range(3)])
        (key,) = server._banks
        old_entry = server._banks[key]
        old_src = old_entry.bank.src_quantiles.clone()
        rng = np.random.default_rng(5)
        for i in range(3):
            _inject(server, f"t{i}", f"p{i}", rng.uniform(0, 1, GATE + 50),
                    seed=i)
        res = CalibrationController(server, REF, _policy()).refresh_fleet()
        new_entry = server._banks[key]
        assert new_entry is not old_entry
        assert new_entry.bank.generation == res.generation == 1
        assert old_entry.bank.generation == 0
        assert torch.equal(old_entry.bank.src_quantiles, old_src)
        assert not torch.allclose(new_entry.bank.src_quantiles, old_src)

    def test_in_flight_dispatch_scores_on_old_generation(self):
        server = _fleet(2)
        reqs = [_req("t0", 11), _req("t1", 12)]
        pre = [r.score for r in server.score_batch(reqs)]
        (key,) = server._banks
        captured = server._banks[key].bank
        rng = np.random.default_rng(6)
        for i in range(2):
            _inject(server, f"t{i}", f"p{i}", rng.uniform(0, 1, GATE + 50),
                    seed=i)
        CalibrationController(server, REF, _policy()).refresh_fleet()
        post = [r.score for r in server.score_batch(reqs)]
        assert pre != pytest.approx(post, abs=1e-9)
        raws = np.asarray([reqs[0].features, reqs[1].features], np.float32)
        raw_scores = server.predictors["p0"].raw_scores(raws)
        replay = captured(raw_scores, torch.tensor([0, 1]))
        assert replay.tolist() == pre              # the same bits

    def test_publish_after_refresh_serves_new_params(self):
        server = _fleet(2, shadow=True)
        rng = np.random.default_rng(7)
        server.score_batch([_req("t0", 31), _req("t1", 32)])
        for i in range(2):
            _inject(server, f"t{i}", f"p{i}", rng.uniform(0, 1, GATE + 50),
                    seed=i)
        CalibrationController(server, REF, _policy()).refresh_fleet()
        resps = server.score_batch([_req("t0", 31), _req("t1", 32)])
        for resp, name in zip(resps, ["p0", "p1"]):
            pipe = server.predictors[name].pipeline
            want = float(score_pipeline(
                torch.tensor(resp.raw_scores, dtype=torch.float32),
                pipe.betas, pipe.weights, pipe.src_quantiles,
                pipe.ref_quantiles))
            assert resp.score == pytest.approx(want, abs=1e-5)

    def test_refresh_aligns_live_streams_to_reference(self):
        server = _fleet(3)
        rng = np.random.default_rng(4)
        reqs = [_req(f"t{i % 3}", 1000 + i) for i in range(512)]
        for i in range(0, 512, 128):
            server.score_batch(reqs[i:i + 128])
        for est in server.estimator_streams().values():
            est.update(rng.choice(est.values(), 2000))
        res = CalibrationController(server, REF,
                                    _policy(alert_rate=0.05)).refresh_fleet()
        assert len(res.refreshed) == 3
        scores = [r.score for r in server.score_batch(reqs)]
        assert realized_alert_rate(np.asarray(scores), REF, 0.05) == \
            pytest.approx(0.05, abs=0.02)


class TestRefreshedMaps:
    @settings(max_examples=8)
    @given(st.integers(0, 10_000), st.floats(0.4, 3.0), st.floats(2.0, 9.0))
    def test_refit_is_monotone_non_decreasing(self, seed, a, b):
        rng = np.random.default_rng(seed)
        src = batch_sample_quantiles([rng.beta(a, b, 2000)],
                                     np.linspace(0, 1, len(REF)))[0]
        assert (np.diff(src) >= -1e-12).all()
        qm = QuantileMap(torch.as_tensor(src, dtype=torch.float32),
                         torch.as_tensor(REF, dtype=torch.float32))
        y = qm(torch.linspace(0, 1, 257)).numpy()
        assert (np.diff(y) >= -1e-6).all()

    @settings(max_examples=6)
    @given(st.integers(0, 10_000), st.sampled_from([1.0, 2.0]))
    def test_refit_on_reference_traffic_is_identity(self, seed, gamma):
        rng = np.random.default_rng(seed)
        levels = np.linspace(0, 1, 129)
        ref = levels ** gamma
        samples = np.interp(rng.uniform(0, 1, 6000), levels, ref)
        src = batch_sample_quantiles([samples], levels)[0]
        qm = QuantileMap(torch.as_tensor(src, dtype=torch.float32),
                         torch.as_tensor(ref, dtype=torch.float32))
        x = np.interp(np.linspace(0.05, 0.95, 61), levels, ref)
        y = qm(torch.as_tensor(x, dtype=torch.float32)).numpy()
        np.testing.assert_allclose(y, x, atol=0.06)

    @settings(max_examples=4)
    @given(st.integers(0, 10_000))
    def test_fused_path_equals_plain_banked_path_across_a_swap(self, seed):
        fused, plain = _fleet(3, fused=True), _fleet(3, fused=False)
        rng = np.random.default_rng(seed)
        reqs = [_req(f"t{i % 3}", int(rng.integers(1 << 30)))
                for i in range(12)]
        assert [r.score for r in fused.score_batch(reqs)] == \
            [r.score for r in plain.score_batch(reqs)]
        qs = torch.linspace(0, 1, 64)
        updates = {"p0": QuantileMap(qs, qs ** 3),
                   "p2": QuantileMap(qs, torch.sqrt(qs))}
        assert fused.publish_quantile_maps(updates) == 1
        assert plain.publish_quantile_maps(updates) == 1
        assert [r.score for r in fused.score_batch(reqs)] == \
            [r.score for r in plain.score_batch(reqs)]


# ---------------------------------------------- drift loop vs reference
def test_drift_monitor_matches_the_reference():
    rng = np.random.default_rng(3)
    mon = drift.DriftMonitor(REF, window=500)
    jmon = jdrift.DriftMonitor(REF, window=500)
    for n in (50, 150, 400, 700):
        chunk = rng.beta(2, 3, n)
        mon.update(chunk)
        jmon.update(chunk)
        assert mon.current_psi() == jmon.current_psi()
        assert mon.drifted() == jmon.drifted()
        assert mon.count == jmon.count


@pytest.mark.parametrize("poisoned", [False, True])
def test_refresh_tick_matches_the_reference(poisoned):
    """Same estimator state, same served streams: the same alarms, the
    same refreshes and rejections, the same published generations."""
    servers, controllers = [], []
    for mod, fleet, est_cls in ((drift, _fleet, StreamingQuantileEstimator),
                                (jdrift, _jfleet, JEstimator)):
        server = fleet(1)          # p0 serves t0 and catch-all t9
        rng = np.random.default_rng(13)
        t0 = np.full(GATE + 50, 0.5) if poisoned \
            else rng.uniform(0, 1, GATE + 50)
        _inject(server, "t0", "p0", t0, estimator=est_cls)
        _inject(server, "t9", "p0", rng.uniform(0, 1, GATE + 50), seed=1,
                estimator=est_cls)
        ctl = mod.CalibrationRefreshController(server, REF, window=2000,
                                               reject_cooldown=2)
        ctl.observe("t0", "p0", np.full(2000, 0.97))
        levels = np.linspace(0, 1, len(REF))
        ctl.observe("t9", "p0", np.interp(rng.uniform(0, 1, 2000), levels,
                                          REF))
        servers.append(server)
        controllers.append(ctl)
    (ts, js), (tc, jc) = servers, controllers
    for _ in range(3):
        assert tc.tick() == jc.tick()
        assert ts.bank_generation == js.bank_generation
    assert tc.refreshes == jc.refreshes
    assert tc.rejections == jc.rejections
    assert (ts.bank_generation == 0) == poisoned
    if not poisoned:
        assert {(t, p) for t, p, _ in tc.refreshes} == \
            {("t0", "p0"), ("t9", "p0")}
        assert np.array_equal(
            _bits(ts.predictors["p0"].pipeline.src_quantiles),
            _bits(js.predictors["p0"].pipeline.src_quantiles))


# ------------- the invariants of the reference tests that fail under jax 0.9
def test_calibration_gate_opens_and_fit_is_monotone():
    """``tests/test_serving.py::test_calibration_refresh_gate_and_fit`` on
    the port: the Eq.-5 gate opens after its sample count, and the fit of
    the live stream is monotone."""
    server = _fleet(1)
    assert not server.calibration_ready("t0", "p0")
    n_needed = 1 + int(1.96 ** 2 * 0.95 / (0.25 * 0.05))
    for i in range(0, n_needed, 64):
        server.score_batch([_req("t0", i + j) for j in range(64)])
    assert server.calibration_ready("t0", "p0")
    qm = server.fit_custom_quantile_map("t0", "p0", np.linspace(0, 1, 64))
    assert (np.diff(qm.src_quantiles.numpy()) >= -1e-7).all()


def test_shadow_on_another_model_group_runs_its_models():
    """``tests/test_serving.py::test_shadow_distinct_model_group_still_
    runs_models`` on the port: a shadow on another model group pays its
    own model calls; one on the live group reuses the live raw scores."""
    server = _fleet(1, shadow=True)
    server.deploy(PredictorSpec("p-3", ("m1", "m2", "m3"), (0.2, 0.4, 0.5),
                                (1.0, 1.0, 1.0), QuantileMap.identity(64)),
                  FACTORIES)
    server.publish_routing(trouting.RoutingTable(
        server.routing.scoring_rules,
        (trouting.ShadowRule(trouting.Condition(tenants=("t0",)),
                             ("p-sh", "p-3")),), version="v2"))
    before = dict(server.metrics)
    server.score_batch([_req("t0", 3)])
    delta = {k: server.metrics[k] - before[k] for k in
             ("kernel_dispatches", "model_group_calls", "model_calls")}
    # live {m1,m2}: 2 forwards; p-sh reuses them; p-3 {m1,m2,m3}: 3 more
    assert delta == {"kernel_dispatches": 3, "model_group_calls": 2,
                     "model_calls": 5}


def test_drift_triggers_refresh_and_restores_alignment():
    """``tests/test_roadmap_extensions.py::TestClosedLoopRefresh`` on the
    port: a client the cold-start map mismatches alarms, is refreshed once
    the Eq.-5 gate opens, and its PSI falls back under 0.1."""
    from repro_torch.core.routing import Condition, Intent, RoutingTable
    from repro_torch.core.routing import ScoringRule
    from repro_torch.experiments.fraud_world import FraudWorld
    from repro_torch.serving.types import ScoringRequest

    world = FraudWorld.build(seed=21, client_shift=0.5)
    names = ("m1", "m2", "m3")
    server = MuseServer(
        RoutingTable((ScoringRule(Condition(), "p"),), version="v1"),
        ServerConfig(refresh_alert_rate=0.05, refresh_rel_error=0.5),
        device="cpu")
    server.deploy(world.predictor_spec(
        "p", names, world.coldstart_quantile_map(names, n_trials=1)),
        world.model_factories("cpu"))
    ctl = CalibrationRefreshController(server, world.ref_quantiles,
                                       psi_alarm=0.25, window=4000)
    ctl.attach()

    def serve(n):
        x, _ = world.client.sample(n)
        for i in range(0, n, 500):
            server.score_batch([ScoringRequest(Intent(tenant="bank1"), f)
                                for f in x[i:i + 500].astype(np.float32)])

    serve(8000)
    done = ctl.tick()
    assert [(t, p) for t, p, _ in done] == [("bank1", "p")]
    assert done[0][2] > 0.25
    serve(6000)
    assert ctl._monitors[("bank1", "p")].current_psi() < 0.1
    assert ctl.tick() == []
