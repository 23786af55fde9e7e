"""The port's dense ``MuseServer`` against the JAX package's, end to end.

One FraudWorld ensemble (built from the same seed in both packages), eight
tenant predictors each with a T^Q fitted on its own tenant's traffic, and a
shadow candidate sharing the model group.  The same request stream goes in
windows of 64 through both servers with ``fused_kernel=True`` (the JAX
server's Pallas kernel runs in interpret mode; the port's CPU path runs the
plain PyTorch version).  Discrete results — predictors, routing versions,
bank generations, shadow records, metric counters, estimator seen counts
and RNG states, Eq.-5 gate answers — must be identical; scores, raw scores
and reservoir values agree within the reference's f32 kernel tolerance
(rtol = atol = 2e-5).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import routing as jrouting
from repro.core.transforms import QuantileMap as JQuantileMap
from repro.experiments.fraud_world import FraudWorld as JWorld
from repro.serving import server as jserver
from repro.serving import types as jtypes
from repro.serving.batching import MicroBatcher as JMicroBatcher
from repro.serving.batching import ServerBatcher as JServerBatcher
from repro.training.data import FraudEventStream, TenantProfile
from repro_torch.core import routing as trouting
from repro_torch.core import transforms as tt
from repro_torch.core.transforms import QuantileMap as TQuantileMap
from repro_torch.experiments.fraud_world import FraudWorld as TWorld
from repro_torch.serving import server as tserver
from repro_torch.serving import types as ttypes
from repro_torch.serving.batching import MicroBatcher as TMicroBatcher
from repro_torch.serving.batching import ServerBatcher as TServerBatcher

TOL = dict(rtol=2e-5, atol=2e-5)
SEED = 3
N_TENANTS = 8
WINDOW = 64
N_WINDOWS = 8
GROUP = ("m1", "m2", "m3")
# small reservoirs so the stream overflows them and the reservoir RNG draws;
# an Eq.-5 gate of 62 events, so some streams pass it and some do not
CONFIG = dict(quantile_capacity=48, recent_capacity=16,
              refresh_alert_rate=0.2, refresh_rel_error=0.5)


@pytest.fixture(autouse=True, scope="module")
def _pallas_load():
    """JAX 0.9 removed ``pallas.load``, which the reference's banked kernel
    still calls on its uniform-block path.  Supply it (as ``ref[idx]``) for
    this module only, so the reference kernel runs in interpret mode, then
    drop every trace made with it so no later module reuses one."""
    import jax
    from jax.experimental import pallas as pl

    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(pl, "load"):
            mp.setattr(pl, "load", lambda ref, idx, **_: ref[idx],
                       raising=False)
        yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def worlds():
    return JWorld.build(seed=SEED), TWorld.build(seed=SEED)


def _tenant_traffic():
    """Per-tenant feature streams (numpy, shared by both packages)."""
    return [FraudEventStream(TenantProfile(f"t{i}", fraud_rate=0.01,
                                           feature_shift=0.05 * i,
                                           seed=50 + i))
            for i in range(N_TENANTS)]


def _routing(mod, version="v1", shadows=True):
    rules = tuple(mod.ScoringRule(mod.Condition(tenants=(f"t{i}",)), f"p{i}")
                  for i in range(N_TENANTS))
    shadow = (mod.ShadowRule(mod.Condition(tenants=("t0", "t1", "t2", "t3")),
                             ("cand",)),) if shadows else ()
    return mod.RoutingTable(rules, shadow, version=version)


def _deploy(server, world, fit_x, factories):
    for i, x in enumerate(fit_x):
        qm = world.custom_quantile_map(GROUP, x)
        server.deploy(world.predictor_spec(f"p{i}", GROUP, qm), factories)
    cand = world.predictor_spec("cand", GROUP,
                                world.custom_quantile_map(GROUP, fit_x[0]))
    server.deploy(dataclasses.replace(cand, weights=(2.0, 1.0, 1.0)),
                  factories)


def _pair(worlds, **config):
    """A JAX server and a port server with the same predictors deployed."""
    jw, tw = worlds
    fit_x = [s.sample(400)[0] for s in _tenant_traffic()]
    cfg = {"fused_kernel": True, **CONFIG, **config}
    js = jserver.MuseServer(_routing(jrouting), jserver.ServerConfig(**cfg))
    ts = tserver.MuseServer(_routing(trouting), tserver.ServerConfig(**cfg),
                            device="cpu")
    _deploy(js, jw, fit_x, jw.model_factories())
    _deploy(ts, tw, fit_x, tw.model_factories("cpu"))
    return js, ts


def _stream(n, seed):
    """(tenant, features) pairs of a mixed-tenant request stream."""
    rng = np.random.default_rng(seed)
    streams = _tenant_traffic()
    feats = [s.sample(n)[0] for s in streams]
    tenants = rng.integers(0, N_TENANTS, n)
    return [(f"t{t}", feats[t][i]) for i, t in enumerate(tenants)]


def _requests(stream, start=0):
    def make(mod_types, mod_routing):
        return [mod_types.ScoringRequest(mod_routing.Intent(tenant=t), x,
                                         request_id=start + i)
                for i, (t, x) in enumerate(stream)]
    return make(jtypes, jrouting), make(ttypes, trouting)


def _past_last_knot(server, responses, name):
    """Which responses of predictor ``name`` had a T^Q input at or past
    every source knot of its table edge-padded to the bank's 256 knots, and
    that table's last reference knot.  The port maps such an input to
    exactly that knot; the reference interpolates the last segment, which
    for a table narrower than its reference table is a padded flat one."""
    p = server.predictors[name].pipeline
    rows = np.asarray([r.predictor == name for r in responses])
    raws = torch.tensor([r.raw_scores for r in responses], dtype=torch.float32)
    agg = tt._banked_pre_quantile(raws, torch.zeros(len(responses),
                                                    dtype=torch.long),
                                  p.betas[None], p.weights[None]).numpy()
    past = rows & (agg >= float(p.src_quantiles.max()))
    return past, float(p.ref_quantiles[-1])


def _assert_same_responses(jr, tr, last_knot=None):
    """``last_knot``: (mask, value) of the responses the port maps to a
    table's last reference knot where the reference interpolates
    (:func:`_past_last_knot`)."""
    assert len(jr) == len(tr)
    for a, b in zip(jr, tr):
        assert (a.request_id, a.predictor, a.routing_version,
                a.bank_generation) == (b.request_id, b.predictor,
                                       b.routing_version, b.bank_generation)
    want = np.asarray([a.score for a in jr], np.float32)
    got = np.asarray([b.score for b in tr], np.float32)
    if last_knot is not None:
        past, value = last_knot
        want = np.where(past, np.float32(value), want)
        assert np.array_equal(got[past], want[past])
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose([b.raw_scores for b in tr],
                               [a.raw_scores for a in jr], **TOL)


def _serve(js, ts, stream, start=0):
    jr, tr = [], []
    for w in range(0, len(stream), WINDOW):
        jreq, treq = _requests(stream[w:w + WINDOW], start + w)
        jr += js.score_batch(jreq)
        tr += ts.score_batch(treq)
    return jr, tr


@pytest.fixture(scope="module")
def served(worlds):
    js, ts = _pair(worlds)
    jr, tr = _serve(js, ts, _stream(WINDOW * N_WINDOWS, seed=11))
    return js, ts, jr, tr


def test_fraud_world_is_bitwise_equal(worlds):
    jw, tw = worlds
    assert list(jw.experts) == list(tw.experts)
    for name, je in jw.experts.items():
        te = tw.experts[name]
        assert te.beta == je.beta and te.b == je.b
        assert np.array_equal(te.w, je.w)
        assert np.array_equal(te.feature_mask, je.feature_mask)
    assert np.array_equal(tw.ref_quantiles, jw.ref_quantiles)
    assert np.array_equal(tw.client.direction, jw.client.direction)


def test_responses_match(served):
    _, _, jr, tr = served
    assert len(tr) == WINDOW * N_WINDOWS
    _assert_same_responses(jr, tr)
    assert {r.predictor for r in tr} == {f"p{i}" for i in range(N_TENANTS)}
    assert all(0.0 <= r.score <= 1.0 for r in tr)


def test_metric_counters_match(served):
    js, ts, _, _ = served
    assert ts.metrics == js.metrics
    assert ts.metrics["kernel_dispatches"] == 2 * N_WINDOWS  # live + shadow
    assert ts.metrics["skip_blocks_total"] > 0


def test_shadow_records_match(served):
    js, ts, _, _ = served
    jrec, trec = js.sink.records(), ts.sink.records()
    assert len(trec) == len(jrec) > 0
    for a, b in zip(jrec, trec):
        assert (a.request_id, a.tenant, a.predictor, a.routing_version) == \
            (b.request_id, b.tenant, b.predictor, b.routing_version)
    np.testing.assert_allclose([b.score for b in trec],
                               [a.score for a in jrec], **TOL)
    np.testing.assert_allclose([b.raw_scores for b in trec],
                               [a.raw_scores for a in jrec], **TOL)


def test_estimator_streams_match(served):
    js, ts, _, _ = served
    jest, test = js.estimator_streams(), ts.estimator_streams()
    assert sorted(test) == sorted(jest)
    overflowed = 0
    for key, je in jest.items():
        te = test[key]
        assert te.count == je.count
        assert te._rng.bit_generator.state == je._rng.bit_generator.state
        np.testing.assert_allclose(te.values(), je.values(), **TOL)
        np.testing.assert_allclose(te.recent(), je.recent(), **TOL)
        overflowed += je.count > CONFIG["quantile_capacity"]
    assert overflowed > 0


def test_calibration_ready_matches(served):
    js, ts, _, _ = served
    answers = [(ts.calibration_ready(t, p), js.calibration_ready(t, p))
               for t, p in list(js.estimator_streams()) + [("t9", "p0")]]
    assert all(a == b for a, b in answers)
    assert {a for a, _ in answers} == {True, False}


def test_refresh_publish_and_decommission(worlds):
    js, ts = _pair(worlds)
    stream = _stream(WINDOW * 4, seed=12)
    _serve(js, ts, stream[:2 * WINDOW])

    # refit p0's T^Q on its live stream, then swap it in
    ref = worlds[0].ref_quantiles
    jq = js.fit_custom_quantile_map("t0", "p0", ref, n_levels=64)
    tq = ts.fit_custom_quantile_map("t0", "p0", ref, n_levels=64)
    np.testing.assert_allclose(tq.src_quantiles.numpy(),
                               np.asarray(jq.src_quantiles), **TOL)
    js.swap_transformation("p0", jq)
    ts.swap_transformation("p0", tq)
    assert ts.bank_generation == js.bank_generation == 1
    jr, tr = _serve(js, ts, stream[2 * WINDOW:3 * WINDOW], 2 * WINDOW)
    # p0's refit has 64 source knots against 256 reference knots, so the
    # bank pads its source table with a flat last segment
    last_knot = _past_last_knot(ts, tr, "p0")
    assert last_knot[0].any()
    _assert_same_responses(jr, tr, last_knot)
    assert {r.bank_generation for r in tr} == {1}

    # fenced publishes: forward lands, stale is refused, empty fast-forwards
    src = np.sort(np.random.default_rng(5).uniform(0, 1, 256)).astype(
        np.float32)
    assert js.publish_quantile_maps(
        {"p3": JQuantileMap(src, ref)}, generation=5) == 5
    assert ts.publish_quantile_maps(
        {"p3": TQuantileMap(torch.tensor(src), torch.tensor(ref))},
        generation=5) == 5
    with pytest.raises(jtypes.StaleGenerationError):
        js.publish_quantile_maps({}, generation=3)
    with pytest.raises(ttypes.StaleGenerationError):
        ts.publish_quantile_maps({}, generation=3)
    assert js.publish_quantile_maps({}, generation=6) == \
        ts.publish_quantile_maps({}, generation=6) == 6
    jr, tr = _serve(js, ts, stream[3 * WINDOW:], 3 * WINDOW)
    _assert_same_responses(jr, tr, _past_last_knot(ts, tr, "p0"))
    assert {r.bank_generation for r in tr} == {6}

    # retire the shadow: routing first, then the predictor
    js.publish_routing(_routing(jrouting, "v2", shadows=False))
    ts.publish_routing(_routing(trouting, "v2", shadows=False))
    js.decommission("cand")
    ts.decommission("cand")
    assert ts.bank_generation == js.bank_generation == 7
    assert sorted(ts.estimator_streams()) == sorted(js.estimator_streams())
    assert ts.pool.names() == js.pool.names()
    assert ts.metrics == js.metrics
    with pytest.raises(KeyError):
        ts.publish_routing(_routing(trouting, "v3", shadows=True))


def test_server_batcher_flushes(worlds):
    js, ts = _pair(worlds)
    now = [0.0]
    jb = JServerBatcher(js, JMicroBatcher(max_batch=16, max_wait_ms=1.0,
                                          clock=lambda: now[0]))
    tb = TServerBatcher(ts, TMicroBatcher(max_batch=16, max_wait_ms=1.0,
                                          clock=lambda: now[0]))
    jreq, treq = _requests(_stream(40, seed=13))
    jr, tr = [], []
    for a, b in zip(jreq, treq):
        jr += js_out if (js_out := jb.submit(a)) else []
        tr += ts_out if (ts_out := tb.submit(b)) else []
    assert len(tr) == len(jr) == 32 and tb.pending_count == jb.pending_count
    now[0] = 1.0
    jr += jb.poll()
    tr += tb.poll()
    assert tb.pending_count == jb.pending_count == 0
    assert tb.drain() == [] and jb.drain() == []
    _assert_same_responses(jr, tr)
    assert ts.metrics == js.metrics


def test_plain_path_matches_fused_path(worlds):
    _, ts = _pair(worlds)
    _, plain = _pair(worlds, fused_kernel=False)
    stream = _stream(WINDOW, seed=14)
    _, a = _requests(stream)
    _, b = _requests(stream)
    fused, unfused = ts.score_batch(a), plain.score_batch(b)
    assert [r.score for r in fused] == [r.score for r in unfused]
    assert plain.metrics["skip_blocks_total"] == 0


@pytest.mark.parametrize("config", [
    dict(tenant_shards=2),
    dict(tiering=tserver.TieringConfig(hot_capacity=2, victim_capacity=1),
         tenant_shards=2)])
def test_unported_configurations_raise(config):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tserver.MuseServer(_routing(trouting), tserver.ServerConfig(**config),
                           device="cpu")
