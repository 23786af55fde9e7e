"""The port's async dispatch engine against itself and the JAX package.

``repro_torch.serving.engine`` is a copy of the reference's engine (guarded
by ``tests/test_torch_isolation.py``) running on the port's server.  Here:

* **cross-package parity** — the JAX engine on a JAX server (the jnp
  oracle, ``fused_kernel=False``: no Pallas kernel runs) and the port's
  engine on the port's CPU server, fed the same requests in fixed windows
  with calibration refreshes scheduled between drained batches: window
  sizes, per-key order, bank generations, ``epoch`` and the error counters
  equal exactly; scores within the reference's f32 tolerance (2e-5);
* **the invariants of the reference's engine tests that fail on its own
  package** (its banked Pallas kernel calls ``pallas.load``, which jax
  0.9.0 removed), each held on the port under the reference test's name:
  per-key submission order, one response per request, no torn reads with
  generations that only increase under a concurrent publisher, a refresh
  scheduled between stage boundaries, the soak across a rolling promotion
  with auto-calibration, and ``close()`` against poll-tick stress;
* the rest of the reference's engine campaign (parity with the sync path,
  the facade's order, the self-scheduling poll, shadow dedup, per-dispatch
  latency, tick failures), fused device tracking under the engine counting
  every event, and no stage or timer thread outliving ``close()``.

Every test runs under its own time limit (``_within``) and takes a few
seconds on the CPU.
"""
import functools
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.predictor import PredictorSpec as JSpec
from repro.core.quantiles import StreamingQuantileEstimator as JEstimator
from repro.core.routing import Condition as JCond
from repro.core.routing import Intent as JIntent
from repro.core.routing import RoutingTable as JTable
from repro.core.routing import ScoringRule as JRule
from repro.core.transforms import QuantileMap as JQM
from repro.serving import AsyncDispatchEngine as JEngine
from repro.serving import CalibrationController as JCalibration
from repro.serving import MuseServer as JServer
from repro.serving import RefreshPolicy as JPolicy
from repro.serving import ServerConfig as JConfig
from repro.serving.tiering import TieringConfig as JTieringConfig
from repro.serving.types import ScoringRequest as JRequest
from repro_torch.core.predictor import PredictorSpec
from repro_torch.core.quantiles import StreamingQuantileEstimator
from repro_torch.core.routing import (Condition, Intent, RoutingTable,
                                      ScoringRule, ShadowRule)
from repro_torch.core.transforms import QuantileMap, TransformBank
from repro_torch.kernels import ops
from repro_torch.serving import (
    AsyncDispatchEngine,
    CalibrationController,
    MicroBatcher,
    MuseServer,
    RefreshPolicy,
    Replica,
    ReplicaSet,
    RollingUpdate,
    ServerBatcher,
    ServerConfig,
    TieringConfig,
)
from repro_torch.serving.types import ScoringRequest

TOL = dict(rtol=2e-5, atol=2e-5)
DIM = 8
REF = np.linspace(0.0, 1.0, 64) ** 2      # smooth, front-loaded reference
TIER = dict(hot_capacity=3, victim_capacity=2, gate_alert_rate=0.5,
            gate_rel_error=1.0)


def _within(seconds: float):
    """Run the test body on its own thread and fail the test if it has not
    finished within ``seconds`` (a wedged stage fails, it does not hang)."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            box: dict = {}

            def body():
                try:
                    fn(*args, **kwargs)
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    box["error"] = e

            th = threading.Thread(target=body, daemon=True,
                                  name=f"test-{fn.__name__}")
            th.start()
            th.join(seconds)
            if th.is_alive():
                pytest.fail(f"{fn.__name__} outlasted its {seconds} s limit")
            if "error" in box:
                raise box["error"]
        return run
    return wrap


# --------------------------------------------------------------------------
# the reference tests' fleet, in both packages
# --------------------------------------------------------------------------

def _linear(seed):
    w = np.random.default_rng(seed).normal(0, 1, DIM).astype(np.float32)
    return lambda x: 1.0 / (1.0 + np.exp(-(np.asarray(x, np.float32) @ w)))


FACTORIES = {f"m{i}": (lambda i=i: _linear(i)) for i in (1, 2, 3)}
JFACTORIES = {f"m{i}": (lambda i=i: (lambda f: lambda x: jnp.asarray(f(x)))(
    _linear(i))) for i in (1, 2, 3)}


def _group(i, n_groups):
    return ("m1", "m2") if n_groups == 1 or i % 2 == 0 \
        else ("m1", "m2", "m3")


def _fleet(n_tenants=4, *, shadow=False, n_groups=1, tiering=False,
           **config) -> MuseServer:
    """One predictor per tenant; predictors alternate between ``n_groups``
    model groups ({m1,m2} vs {m1,m2,m3}), so multi-key batching is real."""
    rules = tuple(ScoringRule(Condition(tenants=(f"t{i}",)), f"p{i}")
                  for i in range(n_tenants)) + \
        (ScoringRule(Condition(), "p0"),)
    shadows = (ShadowRule(Condition(tenants=("t0",)), ("p-sh",)),) \
        if shadow else ()
    server = MuseServer(
        RoutingTable(rules, shadows, version="v1"),
        ServerConfig(refresh_alert_rate=0.05, refresh_rel_error=0.5,
                     tiering=TieringConfig(**TIER) if tiering else None,
                     **config), device="cpu")
    for i in range(n_tenants):
        group = _group(i, n_groups)
        betas = (0.2, 0.4) if len(group) == 2 else (0.2, 0.4, 0.1)
        server.deploy(PredictorSpec(f"p{i}", group, betas,
                                    (1.0,) * len(group),
                                    QuantileMap.identity(64)), FACTORIES)
    if shadow:
        server.deploy(PredictorSpec("p-sh", ("m1", "m2"), (0.5, 0.9),
                                    (2.0, 1.0), QuantileMap.identity(64)),
                      FACTORIES)
    return server


def _jfleet(n_tenants=4, *, n_groups=1, tiering=False) -> JServer:
    """The JAX twin of :func:`_fleet` on the jnp oracle."""
    rules = tuple(JRule(JCond(tenants=(f"t{i}",)), f"p{i}")
                  for i in range(n_tenants)) + (JRule(JCond(), "p0"),)
    server = JServer(
        JTable(rules, version="v1"),
        JConfig(refresh_alert_rate=0.05, refresh_rel_error=0.5,
                fused_kernel=False,
                tiering=JTieringConfig(fused_kernel=False, **TIER)
                if tiering else None))
    for i in range(n_tenants):
        group = _group(i, n_groups)
        betas = (0.2, 0.4) if len(group) == 2 else (0.2, 0.4, 0.1)
        server.deploy(JSpec(f"p{i}", group, betas, (1.0,) * len(group),
                            JQM.identity(64)), JFACTORIES)
    return server


def _features(seed):
    return np.random.default_rng(seed).normal(0, 1, DIM).astype(np.float32)


def _req(tenant, seed, request_id=None):
    kw = {} if request_id is None else {"request_id": request_id}
    return ScoringRequest(intent=Intent(tenant=tenant),
                          features=_features(seed), **kw)


def _jreq(tenant, seed, request_id):
    return JRequest(intent=JIntent(tenant=tenant), features=_features(seed),
                    request_id=request_id)


def _policy(mod=RefreshPolicy, **kw):
    return mod(**{**dict(alert_rate=0.05, rel_error=0.5, n_levels=64), **kw})


def _inject(server, tenant, pred, n=5000, seed=0, estimator=None):
    """A gate-passing estimator stream big enough that live tracking cannot
    move its distribution (refresh validation stays green)."""
    rng = np.random.default_rng(seed)
    est = (estimator or StreamingQuantileEstimator)(capacity=131072,
                                                    seed=seed)
    est.update(rng.uniform(0, 1, n))
    server._estimators[(tenant, pred)] = est


def _registry(server):
    return {n: p.pipeline for n, p in server.predictors.items()}


def _assert_consistent(responses, registry):
    """Every response equals, bit for bit, its raw scores replayed through a
    one-row bank of the pipeline of the ONE generation it is stamped with
    (the banked pipeline is row-independent): a torn read diverges."""
    for resp in responses:
        pipe = registry[resp.bank_generation][resp.predictor]
        bank = TransformBank.from_params(
            [(pipe.betas, pipe.weights, pipe.src_quantiles,
              pipe.ref_quantiles)])
        want = ops.score_pipeline_banked(
            torch.tensor([resp.raw_scores], dtype=torch.float32),
            torch.zeros(1, dtype=torch.int32), bank.betas, bank.weights,
            bank.src_quantiles, bank.ref_quantiles)
        assert resp.score == float(want[0]), \
            (resp.request_id, resp.predictor, resp.bank_generation)


def _assert_monotone_generations(responses):
    """Per stream (tenant), in completion order, generations never step
    back."""
    seen: dict[str, int] = {}
    for resp in responses:
        last = seen.get(resp.predictor, -1)
        assert resp.bank_generation >= last, \
            (resp.predictor, last, resp.bank_generation)
        seen[resp.predictor] = resp.bank_generation


def _counters(engine):
    return (len(engine.errors), engine.tick_errors, engine.track_errors,
            engine.prefetch_errors, engine.completed_dropped)


# --------------------------------------------------------------------------
# cross-package parity
# --------------------------------------------------------------------------

@pytest.mark.parametrize("topology", ["dense", "two_groups", "tiered"])
@_within(120)
def test_engine_matches_the_reference_engine(topology):
    """Same requests, fixed windows of 8, a calibration refresh scheduled
    at a stage boundary after each drained batch: window sizes, per-key
    order, generations, epoch and error counters equal exactly; scores
    within 2e-5.  Tiered, the tier counters are equal too; for that each
    window is drained before the next is submitted, since a window's
    prefetch racing the previous window's dispatch staging makes the
    counters depend on the threads' interleaving, in either package."""
    n_t, n_groups = (6, 2) if topology == "two_groups" else (4, 1)
    tiering = topology == "tiered"
    mine = _fleet(n_t, n_groups=n_groups, tiering=tiering)
    theirs = _jfleet(n_t, n_groups=n_groups, tiering=tiering)
    for i in range(n_t):
        _inject(mine, f"t{i}", f"p{i}", seed=i)
        _inject(theirs, f"t{i}", f"p{i}", seed=i, estimator=JEstimator)
    engines = (AsyncDispatchEngine(mine, max_batch=8, max_wait_ms=1e9),
               JEngine(theirs, max_batch=8, max_wait_ms=1e9))
    ctrls = (CalibrationController(mine, REF, _policy()),
             JCalibration(theirs, REF, _policy(JPolicy)))
    out: tuple[list, list] = ([], [])
    results: tuple[list, list] = ([], [])
    for batch in range(3):
        specs = [(f"t{(batch + i) % n_t}", 100 * batch + i, 100 * batch + i)
                 for i in range(21)]
        chunk = 8 if tiering else len(specs)
        for e, make, o in zip(engines, (_req, _jreq), out):
            for c in range(0, len(specs), chunk):
                futs = [e.submit(make(*s)) for s in specs[c:c + chunk]]
                o.extend(e.drain(timeout=60))
                assert all(f.done() for f in futs)
        for e, c, r in zip(engines, ctrls, results):
            r.append(e.schedule_refresh(c).result(timeout=60))
    for e in engines:
        e.close()
    a, b = engines
    assert a.epoch == b.epoch == 3
    assert _counters(a) == _counters(b) == (0, 0, 0, 0, 0)
    for ra, rb in zip(*results):
        assert (ra.epoch, ra.generation) == (rb.epoch, rb.generation)
        assert {(x.tenant, x.predictor) for x in ra.refreshed} == \
            {(x.tenant, x.predictor) for x in rb.refreshed}
    assert mine.bank_generation == theirs.bank_generation == 3

    def per_key(log):
        keys: dict[str, list] = {}
        for w in log:
            keys.setdefault(w["key"], []).append(
                (w["size"], w["bank_generation"]))
        return keys

    assert per_key(a.window_log) == per_key(b.window_log)
    ids_a = [(r.predictor, r.request_id) for r in out[0]]
    ids_b = [(r.predictor, r.request_id) for r in out[1]]
    group_of = {f"p{i}": _group(i, n_groups) for i in range(n_t)}
    for g in set(group_of.values()):
        assert [i for p, i in ids_a if group_of[p] == g] == \
            [i for p, i in ids_b if group_of[p] == g]
    by_a = {r.request_id: r for r in out[0]}
    by_b = {r.request_id: r for r in out[1]}
    assert by_a.keys() == by_b.keys() and len(by_a) == 63
    for rid, ra in by_a.items():
        rb = by_b[rid]
        assert (ra.predictor, ra.bank_generation, ra.routing_version) == \
            (rb.predictor, rb.bank_generation, rb.routing_version)
    np.testing.assert_allclose([by_a[i].score for i in sorted(by_a)],
                               [by_b[i].score for i in sorted(by_b)], **TOL)
    if tiering:
        assert mine.tier_metrics() == theirs.tier_metrics()


# --------------------------------------------------------------------------
# the invariants of the reference's failing engine tests
# --------------------------------------------------------------------------

class TestOrderingProperties:
    @settings(max_examples=5, deadline=None)
    @given(st.integers(1, 4), st.integers(6, 20))
    @_within(60)
    def test_server_batcher_responses_map_one_to_one(self, max_batch, n):
        server = _fleet(3)
        sb = ServerBatcher(server, MicroBatcher(max_batch=max_batch,
                                                max_wait_ms=1e9))
        reqs = [_req(f"t{i % 3}", i) for i in range(n)]
        got: dict[int, str] = {}

        def record(resps):
            for r in resps:
                assert r.request_id not in got   # no duplicates
                got[r.request_id] = r.predictor

        for r in reqs:
            out = sb.submit(r)
            if out is not None:
                record(out)
        record(sb.drain())
        assert sorted(got) == sorted(r.request_id for r in reqs)  # no drops
        for r in reqs:
            assert got[r.request_id] == f"p{int(r.intent.tenant[1:]) % 3}"

    @_within(60)
    def test_engine_preserves_per_key_submission_order(self):
        server = _fleet(6, n_groups=2)  # p0/2/4 on {m1,m2}; p1/3/5 on 3
        engine = AsyncDispatchEngine(server, max_batch=4, max_wait_ms=1e9)
        reqs = [_req(f"t{i % 6}", 200 + i) for i in range(48)]
        futs = [engine.submit(r) for r in reqs]
        out = engine.drain()
        engine.close()
        assert sorted(r.request_id for r in out) == \
            sorted(r.request_id for r in reqs)
        assert all(f.done() for f in futs)
        assert len(engine.window_log) == 48 // 4
        group_of = {f"t{i}": ("even" if i % 2 == 0 else "odd")
                    for i in range(6)}
        submitted: dict[str, list] = {"even": [], "odd": []}
        for r in reqs:
            submitted[group_of[r.intent.tenant]].append(r.request_id)
        completed: dict[str, list] = {"even": [], "odd": []}
        for r in out:
            completed[group_of[f"t{r.predictor[1:]}"]].append(r.request_id)
        assert completed == submitted


class TestReaderWriterEpochSafety:
    @_within(120)
    def test_no_torn_reads_and_monotone_generations(self):
        n_t = 8
        server = _fleet(n_t)
        for i in range(n_t):
            _inject(server, f"t{i}", f"p{i}", seed=i)
        ctrl = CalibrationController(server, REF, _policy())
        registry = {server.bank_generation: _registry(server)}
        assert ctrl.refresh_fleet().generation == 1
        registry[1] = _registry(server)
        engine = AsyncDispatchEngine(server, max_batch=16, max_wait_ms=1e9)
        reqs = [_req(f"t{i % n_t}", i) for i in range(1280)]
        stop = threading.Event()
        published: list[int] = []

        def writer():
            while not stop.is_set() and len(published) < 60:
                res = ctrl.refresh_fleet()
                registry[res.generation] = _registry(server)
                published.append(res.generation)
                time.sleep(0.002)

        def traffic():
            for r in reqs:
                engine.submit(r)
                if r.request_id % 64 == 0:
                    time.sleep(0.001)    # let the writer interleave

        wt = threading.Thread(target=writer)
        tt = threading.Thread(target=traffic)
        wt.start()
        tt.start()
        tt.join(timeout=60.0)
        assert not tt.is_alive(), "traffic thread wedged"
        responses = engine.drain(timeout=60.0)
        stop.set()
        wt.join(timeout=60.0)
        assert not wt.is_alive(), "refresh writer wedged"
        engine.close()
        assert sorted(r.request_id for r in responses) == \
            sorted(r.request_id for r in reqs)
        assert max(published) >= 3
        assert len({r.bank_generation for r in responses}) >= 2
        _assert_consistent(responses, registry)
        _assert_monotone_generations(responses)

    @_within(120)
    def test_refresh_scheduled_from_engine_between_stage_boundaries(self):
        n_t = 4
        server = _fleet(n_t)
        for i in range(n_t):
            _inject(server, f"t{i}", f"p{i}", seed=10 + i)
        ctrl = CalibrationController(server, REF, _policy())
        registry = {server.bank_generation: _registry(server)}
        engine = AsyncDispatchEngine(server, max_batch=8, max_wait_ms=1e9)
        futs, results = [], []
        for k in range(4):
            futs += [engine.submit(_req(f"t{i % n_t}", 500 * k + i))
                     for i in range(16)]
            res = engine.schedule_refresh(ctrl).result(timeout=60.0)
            results.append(res)
            registry[res.generation] = _registry(server)
        responses = engine.drain(timeout=60.0)
        engine.close()
        assert [r.epoch for r in results] == [1, 2, 3, 4]
        assert engine.epoch == 4
        assert [r.generation for r in results] == [1, 2, 3, 4]
        assert server.bank_generation == 4
        for res in results:
            assert len(res.refreshed) == n_t
        assert sorted(r.request_id for r in responses) == \
            sorted(f.result().request_id for f in futs)
        _assert_consistent(responses, registry)
        _assert_monotone_generations(responses)


class TestEngineSoakScenario:
    @_within(240)
    def test_soak_across_rolling_promotion_with_auto_calibration(self):
        """Three tenants serve continuously through the engine while the
        ensemble is extended ({m1,m2} -> {m1,m2,m3}) on a surged replica
        whose calibration refresh is scheduled at an engine stage boundary:
        no request id dropped or repeated, per-tenant alert rates within
        1.2 pp of the target and within 2 pp of the pre-update baseline."""
        from repro_torch.experiments.fraud_world import DIM as FDIM
        from repro_torch.experiments.fraud_world import (FraudWorld,
                                                         train_expert)
        from repro_torch.serving.drift import realized_alert_rate
        from repro_torch.training.data import FraudEventStream, TenantProfile

        a, B, per_phase = 0.02, 320, 3200
        world = FraudWorld.build(n_experts=2, betas=(0.18, 0.18), seed=17,
                                 client_shift=0.3)
        recent = FraudEventStream(TenantProfile(
            "train-pool", fraud_rate=0.01, feature_shift=0.3, seed=303))
        world.experts["m3"] = train_expert(recent, "m3", 0.02, mask_seed=33)
        old_ens, new_ens = ("m1", "m2"), ("m1", "m2", "m3")
        tenants = [f"bank{i}" for i in range(3)]
        streams = {t: FraudEventStream(TenantProfile(
            t, fraud_rate=0.006 + 0.003 * i, feature_shift=0.25 + 0.06 * i,
            seed=500 + i)) for i, t in enumerate(tenants)}
        policy = RefreshPolicy(alert_rate=a, rel_error=0.3)
        qm0 = world.coldstart_quantile_map(old_ens, n_trials=1)

        def build_server(version, ensemble, qms):
            rules = tuple(ScoringRule(Condition(tenants=(t,)), f"p-{t}")
                          for t in tenants)
            server = MuseServer(
                RoutingTable(rules, version=version),
                ServerConfig(refresh_alert_rate=a, refresh_rel_error=0.3),
                device="cpu")
            for t in tenants:
                server.deploy(world.predictor_spec(f"p-{t}", ensemble,
                                                   qms[t]),
                              world.model_factories("cpu"))
            return server

        def make_engine(server):
            return AsyncDispatchEngine(server, max_batch=B, max_wait_ms=50.0,
                                       facade_timeout_s=120.0).start()

        server_v1 = build_server("v1", old_ens, {t: qm0 for t in tenants})
        replica = Replica(0, server_v1, "v1", ready=True,
                          engine=make_engine(server_v1))
        rs = ReplicaSet([replica])
        submitted: list[int] = []
        collected: list = []

        def serve_phase(n_per_tenant):
            xs = {t: streams[t].sample(n_per_tenant)[0] for t in tenants}
            reqs = [ScoringRequest(intent=Intent(tenant=t),
                                   features=xs[t][i])
                    for i in range(n_per_tenant) for t in tenants]
            submitted.extend(r.request_id for r in reqs)
            phase: list = []
            for i in range(0, len(reqs), B):
                phase.extend(rs.dispatch(reqs[i:i + B]))
            collected.extend(phase)
            return phase

        def rates(resps):
            by_tenant: dict[str, list[float]] = {t: [] for t in tenants}
            for r in resps:
                by_tenant[r.predictor[2:]].append(r.score)
            return {t: realized_alert_rate(np.asarray(s),
                                           world.ref_quantiles, a)
                    for t, s in by_tenant.items()}

        serve_phase(per_phase)
        ctrl_v1 = CalibrationController(server_v1, world.ref_quantiles,
                                        policy)
        res1 = replica.engine.schedule_refresh(ctrl_v1).result(timeout=60.0)
        assert len(res1.refreshed) == 3, [r.reasons for r in res1.reports]
        assert res1.epoch == 1 and server_v1.bank_generation == 1
        pre = rates(serve_phase(per_phase))
        for t in tenants:
            assert pre[t] == pytest.approx(a, abs=0.012), (t, pre)

        def make_server_v2():
            stale = {t: server_v1.predictors[f"p-{t}"].pipeline
                     for t in tenants}
            qms = {t: QuantileMap(stale[t].src_quantiles,
                                  stale[t].ref_quantiles) for t in tenants}
            server = build_server("v2", new_ens, qms)
            xs = {t: streams[t].sample(per_phase)[0] for t in tenants}
            fill = [ScoringRequest(intent=Intent(tenant=t),
                                   features=xs[t][i])
                    for i in range(per_phase) for t in tenants]
            for i in range(0, len(fill), B):
                server.score_batch(fill[i:i + B])
            return server

        update = RollingUpdate(
            rs, make_server_v2, "v2", schema_dim=FDIM,
            warmup_batch_sizes=(1, B),
            calibration_factory=lambda srv: CalibrationController(
                srv, world.ref_quantiles, policy),
            engine_factory=make_engine)
        for _ in update.steps():
            serve_phase(B // len(tenants))
        assert len(update.refreshes) == 1
        res2 = update.refreshes[0]
        assert len(res2.refreshed) == 3, [r.reasons for r in res2.reports]
        assert res2.epoch >= 1
        assert [r.version for r in rs.replicas] == ["v2"]
        post_resps = serve_phase(per_phase)
        assert {r.routing_version for r in post_resps} == {"v2"}
        assert all(r.bank_generation >= 1 for r in post_resps)
        post = rates(post_resps)
        for t in tenants:
            assert post[t] == pytest.approx(a, abs=0.012), (t, post)
            assert abs(post[t] - pre[t]) <= 0.02, (t, pre, post)
        rs.replicas[0].engine.close()
        got = sorted(r.request_id for r in collected)
        assert got == sorted(submitted) and len(set(got)) == len(got)


class TestPollTimerShutdown:
    @_within(60)
    def test_close_vs_tick_stress(self):
        """start -> submit -> close with a sub-millisecond poll interval:
        after close() the tick chain is dead (no late re-arm, no timer
        thread left) and no tick polled into the shut-down executors."""
        server = _fleet(2)
        for i in range(25):
            eng = AsyncDispatchEngine(server, max_batch=8, max_wait_ms=0.01,
                                      poll_interval_ms=0.05)
            ticks: list[int] = []
            orig_poll = eng.poll
            eng.poll = lambda op=orig_poll, t=ticks: (t.append(1), op())[1]
            eng.start()
            for j in range(4):
                eng.submit(_req(f"t{j % 2}", 1000 * i + j))
            time.sleep(0.0002 * (i % 7))
            eng.close()
            assert eng.tick_errors == 0, eng.errors
            assert eng.errors == []
            time.sleep(0.002)
            n1 = len(ticks)
            time.sleep(0.01)
            assert len(ticks) == n1
            timer = eng._poll_timer
            if timer is not None:
                timer.join(timeout=1.0)
                assert not timer.is_alive()
        time.sleep(0.05)
        live = [t.name for t in threading.enumerate()
                if t.name.startswith("muse-")]
        assert not live, live


# --------------------------------------------------------------------------
# the rest of the reference's engine campaign, on the port
# --------------------------------------------------------------------------

class TestEngineParity:
    @_within(60)
    def test_pipelined_scores_match_sync_path(self):
        sync, pipe = _fleet(4), _fleet(4)
        reqs = [_req(f"t{i % 4}", i) for i in range(40)]
        want = {r.request_id: r.score for r in sync.score_batch(reqs)}
        engine = AsyncDispatchEngine(pipe, max_batch=8, max_wait_ms=1e9)
        futs = [engine.submit(r) for r in reqs]
        out = engine.drain()
        engine.close()
        assert sorted(r.request_id for r in out) == \
            sorted(r.request_id for r in reqs)
        for resp in out:          # the banked pipeline is row-independent
            assert resp.score == want[resp.request_id]
            assert resp.bank_generation == 0
        assert all(f.done() for f in futs)
        assert pipe.metrics["model_group_calls"] == len(engine.window_log)
        assert pipe.metrics["kernel_dispatches"] == len(engine.window_log)
        assert pipe.metrics["requests"] == len(reqs)

    @_within(60)
    def test_score_batch_facade_preserves_request_order(self):
        sync, pipe = _fleet(3), _fleet(3)
        engine = AsyncDispatchEngine(pipe, max_batch=8, max_wait_ms=1e9)
        reqs = [_req(f"t{i % 3}", 50 + i) for i in range(20)]
        want = sync.score_batch(reqs)
        got = engine.score_batch(reqs)
        engine.close()
        assert [r.request_id for r in got] == [r.request_id for r in reqs]
        assert [r.score for r in got] == [r.score for r in want]
        assert engine.take_completed() == []

    @_within(60)
    def test_self_scheduling_poll_flushes_aged_windows(self):
        engine = AsyncDispatchEngine(_fleet(2), max_batch=100,
                                     max_wait_ms=10.0).start()
        try:
            futs = [engine.submit(_req("t0", i)) for i in range(3)]
            resps = [f.result(timeout=30.0) for f in futs]
            assert [r.request_id for r in resps] == \
                [f.result().request_id for f in futs]
        finally:
            engine.close()

    @_within(60)
    def test_shadow_dedup_through_engine(self):
        server = _fleet(2, shadow=True)
        engine = AsyncDispatchEngine(server, max_batch=4, max_wait_ms=1e9)
        out = engine.score_batch([_req("t0", 70 + i) for i in range(4)])
        engine.close()
        assert server.metrics["model_group_calls"] == 1
        assert server.metrics["kernel_dispatches"] == 2
        recs = server.sink.records("p-sh")
        assert len(recs) == 4
        by_id = {r.request_id: r for r in out}
        for rec in recs:
            assert rec.raw_scores == by_id[rec.request_id].raw_scores

    @_within(60)
    def test_latency_is_per_dispatch_not_cumulative(self):
        server = _fleet(2)
        engine = AsyncDispatchEngine(server, max_batch=16, max_wait_ms=1e9)
        engine.score_batch([_req("t0", i) for i in range(16)])
        engine.take_completed()
        engine.window_log.clear()
        futs = [engine.submit(_req(f"t{i % 2}", 100 + i)) for i in range(48)]
        out = engine.drain()
        engine.close()
        assert len(out) == len(futs) == 48
        lats = [w["latency_ms"] for w in engine.window_log]
        assert len(lats) == 3 and all(lat > 0 for lat in lats)
        per_window = {round(w["latency_ms"], 9) for w in engine.window_log}
        for resp in out:
            assert round(resp.latency_ms, 9) in per_window

    @_within(60)
    def test_submit_after_close_raises(self):
        engine = AsyncDispatchEngine(_fleet(1), max_batch=4, max_wait_ms=1e9)
        engine.close()
        with pytest.raises(RuntimeError):
            engine.submit(_req("t0", 0))
        with pytest.raises(RuntimeError):
            engine.submit_many([_req("t0", 1)])
        assert engine.close() == []

    @_within(60)
    def test_tick_failure_surfaces_in_metric_and_chain_survives(self):
        eng = AsyncDispatchEngine(_fleet(1), poll_interval_ms=1.0)
        boom = RuntimeError("boom")
        calls: list[int] = []

        def bad_expired():
            calls.append(1)
            raise boom

        eng.batcher.expired = bad_expired
        eng.start()
        deadline = time.monotonic() + 5.0
        while len(calls) < 3 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert len(calls) >= 3 and eng.tick_errors >= 3
        assert any(e is boom for _, e in eng.errors)
        del eng.batcher.expired
        eng.close()


class TestDeviceTrackingUnderEngine:
    @_within(90)
    def test_tracked_counts_every_event(self):
        """``track_device=True`` under the adaptive engine: every event of
        the warm-up and of the stream is tracked (the reference benchmark's
        ``tracked == n_events + warm-ups``), and the estimators equal an
        eager server's fed the same windows by the same engine."""
        n_t, n = 4, 600
        fused = _fleet(n_t, track_device=True, track_staging=64)
        eager = _fleet(n_t)
        reqs = [_req(f"t{i % n_t}", 3000 + i) for i in range(n)]
        warm = [_req(f"t{i % n_t}", 9000 + i) for i in range(32)]
        for server in (fused, eager):
            server.score_batch(warm)
        engine = AsyncDispatchEngine(fused, max_batch=32, max_wait_ms=1e9)
        engine.submit_many(reqs)
        out = engine.drain(timeout=60)
        engine.close()
        assert len(out) == n and not engine.errors
        assert fused.metrics["track_staged_windows"] > 0
        tracked = sum(e.count for e in fused.estimator_streams().values())
        assert tracked == n + len(warm)
        # the same windows, in the same per-key order, eagerly
        engine = AsyncDispatchEngine(eager, max_batch=32, max_wait_ms=1e9)
        engine.submit_many(reqs)
        engine.drain(timeout=60)
        engine.close()
        want = eager.snapshot_estimator_checkpoints()
        got = fused.snapshot_estimator_checkpoints()
        assert want.keys() == got.keys()
        for key, (arrays, meta) in want.items():
            assert got[key][1] == meta
            live = meta["filled"]
            assert np.array_equal(got[key][0]["buf"][:live],
                                  arrays["buf"][:live])
