"""The fleet calibration plane and rolling promotion of the port.

* ``FleetCalibrationController`` over a ``ReplicaSet``: fenced publish and
  ``StaleGenerationError``, ``align`` of a surged replica, a straggler
  keeps its complete old plane, a late ack cannot roll a replica back,
  structured pull failures, stream floors of the fenced session routing.
* Against the JAX package: replicas restored from the same estimator
  checkpoints give the same merged fit (reports, bitwise tables,
  generations, acks); the rollout's event log and pod-count timeline are
  the reference's for the same steps (the JAX servers run
  ``fused_kernel=False``, so no Pallas kernel runs).
* Tracking modes: one replica with fused device tracking and one eager
  give the same merged fit as two eager replicas.
* The reference's model-update scenario (3 tenants, {m1,m2} ->
  {m1,m2,m3}, per-tenant alert rates within 1.2 pp of a = 2% before and
  after the update).
"""
import numpy as np
import pytest

from repro.core import routing as jrouting
from repro.core.predictor import PredictorSpec as JSpec
from repro.core.quantiles import StreamingQuantileEstimator as JEstimator
from repro.core.transforms import QuantileMap as JQuantileMap
from repro.serving import calibration as jcal
from repro.serving import rollout as jrollout
from repro.serving import server as jserver
from repro.serving import types as jtypes
from repro_torch.core import routing as trouting
from repro_torch.core.predictor import PredictorSpec
from repro_torch.core.quantiles import (StreamingQuantileEstimator,
                                        required_sample_size)
from repro_torch.core.routing import Condition, Intent, RoutingTable, ScoringRule
from repro_torch.core.transforms import QuantileMap
from repro_torch.experiments.fraud_world import FraudWorld, train_expert
from repro_torch.serving import rollout as trollout
from repro_torch.serving import types as ttypes
from repro_torch.serving.calibration import (CalibrationController,
                                             FleetCalibrationController,
                                             RefreshPolicy)
from repro_torch.serving.drift import (realized_alert_rate,
                                       transformed_stream_psi)
from repro_torch.serving.rollout import Replica, ReplicaSet, RollingUpdate
from repro_torch.serving.server import (MuseServer, ServerConfig,
                                        StaleGenerationError)
from repro_torch.serving.types import ScoringRequest
from repro_torch.training.data import FraudEventStream, TenantProfile

DIM = 8
GATE = required_sample_size(0.05, 0.5)
REF = np.linspace(0.0, 1.0, 64) ** 2


def _linear_model(seed: int, dim: int = DIM):
    w = np.random.default_rng(seed).normal(0, 1, dim).astype(np.float32)
    return lambda x: 1.0 / (1.0 + np.exp(-(np.asarray(x, np.float32) @ w)))


FACTORIES = {f"m{i}": (lambda i=i: _linear_model(i)) for i in (1, 2)}


def _rules(mod, n_tenants, version):
    rules = tuple(mod.ScoringRule(mod.Condition(tenants=(f"t{i}",)), f"p{i}")
                  for i in range(n_tenants)) + \
        (mod.ScoringRule(mod.Condition(), "p0"),)
    return mod.RoutingTable(rules, version=version)


def _server(n_tenants=2, version="v1", **config) -> MuseServer:
    server = MuseServer(
        _rules(trouting, n_tenants, version),
        ServerConfig(refresh_alert_rate=0.05, refresh_rel_error=0.5,
                     **config), device="cpu")
    for i in range(n_tenants):
        server.deploy(PredictorSpec(f"p{i}", ("m1", "m2"), (0.2, 0.4),
                                    (1.0, 1.0), QuantileMap.identity(64)),
                      FACTORIES)
    return server


def _jserver(n_tenants=2, version="v1") -> jserver.MuseServer:
    server = jserver.MuseServer(
        _rules(jrouting, n_tenants, version),
        jserver.ServerConfig(refresh_alert_rate=0.05, refresh_rel_error=0.5,
                             fused_kernel=False))
    for i in range(n_tenants):
        server.deploy(JSpec(f"p{i}", ("m1", "m2"), (0.2, 0.4), (1.0, 1.0),
                            JQuantileMap.identity(64)), FACTORIES)
    return server


def _policy(mod=None, **kw):
    cls = RefreshPolicy if mod is None else mod.RefreshPolicy
    return cls(**{**dict(alert_rate=0.05, rel_error=0.5, n_levels=64), **kw})


def _inject(server, tenant, pred, samples, seed=0):
    est = StreamingQuantileEstimator(capacity=65536, seed=seed,
                                     recent_capacity=256)
    est.update(samples)
    server._estimators[(tenant, pred)] = est


def _mk_fleet(n_replicas=3, n_tenants=2):
    reps = [Replica(i, _server(n_tenants), "v1", ready=True)
            for i in range(n_replicas)]
    return ReplicaSet(reps), reps


def _fill(reps, n_tenants=2, per_rep=None, seed=0):
    """One well-formed stream per (tenant, predictor), split across the
    replicas, each replica below the Eq.-5 gate alone."""
    per_rep = per_rep if per_rep is not None else GATE // len(reps) + 60
    rng = np.random.default_rng(seed)
    for i in range(n_tenants):
        data = rng.normal(0.5, 0.15, per_rep * len(reps)).clip(0.0, 1.0)
        for j, rep in enumerate(reps):
            _inject(rep.server, f"t{i}", f"p{i}",
                    data[j * per_rep:(j + 1) * per_rep], seed=31 * j + i)


def _req(tenant, seed=0, mod=ttypes, routing=trouting):
    rng = np.random.default_rng(seed)
    return mod.ScoringRequest(intent=routing.Intent(tenant=tenant),
                              features=rng.normal(0, 1, DIM).astype(
                                  np.float32))


def _raise(exc):
    def fail(*args, **kwargs):
        raise exc
    return fail


class TestFencedPublish:
    def test_stale_fenced_publish_rejected_and_state_unchanged(self):
        server = _server()
        server.publish_quantile_maps({}, generation=3)
        for stale in (1, 3):
            with pytest.raises(StaleGenerationError) as ei:
                server.publish_quantile_maps({}, generation=stale)
            assert ei.value.requested == stale and ei.value.current == 3
        assert server.bank_generation == 3

    def test_align_fast_forwards_surged_replica(self):
        rs, reps = _mk_fleet(2)
        fleet = FleetCalibrationController(rs, REF, _policy())
        reps[0].server.publish_quantile_maps({}, generation=4)
        new = Replica(9, _server(), "v2", ready=True)
        assert fleet.align(new) == 4 == new.bank_generation
        assert fleet.align(new) == 4
        # a surged replica receives the maps the fleet already published
        _fill(reps)
        res = fleet.refresh_fleet()
        assert len(res.refreshed) == 2
        late = Replica(10, _server(), "v2", ready=True)
        assert fleet.align(late) == res.fleet_generation
        for name in ("p0", "p1"):
            a = reps[0].server.predictors[name].pipeline.src_quantiles
            b = late.server.predictors[name].pipeline.src_quantiles
            assert np.array_equal(a.numpy(), b.numpy())

    def test_fleet_pass_converges_divergent_replicas(self):
        rs, reps = _mk_fleet(3)
        _fill(reps, per_rep=GATE + 60)
        for rep in reps[:2]:
            CalibrationController(rep.server, REF, _policy()).refresh_fleet()
        assert rs.fleet_generation().divergent
        fleet = FleetCalibrationController(rs, REF, _policy())
        res = fleet.refresh_fleet()
        assert res.acked == ("0", "1", "2")
        audit = rs.fleet_generation()
        assert not audit.divergent
        assert audit.max_generation == res.fleet_generation == 2


class TestStragglers:
    def test_straggler_keeps_complete_old_plane(self):
        rs, reps = _mk_fleet(3)
        _fill(reps)
        straggler = reps[2]
        pre = straggler.server.score_batch([_req("t0"), _req("t1", 1)])
        straggler.server.publish_quantile_maps = _raise(
            ConnectionError("down"))
        res = FleetCalibrationController(rs, REF, _policy()).refresh_fleet()
        assert res.acked == ("0", "1") and res.nacked == ("2",)
        assert len(res.refreshed) == 2
        assert reps[0].bank_generation == res.fleet_generation > 0
        assert straggler.bank_generation == 0
        del straggler.server.publish_quantile_maps
        post = straggler.server.score_batch([_req("t0"), _req("t1", 1)])
        assert [(r.bank_generation, r.score) for r in post] == \
            [(0, r.score) for r in pre]

    def test_late_ack_cannot_roll_back(self):
        rs, reps = _mk_fleet(2)
        _fill(reps)
        straggler = reps[1]
        captured = {}

        def failing(updates, *, generation=None):
            captured.update(updates=updates, generation=generation)
            raise ConnectionError("partitioned")

        straggler.server.publish_quantile_maps = failing
        fleet = FleetCalibrationController(rs, REF, _policy())
        assert fleet.refresh_fleet().nacked == ("1",)
        del straggler.server.publish_quantile_maps      # the partition heals
        _fill(reps, seed=1)
        res2 = fleet.refresh_fleet()
        assert "1" in res2.acked
        assert straggler.bank_generation == res2.fleet_generation \
            > captured["generation"]
        with pytest.raises(StaleGenerationError):
            straggler.server.publish_quantile_maps(
                captured["updates"], generation=captured["generation"])
        assert straggler.bank_generation == res2.fleet_generation

    def test_pull_failures_are_structured(self):
        rs, reps = _mk_fleet(3)
        _fill(reps, per_rep=GATE + 60)
        reps[1].server.snapshot_estimator_checkpoints = _raise(
            OSError("pull refused"))
        fleet = FleetCalibrationController(rs, REF, _policy())
        res = fleet.refresh_fleet()
        assert [f.replica_id for f in res.pull_failures] == ["1"]
        assert "OSError" in res.pull_failures[0].error
        assert res.acked == ("0", "2") and not res.nacked
        assert reps[1].bank_generation == 0
        # every replica unreachable: nothing published, generation kept
        for rep in reps:
            rep.server.snapshot_estimator_checkpoints = _raise(
                TimeoutError("no route"))
        res = fleet.refresh_fleet()
        assert len(res.pull_failures) == 3 and not res.acked
        assert res.fleet_generation == fleet.fleet_generation() == 1


class TestStreamFloors:
    def _divergent_pair(self):
        rs, reps = _mk_fleet(2)
        reps[1].server.publish_quantile_maps({}, generation=2)
        return rs, reps

    def test_floor_pins_stream_and_refuses_rollback(self):
        rs, reps = self._divergent_pair()
        gens = [r.bank_generation for i in range(8)
                for r in rs.dispatch([_req("t0", i)], stream="c1")]
        assert gens == sorted(gens) and rs.stream_floor("c1") == 2
        assert rs.stream_floor("other") == -1
        reps[1].ready = False
        with pytest.raises(RuntimeError, match="generation rollback"):
            rs.dispatch([_req("t0")], stream="c1")
        assert rs.dispatch([_req("t0")])[0].bank_generation == 0

    def test_floor_table_is_bounded(self):
        now = [0.0]
        rs = ReplicaSet([Replica(0, _server(), "v1", ready=True)],
                        stream_floor_ttl=10.0, max_tracked_streams=3,
                        clock=lambda: now[0])
        for s in ("a", "b", "c", "d"):
            rs.dispatch([_req("t0")], stream=s)
            now[0] += 1.0
        assert rs.tracked_streams() == 3 and rs.stream_floor("a") == -1
        now[0] += 100.0
        assert rs.stream_floor("d") == -1


# ------------------------------------------------ against the reference
def _pair_from_checkpoints(tmp_path, n_replicas=3):
    """Port replicas with filled streams, and JAX replicas restored from
    each port replica's estimator checkpoint."""
    rs, reps = _mk_fleet(n_replicas)
    _fill(reps, per_rep=2 * GATE)
    jreps = []
    for rep in reps:
        path = str(tmp_path / f"r{rep.replica_id}")
        rep.server.save_estimators(path, step=1)
        jsrv = _jserver()
        jsrv.restore_estimators(path)
        jreps.append(jrollout.Replica(rep.replica_id, jsrv, "v1", ready=True))
    return rs, reps, jrollout.ReplicaSet(jreps), jreps


def test_merged_fit_matches_the_reference(tmp_path):
    rs, reps, jrs, jreps = _pair_from_checkpoints(tmp_path)
    res = FleetCalibrationController(rs, REF, _policy()).refresh_fleet()
    jres = jcal.FleetCalibrationController(jrs, REF,
                                           _policy(jcal)).refresh_fleet()
    assert [(r.tenant, r.predictor, r.samples, r.status, r.reasons)
            for r in res.reports] == \
        [(r.tenant, r.predictor, r.samples, r.status, r.reasons)
         for r in jres.reports]
    assert [(r.psi, r.realized_alert_rate) for r in res.reports] == \
        [(r.psi, r.realized_alert_rate) for r in jres.reports]
    assert (res.fleet_generation, res.acked, res.merged_streams) == \
        (jres.fleet_generation, jres.acked, jres.merged_streams) == \
        (1, ("0", "1", "2"), 2)
    for rep, jrep in zip(reps, jreps):
        assert rep.bank_generation == jrep.bank_generation
        for name in ("p0", "p1"):
            got = rep.server.predictors[name].pipeline.src_quantiles.numpy()
            want = np.asarray(jrep.server.predictors[name].pipeline
                              .src_quantiles)
            assert np.array_equal(got.view(np.uint32),
                                  want.view(np.uint32))


def _rollout_pair():
    """The same rolling update on both packages: two v1 replicas, a fleet
    plane, v2 servers whose streams are filled past the gate."""
    out = []
    for mod, make in ((trollout, _server), (jrollout, _jserver)):
        reps = [mod.Replica(i, make(), "v1", ready=True) for i in range(2)]
        out.append((mod, mod.ReplicaSet(reps), make))
    return out


def test_rollout_log_and_timeline_match_the_reference():
    runs = []
    for (mod, rs, make), (cal, types, routing, est_cls) in zip(
            _rollout_pair(),
            ((None, ttypes, trouting, StreamingQuantileEstimator),
             (jcal, jtypes, jrouting, JEstimator))):
        fleet_cls = FleetCalibrationController if cal is None \
            else cal.FleetCalibrationController
        fleet = fleet_cls(rs, REF, _policy(cal))

        def make_v2(make=make, est_cls=est_cls):
            srv = make(version="v2")
            rng = np.random.default_rng(42)
            for i in range(2):
                est = est_cls(capacity=65536, seed=i, recent_capacity=256)
                est.update(rng.uniform(0, 1, GATE + 50))
                srv._estimators[(f"t{i}", f"p{i}")] = est
            return srv

        update = mod.RollingUpdate(rs, make_v2, "v2", schema_dim=DIM,
                                   warmup_batch_sizes=(1, 2),
                                   fleet_calibration=fleet)

        def traffic(types=types, routing=routing):
            i = 0
            while True:
                yield [_req("t0", i, types, routing),
                       _req("t1", i + 1, types, routing)]
                i += 2

        timeline = update.run_with_traffic(traffic(),
                                           batches_per_transition=2)
        runs.append((
            [(e.kind, e.replica_id, e.pod_count) for e in update.events],
            [(t["pod_count"], t["ready_count"], t["version"], t["batch"])
             for t in timeline],
            [r.fleet_generation for r in update.refreshes],
            [(r.replica_id, r.version, r.bank_generation)
             for r in rs.replicas]))
    assert runs[0] == runs[1]
    events, timeline, gens, replicas = runs[0]
    assert [k for k, _, _ in events].count("calibrate") == 2
    assert min(t[1] for t in timeline) == 2          # never below 2 ready
    assert max(t[0] for t in timeline) == 3          # surge of one
    assert [r[1] for r in replicas] == ["v2", "v2"]


def test_device_tracking_replica_gives_the_eager_merged_fit():
    """One replica with fused device tracking and one eager replica, fed
    the same windows as two eager replicas: identical merged snapshots and
    an identical fleet publish."""
    fleets = []
    for config in (dict(track_device=True, track_staging=64), {}):
        reps = [Replica(0, _server(3, quantile_capacity=512,
                                   recent_capacity=64, **config),
                        "v1", ready=True),
                Replica(1, _server(3, quantile_capacity=512,
                                   recent_capacity=64), "v1", ready=True)]
        rs = ReplicaSet(reps)
        for w in range(40):
            for rep in reps:
                rep.serve([_req(f"t{i % 3}", 1000 * w + 10 * rep.replica_id
                                + i) for i in range(30)])
        fleets.append((rs, reps))
    (rs_d, reps_d), (rs_e, reps_e) = fleets
    assert reps_d[0].server._tracker.pending_total() > 0
    snap_d = reps_d[0].server.snapshot_estimator_checkpoints()
    snap_e = reps_e[0].server.snapshot_estimator_checkpoints()
    assert snap_d.keys() == snap_e.keys() and snap_e
    for key, (arrays, meta) in snap_e.items():
        # meta exactly, the live prefixes bitwise (the tail is not state)
        assert snap_d[key][1] == meta
        nf, nr = meta["filled"], meta["recent_filled"]
        assert np.array_equal(snap_d[key][0]["buf"][:nf], arrays["buf"][:nf])
        assert np.array_equal(snap_d[key][0]["recent"][:nr],
                              arrays["recent"][:nr])
    other = reps_e[1].server.snapshot_estimator_checkpoints()
    for key in snap_e:
        merged_d = StreamingQuantileEstimator.merge_checkpoints(
            [snap_d[key], other[key]])
        merged_e = StreamingQuantileEstimator.merge_checkpoints(
            [snap_e[key], other[key]])
        assert merged_d.count == merged_e.count
        assert np.array_equal(merged_d.values(), merged_e.values())
    res_d = FleetCalibrationController(rs_d, REF, _policy()).refresh_fleet()
    res_e = FleetCalibrationController(rs_e, REF, _policy()).refresh_fleet()
    assert res_d.reports == res_e.reports and res_d.refreshed
    for rep_d, rep_e in zip(reps_d, reps_e):
        for name in rep_e.server.predictors:
            assert np.array_equal(
                rep_d.server.predictors[name].pipeline.src_quantiles.numpy(),
                rep_e.server.predictors[name].pipeline.src_quantiles.numpy())


# ------------------------------------------- the model-update scenario
def test_alert_rates_stable_across_model_update():
    """The reference's ``TestModelUpdateScenario`` on the port (CPU): cold
    maps fill the streams, a refresh calibrates, {m1,m2} -> {m1,m2,m3}
    ships with the stale maps, one refresh recalibrates; every tenant's
    alert rate at a = 2% is within 1.2 pp before and after the update."""
    a, batch, per_phase = 0.02, 500, 4000
    world = FraudWorld.build(n_experts=2, betas=(0.18, 0.18), seed=17,
                             client_shift=0.3)
    world.experts["m3"] = train_expert(FraudEventStream(TenantProfile(
        "train-pool", fraud_rate=0.01, feature_shift=0.3, seed=303)),
        "m3", 0.02, mask_seed=33)
    old, new = ("m1", "m2"), ("m1", "m2", "m3")
    tenants = [f"bank{i}" for i in range(3)]
    streams = {t: FraudEventStream(TenantProfile(
        t, fraud_rate=0.006 + 0.003 * i, feature_shift=0.25 + 0.06 * i,
        seed=500 + i)) for i, t in enumerate(tenants)}
    qm0 = world.coldstart_quantile_map(old, n_trials=1)
    factories = world.model_factories("cpu")
    server = MuseServer(
        RoutingTable(tuple(ScoringRule(Condition(tenants=(t,)), f"p-old-{t}")
                           for t in tenants), version="v1"),
        ServerConfig(refresh_alert_rate=a, refresh_rel_error=0.3),
        device="cpu")
    for t in tenants:
        server.deploy(world.predictor_spec(f"p-old-{t}", old, qm0), factories)
    ctrl = CalibrationController(server, world.ref_quantiles,
                                 RefreshPolicy(alert_rate=a, rel_error=0.3))

    def serve_phase():
        scores = {t: [] for t in tenants}
        for t in tenants:
            x, _ = streams[t].sample(per_phase)
            for i in range(0, per_phase, batch):
                resps = server.score_batch([
                    ScoringRequest(intent=Intent(tenant=t), features=f)
                    for f in x[i:i + batch]])
                scores[t].extend(r.score for r in resps)
        return {t: np.asarray(s) for t, s in scores.items()}

    def rates(scores):
        return {t: realized_alert_rate(s, world.ref_quantiles, a)
                for t, s in scores.items()}

    serve_phase()
    assert len(ctrl.refresh_fleet().refreshed) == 3
    pre = rates(serve_phase())
    for t in tenants:
        assert pre[t] == pytest.approx(a, abs=0.012), (t, pre)
    prov = server.pool.provision_events
    for t in tenants:
        stale = server.predictors[f"p-old-{t}"].pipeline
        server.deploy(world.predictor_spec(
            f"p-new-{t}", new,
            QuantileMap(stale.src_quantiles, stale.ref_quantiles)), factories)
    assert server.pool.provision_events == prov + 1           # only m3
    server.publish_routing(RoutingTable(
        tuple(ScoringRule(Condition(tenants=(t,)), f"p-new-{t}")
              for t in tenants), version="v2"))
    serve_phase()
    res = ctrl.refresh_fleet()
    assert {(t, f"p-new-{t}") for t in tenants} <= \
        {(r.tenant, r.predictor) for r in res.refreshed}
    assert server.bank_generation == 2
    post_scores = serve_phase()
    post = rates(post_scores)
    for t in tenants:
        assert post[t] == pytest.approx(a, abs=0.012), (t, post)
        assert abs(post[t] - pre[t]) <= 0.02
        assert transformed_stream_psi(post_scores[t],
                                      world.ref_quantiles) < 0.25


# ------------- the invariants of the reference tests that fail under jax 0.9
def test_rolling_update_keeps_availability_and_shifts_version():
    """``tests/test_serving.py::TestRollout`` on the port: three replicas,
    no calibration plane; never fewer than 3 ready, a surge of one, traffic
    ends on v2, every new replica warmed (all of its predictors)."""
    from repro_torch.serving.warmup import warm_up

    rs = ReplicaSet([Replica(i, _server(), "v1", ready=True)
                     for i in range(3)])
    update = RollingUpdate(rs, lambda: _server(version="v2"), "v2",
                           schema_dim=DIM, warmup_batch_sizes=(1, 4))

    def traffic():
        i = 0
        while True:
            yield [_req("t0", i), _req("t1", i + 1)]
            i += 2

    timeline = update.run_with_traffic(traffic(), batches_per_transition=2)
    assert min(t["ready_count"] for t in timeline) >= 3
    assert max(t["pod_count"] for t in timeline) == 4
    assert timeline[-1]["version"] == "v2"
    assert {t["version"] for t in timeline} == {"v1", "v2"}
    assert all(r.warmup_seconds > 0 for r in rs.replicas)
    assert set(warm_up(rs.replicas[0].server, DIM, batch_sizes=(1, 2))) \
        == {"p0", "p1"}
