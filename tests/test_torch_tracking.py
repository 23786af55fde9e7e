"""Fused device tracking and estimator checkpoints of the port.

Inside the port: with ``ServerConfig(track_device=True)`` the track stage
stages each window's aggregate in a device tensor
(``repro_torch.kernels.quantile_track``), and the host estimators it
materializes at the calibration plane's pull boundaries are bitwise equal
to the port's eager tracking (seen counts, ring pointers, RNG state and
the live prefixes of reservoir and recent ring) in the three staging
regimes of the reference's own campaign: staging 4096 (nothing pulled
before the snapshot), 64 (spills) and 8 (host fallbacks).  Scores do not
depend on the tracking mode.

Across the packages, on the CPU: the port's tracker plans, spills, falls
back and drains as the JAX package's does (counters, pending counts and
RNG states equal; values within the reference's f32 tolerance, 2e-5), its
``_segment_plan`` equals the reference's, and checkpoints written by
either package's ``save_checkpoint`` / ``save_estimators`` restore in the
other bitwise.
"""
import numpy as np
import pytest
import torch

from repro.core import routing as jrouting
from repro.core.quantiles import StreamingQuantileEstimator as JEstimator
from repro.experiments.fraud_world import FraudWorld as JWorld
from repro.kernels import quantile_track as jtrack
from repro.serving import server as jserver
from repro.serving import types as jtypes
from repro.training import checkpoint as jckpt
from repro.training.data import FraudEventStream, TenantProfile
from repro_torch.core import routing as trouting
from repro_torch.core.predictor import PredictorSpec
from repro_torch.core.quantiles import (
    StreamingQuantileEstimator,
    required_sample_size,
)
from repro_torch.core.routing import (Condition, Intent, RoutingTable,
                                      ScoringRule)
from repro_torch.core.transforms import QuantileMap, TransformBank
from repro_torch.experiments.fraud_world import FraudWorld as TWorld
from repro_torch.kernels import quantile_track as ttrack
from repro_torch.serving import server as tserver
from repro_torch.serving import types as ttypes
from repro_torch.serving.server import MuseServer, ServerConfig
from repro_torch.serving.types import ScoringRequest
from repro_torch.training import checkpoint as tckpt

TOL = dict(rtol=2e-5, atol=2e-5)
DIM = 8
TENANTS = 4


# ------------------------------------------------ the port on its own
def _linear_model(seed: int, dim: int = DIM):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 1, dim).astype(np.float32)

    def score(x):
        x = np.asarray(x, np.float32)
        return 1.0 / (1.0 + np.exp(-(x @ w)))

    return score


FACTORIES = {f"m{i}": (lambda i=i: _linear_model(i)) for i in (1, 2)}


def _server(track_device: bool, *, staging: int = 4096, capacity: int = 256,
            recent: int = 32, track: bool = True) -> MuseServer:
    """The reference campaign's server (4 tenants, 2 linear experts), on
    the port, on the CPU."""
    rules = tuple(ScoringRule(Condition(tenants=(f"t{i}",)), f"p{i}")
                  for i in range(TENANTS)) + \
        (ScoringRule(Condition(), "p0"),)
    server = MuseServer(
        RoutingTable(rules, (), version="v1"),
        ServerConfig(track_quantiles=track, track_device=track_device,
                     track_staging=staging, quantile_capacity=capacity,
                     recent_capacity=recent, refresh_alert_rate=0.05,
                     refresh_rel_error=0.5),
        device="cpu")
    for i in range(TENANTS):
        server.deploy(PredictorSpec(f"p{i}", ("m1", "m2"), (0.2, 0.4),
                                    (1.0, 1.0), QuantileMap.identity(64)),
                      FACTORIES)
    return server


def _req(tenant: str, seed: int) -> ScoringRequest:
    rng = np.random.default_rng(seed)
    return ScoringRequest(intent=Intent(tenant=tenant),
                          features=rng.normal(0, 1, DIM).astype(np.float32))


def _windows(n_mixed: int = 18, w: int = 48, seed: int = 7):
    """Mixed-tenant windows plus one large single-tenant window (> the
    recent ring, so its bulk-reset branch runs too)."""
    rng = np.random.default_rng(seed)
    out, k = [], 0
    for _ in range(n_mixed):
        out.append([_req(f"t{rng.integers(0, TENANTS)}", k := k + 1)
                    for _ in range(w)])
    out.append([_req("t0", k := k + 1) for _ in range(3 * 32 + 5)])
    return out


def _drive(server, windows):
    return [server.score_batch(win) for win in windows]


def _assert_snapshots_equal(ca: dict, cb: dict) -> None:
    """Checkpoint snapshots equal: meta exactly, the live prefixes of the
    reservoir and the recent ring bitwise (the tail past them is not
    state)."""
    assert ca.keys() == cb.keys() and ca
    for key in ca:
        (arr_a, meta_a), (arr_b, meta_b) = ca[key], cb[key]
        assert meta_a == meta_b, key          # seen/pos/filled/rng_state
        nf, nr = meta_a["filled"], meta_a["recent_filled"]
        assert np.array_equal(arr_a["buf"][:nf], arr_b["buf"][:nf]), key
        assert np.array_equal(arr_a["recent"][:nr],
                              arr_b["recent"][:nr]), key


def _snapshots_equal(a: MuseServer, b: MuseServer) -> None:
    _assert_snapshots_equal(a.snapshot_estimator_checkpoints(),
                            b.snapshot_estimator_checkpoints())


class TestBitwiseParity:
    @pytest.mark.parametrize("staging", [4096, 64, 8])
    def test_checkpoint_state_matches_eager_host_tracking(self, staging):
        host, dev = _server(False), _server(True, staging=staging)
        windows = _windows()
        _drive(host, windows)
        _drive(dev, windows)
        tracker = dev._tracker
        if staging == 4096:
            assert tracker.pending_total() > 0    # nothing pulled yet
            assert tracker.spills == 0
            assert dev.metrics["track_staged_windows"] > 0
        elif staging == 64:
            assert tracker.spills > 0
            assert dev.metrics["track_staged_windows"] > 0
        else:
            assert tracker.host_fallbacks > 0     # stream share > plane
        _snapshots_equal(host, dev)
        # after the sync everything is materialized; a second pull is stable
        assert tracker.pending_total() == 0
        _snapshots_equal(host, dev)

    def test_scores_unaffected_by_tracking_mode(self):
        off = _server(False, track=False)
        host, dev = _server(False), _server(True)
        windows = _windows(n_mixed=6)
        for w_off, w_host, w_dev in zip(_drive(off, windows),
                                        _drive(host, windows),
                                        _drive(dev, windows)):
            for a, b, c in zip(w_off, w_host, w_dev):
                assert a.score == b.score == c.score
        assert off._tracker is None and not off._estimators

    def test_quantiles_after_sync_match_eager(self):
        host, dev = _server(False), _server(True)
        windows = _windows(n_mixed=8)
        _drive(host, windows)
        _drive(dev, windows)
        levels = np.linspace(0.01, 0.99, 33)
        eh = host.estimator_streams()
        ed = dev.estimator_streams()      # host-pull boundary: syncs first
        assert eh.keys() == ed.keys() and eh
        for key in eh:
            assert np.array_equal(eh[key].quantiles(levels),
                                  ed[key].quantiles(levels)), key

    def test_fused_aggregate_is_the_eager_aggregate(self):
        """``_fused_append`` stages exactly the bits ``pre_quantile``
        gives the eager path."""
        rng = np.random.default_rng(3)
        bank = TransformBank.from_params(
            [(rng.uniform(0.05, 1, 3), rng.uniform(0.1, 2, 3),
              np.sort(rng.uniform(0, 1, 16)), np.sort(rng.uniform(0, 1, 16)))
             for _ in range(5)], device="cpu")
        raws = torch.tensor(rng.uniform(0, 1, (40, 3)), dtype=torch.float32)
        idx = torch.tensor(rng.integers(0, 5, 40), dtype=torch.int32)
        staging = torch.zeros(100)
        flat = torch.from_numpy(rng.permutation(100)[:40])
        ttrack._fused_append(staging, flat, raws, idx, bank.betas,
                             bank.weights)
        assert torch.equal(staging[flat], bank.pre_quantile(raws, idx))


class TestHostPullBoundaries:
    def test_calibration_ready_sees_staged_samples(self):
        dev = _server(True)
        gate = required_sample_size(0.05, 0.5)
        n = 0
        while n <= gate:
            dev.score_batch([_req("t1", n + i) for i in range(64)])
            n += 64
        assert dev._tracker.pending(("t1", "p1")) > 0
        assert dev.calibration_ready("t1", "p1")
        # the gate's pull materialized the stream
        assert dev._estimators[("t1", "p1")].count == n

    def test_fit_custom_quantile_map_pulls_first(self):
        host, dev = _server(False), _server(True)
        windows = _windows(n_mixed=4)
        _drive(host, windows)
        _drive(dev, windows)
        assert dev._tracker.pending(("t0", "p0")) > 0
        ref = np.linspace(0.0, 1.0, 64) ** 2
        a = host.fit_custom_quantile_map("t0", "p0", ref, n_levels=64)
        b = dev.fit_custom_quantile_map("t0", "p0", ref, n_levels=64)
        assert dev._tracker.pending_total() == 0
        assert torch.equal(a.src_quantiles, b.src_quantiles)

    def test_save_restore_gate_passes_warm(self, tmp_path):
        """save -> restore on a fresh replica -> the Eq.-5 gate passes
        without new traffic, and tracking keeps staging afterwards."""
        gate = required_sample_size(0.05, 0.5)
        src = _server(True, capacity=131072, recent=4096)
        rng = np.random.default_rng(3)
        k = 0
        for _ in range((2 * gate) // 64 + 2):
            src.score_batch([_req(f"t{rng.integers(0, 2)}", k := k + 1)
                             for _ in range(64)])
        assert src._tracker.pending_total() > 0
        src.save_estimators(str(tmp_path), step=1)
        assert src._tracker.pending_total() == 0   # the save pulled first

        dst = _server(True, capacity=131072, recent=4096)
        assert dst.restore_estimators(str(tmp_path)) >= 2   # latest step
        _snapshots_equal(src, dst)
        assert all(dst.calibration_ready(t, f"p{t[1]}") for t in ("t0", "t1"))
        dst.score_batch([_req("t0", 10_000 + i) for i in range(48)])
        assert dst._tracker.pending(("t0", "p0")) == 48
        src.score_batch([_req("t0", 10_000 + i) for i in range(48)])
        _snapshots_equal(src, dst)

    def test_restore_drains_staged_samples_into_the_old_streams(self,
                                                                tmp_path):
        src = _server(False)
        _drive(src, _windows(n_mixed=3))
        src.save_estimators(str(tmp_path), step=0)
        dst = _server(True)
        _drive(dst, _windows(n_mixed=5, seed=9))
        assert dst._tracker.pending_total() > 0
        dst.restore_estimators(str(tmp_path), step=0)
        assert dst._tracker.pending_total() == 0
        _snapshots_equal(src, dst)

    def test_restore_without_a_checkpoint_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            _server(True).restore_estimators(str(tmp_path / "none"))

    def test_decommission_drops_staged_stream(self):
        dev = _server(True)
        dev.score_batch([_req("t1", i) for i in range(40)])
        assert dev._tracker.pending(("t1", "p1")) == 40
        dev.decommission("p1")
        assert dev._tracker.pending(("t1", "p1")) == 0
        assert ("t1", "p1") not in dev._estimators
        # redeploy under the same name: the stream restarts from zero
        dev.deploy(PredictorSpec("p1", ("m1", "m2"), (0.2, 0.4), (1.0, 1.0),
                                 QuantileMap.identity(64)), FACTORIES)
        dev.score_batch([_req("t1", 100 + i) for i in range(16)])
        assert dev.estimator_streams()[("t1", "p1")].count == 16


# ---------------------------------------------------- the tracker alone
def _pair(module, estimator, staging: int):
    """A tracker of ``module`` whose drains feed ``estimator`` streams."""
    ests: dict = {}

    def apply(key, chunks):
        ests.setdefault(key, estimator(
            capacity=128, seed=11, recent_capacity=16)).apply_chunks(chunks)

    device = {"device": "cpu"} if module is ttrack else {}
    return module.DeviceQuantileTracker(apply, staging_capacity=staging,
                                        **device), ests


def _agg_windows(seed: int = 0, n: int = 30):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        b = int(rng.integers(1, 12))
        keys = [("t%d" % rng.integers(0, 3), "p") for _ in range(b)]
        # f32 like the serving path: the staging plane is f32
        yield keys, rng.uniform(0, 1, b).astype(np.float32)


def _update_eager(ests, keys, agg, estimator=StreamingQuantileEstimator):
    for key in dict.fromkeys(keys):
        rows = [j for j, k in enumerate(keys) if k == key]
        ests.setdefault(key, estimator(capacity=128, seed=11,
                                       recent_capacity=16)).update(agg[rows])


class TestTrackerUnit:
    def test_segment_plan_ranks_and_counts(self):
        slots = np.array([2, 0, 2, 2, 0, 5])
        ranks, uniq, incoming = ttrack._segment_plan(slots)
        assert ranks.tolist() == [0, 0, 1, 2, 1, 0]   # arrival order kept
        assert uniq.tolist() == [0, 2, 5]
        assert incoming.tolist() == [2, 3, 1]

    @pytest.mark.parametrize("seed", range(4))
    def test_segment_plan_matches_the_reference(self, seed):
        rng = np.random.default_rng(seed)
        for _ in range(20):
            slots = rng.integers(0, int(rng.integers(1, 40)),
                                 int(rng.integers(1, 300)))
            for got, want in zip(ttrack._segment_plan(slots),
                                 jtrack._segment_plan(slots)):
                assert got.dtype == want.dtype
                assert np.array_equal(got, want)

    @pytest.mark.parametrize("staging", [512, 16, 2])
    def test_append_agg_replay_matches_eager(self, staging):
        """Tracker-level bitwise parity for the precomputed-aggregate path,
        across the spill and fallback regimes."""
        tracker, ests = _pair(ttrack, StreamingQuantileEstimator, staging)
        eager: dict = {}
        for keys, agg in _agg_windows():
            if not tracker.append_agg(keys, agg):
                _update_eager(ests, keys, agg)
            _update_eager(eager, keys, agg)
        tracker.sync()
        assert ests.keys() == eager.keys() and ests
        for key in eager:
            assert ests[key].checkpoint_meta() == \
                eager[key].checkpoint_meta()
            assert np.array_equal(ests[key].values(), eager[key].values())
            assert np.array_equal(ests[key].recent(), eager[key].recent())

    @pytest.mark.parametrize("staging", [512, 16, 2])
    def test_tracker_matches_the_reference_tracker(self, staging):
        """The same windows through both packages' trackers: the same
        spills, fallbacks, appends and pending counts after every window,
        and bitwise the same estimators after the drain."""
        theirs, jests = _pair(jtrack, JEstimator, staging)
        ours, tests = _pair(ttrack, StreamingQuantileEstimator, staging)
        for keys, agg in _agg_windows(seed=1, n=40):
            if not theirs.append_agg(keys, agg):
                _update_eager(jests, keys, agg, JEstimator)
            if not ours.append_agg(keys, agg):
                _update_eager(tests, keys, agg)
            assert (ours.spills, ours.host_fallbacks, ours.appends,
                    ours.pending_total()) == \
                (theirs.spills, theirs.host_fallbacks, theirs.appends,
                 theirs.pending_total())
            assert all(ours.pending(k) == theirs.pending(k) for k in keys)
        assert ours.sync() == theirs.sync()
        assert 0 < ours.drains <= ours.spills + ours.host_fallbacks + 1
        assert tests.keys() == jests.keys() and tests
        for key, je in jests.items():
            assert tests[key].checkpoint_meta() == je.checkpoint_meta()
            assert np.array_equal(tests[key].values(), je.values())
            assert np.array_equal(tests[key].recent(), je.recent())

    def test_empty_window_is_a_noop(self):
        tracker, ests = _pair(ttrack, StreamingQuantileEstimator, 8)
        assert tracker.append_agg([], np.empty(0))
        assert tracker.append_fused([], None, None, None)
        assert tracker.pending_total() == 0 and not ests

    def test_drop_where_frees_and_reuses_slots(self):
        tracker, ests = _pair(ttrack, StreamingQuantileEstimator, 16)
        tracker.append_agg([("a", "p"), ("b", "p")], np.array([0.1, 0.2]))
        assert tracker.drop_where(lambda k: k[0] == "a") == 1
        assert tracker.pending(("a", "p")) == 0
        tracker.append_agg([("c", "p")], np.array([0.3]))   # reuses slot
        tracker.sync()
        assert set(ests) == {("b", "p"), ("c", "p")}
        assert ests[("c", "p")].count == 1

    def test_slot_growth_preserves_staged_data(self):
        tracker, ests = _pair(ttrack, StreamingQuantileEstimator, 4)
        keys = [(f"t{i}", "p") for i in range(200)]   # forces _grow twice
        agg = (np.arange(200) / 200.0).astype(np.float32)
        tracker.append_agg(keys, agg)
        assert tracker.pending(("t199", "p")) == 1
        assert tracker._staging.shape == (256 * 4,)
        tracker.sync()
        assert len(ests) == 200
        assert float(ests[("t42", "p")].values()[0]) == float(agg[42])

    def test_staging_capacity_must_be_positive(self):
        with pytest.raises(ValueError):
            ttrack.DeviceQuantileTracker(lambda k, c: None,
                                         staging_capacity=0, device="cpu")


# --------------------------------------------- across the two packages
SEED = 3
N_TENANTS = 8
WINDOW = 64
GROUP = ("m1", "m2", "m3")
CONFIG = dict(quantile_capacity=48, recent_capacity=16,
              refresh_alert_rate=0.2, refresh_rel_error=0.5,
              fused_kernel=False)


@pytest.fixture(scope="module")
def worlds():
    return JWorld.build(seed=SEED), TWorld.build(seed=SEED)


def _tenant_traffic():
    return [FraudEventStream(TenantProfile(f"t{i}", fraud_rate=0.01,
                                           feature_shift=0.05 * i,
                                           seed=50 + i))
            for i in range(N_TENANTS)]


def _routing(mod):
    rules = tuple(mod.ScoringRule(mod.Condition(tenants=(f"t{i}",)), f"p{i}")
                  for i in range(N_TENANTS))
    shadow = (mod.ShadowRule(mod.Condition(tenants=("t0", "t1")),
                             ("cand",)),)
    return mod.RoutingTable(rules, shadow, version="v1")


def _deploy(server, world, fit_x, factories):
    for i, x in enumerate(fit_x):
        server.deploy(world.predictor_spec(
            f"p{i}", GROUP, world.custom_quantile_map(GROUP, x)), factories)
    server.deploy(world.predictor_spec(
        "cand", GROUP, world.custom_quantile_map(GROUP, fit_x[0])),
        factories)


def _servers(worlds, **config):
    """A JAX server and a port server, the same predictors deployed."""
    jw, tw = worlds
    fit_x = [s.sample(400)[0] for s in _tenant_traffic()]
    cfg = {**CONFIG, **config}
    js = jserver.MuseServer(_routing(jrouting), jserver.ServerConfig(**cfg))
    ts = tserver.MuseServer(_routing(trouting), tserver.ServerConfig(**cfg),
                            device="cpu")
    _deploy(js, jw, fit_x, jw.model_factories())
    _deploy(ts, tw, fit_x, tw.model_factories("cpu"))
    return js, ts


def _fraud_windows(n_windows: int, seed: int, start: int = 0):
    """Mixed-tenant FraudWorld windows, as (JAX requests, port requests)."""
    rng = np.random.default_rng(seed)
    feats = [s.sample(n_windows * WINDOW)[0] for s in _tenant_traffic()]
    tenants = rng.integers(0, N_TENANTS, n_windows * WINDOW)
    stream = [(f"t{t}", feats[t][i]) for i, t in enumerate(tenants)]
    out = []
    for w in range(0, len(stream), WINDOW):
        chunk = stream[w:w + WINDOW]
        out.append(tuple(
            [types.ScoringRequest(routing.Intent(tenant=t), x,
                                  request_id=start + w + i)
             for i, (t, x) in enumerate(chunk)]
            for types, routing in ((jtypes, jrouting), (ttypes, trouting))))
    return out


def _serve(js, ts, windows):
    for jreq, treq in windows:
        js.score_batch(jreq)
        ts.score_batch(treq)


def _assert_streams_close(js, ts):
    """Estimator counts and RNG states equal; values within 2e-5 (the two
    packages' aggregates differ in the last bits)."""
    jest, test = js.estimator_streams(), ts.estimator_streams()
    assert sorted(test) == sorted(jest) and test
    for key, je in jest.items():
        te = test[key]
        assert te.count == je.count
        assert te.checkpoint_meta()["rng_state"] == \
            je.checkpoint_meta()["rng_state"]
        np.testing.assert_allclose(te.values(), je.values(), **TOL)
        np.testing.assert_allclose(te.recent(), je.recent(), **TOL)


@pytest.mark.parametrize("staging", [4096, 64, 8])
def test_device_tracking_matches_the_reference(worlds, staging):
    js, ts = _servers(worlds, track_device=True, track_staging=staging)
    windows = _fraud_windows(12, seed=21)
    for jreq, treq in windows:
        js.score_batch(jreq)
        ts.score_batch(treq)
        jt, tt = js._tracker, ts._tracker
        assert (tt.spills, tt.host_fallbacks, tt.appends) == \
            (jt.spills, jt.host_fallbacks, jt.appends)
        assert {k: tt.pending(k) for k in tt._slots} == \
            {k: jt.pending(k) for k in jt._slots}
    assert ts.metrics == js.metrics
    tt = ts._tracker
    if staging == 4096:
        assert tt.pending_total() > 0 and tt.spills == 0
    elif staging == 64:
        assert tt.spills > 0
    else:
        assert tt.host_fallbacks > 0
    _assert_streams_close(js, ts)
    assert tt.pending_total() == js._tracker.pending_total() == 0


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_estimator_checkpoint_restores_across_packages(worlds, tmp_path,
                                                        direction):
    """``save_estimators`` of one package restores in the other bitwise
    (arrays and meta); one more window then leaves both packages with the
    same estimator state."""
    js, ts = _servers(worlds, track_device=True, track_staging=64)
    _serve(js, ts, _fraud_windows(6, seed=23))
    jd, td = _servers(worlds, track_device=True, track_staging=64)
    src, dst, other_dst = (js, td, jd) if direction == "jax_to_torch" \
        else (ts, jd, td)
    src.save_estimators(str(tmp_path), step=2)
    assert dst.restore_estimators(str(tmp_path), step=2) == \
        len(src.snapshot_estimator_checkpoints())
    want = src.snapshot_estimator_checkpoints()
    got = dst.snapshot_estimator_checkpoints()
    assert got.keys() == want.keys() and got
    for key, (arrays, meta) in want.items():
        assert got[key][1] == meta
        for name, arr in arrays.items():
            assert got[key][0][name].dtype == arr.dtype
            assert np.array_equal(got[key][0][name], arr)
    # the other package restores the same files the same way
    other_dst.restore_estimators(str(tmp_path), step=2)
    _assert_snapshots_equal(dst.snapshot_estimator_checkpoints(),
                            other_dst.snapshot_estimator_checkpoints())
    # one more window through each restored replica
    jreq, treq = _fraud_windows(1, seed=29, start=10_000)[0]
    jd.score_batch(jreq)
    td.score_batch(treq)
    _assert_streams_close(jd, td)


def _tree(rng):
    return {"layer": [{"w": rng.normal(0, 1, (3, 4)).astype(np.float32),
                       "b": rng.normal(0, 1, 4).astype(np.float64)},
                      {"ids": rng.integers(0, 9, 5).astype(np.int32)}],
            "bf16": rng.normal(0, 1, 6).astype(np.float32),
            "scale": np.float32(rng.normal())}


def _torch_tree(tree):
    return {"layer": [{k: torch.from_numpy(np.array(v)) for k, v in d.items()}
                      for d in tree["layer"]],
            "bf16": torch.from_numpy(tree["bf16"]).to(torch.bfloat16),
            "scale": torch.tensor(tree["scale"])}


def _jax_tree(tree):
    import jax.numpy as jnp

    # float64 stays a numpy leaf (JAX holds no float64 without x64), as
    # the estimators' reservoirs reach save_estimators
    return {"layer": [{k: v if v.dtype == np.float64 else jnp.asarray(v)
                       for k, v in d.items()} for d in tree["layer"]],
            "bf16": jnp.asarray(tree["bf16"], jnp.bfloat16),
            "scale": jnp.asarray(tree["scale"])}


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    arr = np.asarray(x)
    return arr.view(np.uint16) if arr.dtype.name == "bfloat16" else arr


def _leaf_bits(tree) -> dict:
    return {k: _bits(v) for k, v in tckpt._leaves(tree)}


def test_checkpoint_layout_matches_the_reference(tmp_path):
    """The same tree saved by both packages: the same keys, dtype map,
    metadata and stored arrays (bf16 as raw bits)."""
    tree = _tree(np.random.default_rng(0))
    tckpt.save_checkpoint(str(tmp_path / "t"), 5, _torch_tree(tree),
                          metadata={"note": "x"})
    jckpt.save_checkpoint(str(tmp_path / "j"), 5, _jax_tree(tree),
                          metadata={"note": "x"})
    assert tckpt.load_metadata(str(tmp_path / "t"), 5) == \
        jckpt.load_metadata(str(tmp_path / "j"), 5)
    got = tckpt.load_arrays(str(tmp_path / "t"), 5)
    want = jckpt.load_arrays(str(tmp_path / "j"), 5)
    assert got.keys() == want.keys() == {
        "bf16", "layer/0/b", "layer/0/w", "layer/1/ids", "scale"}
    for key in want:
        assert got[key].dtype == want[key].dtype
        assert np.array_equal(got[key], want[key])
    assert tckpt.latest_step(str(tmp_path / "t")) == 5
    assert tckpt.latest_step(str(tmp_path / "none")) is None


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax",
                                       "torch_to_torch"])
def test_checkpoint_round_trips_across_packages(tmp_path, direction):
    tree = _tree(np.random.default_rng(1))
    like_t, like_j = _torch_tree(tree), _jax_tree(tree)
    if direction == "jax_to_torch":
        jckpt.save_checkpoint(str(tmp_path), 0, like_j)
        got = tckpt.restore_checkpoint(str(tmp_path), 0, like_t)
    elif direction == "torch_to_jax":
        tckpt.save_checkpoint(str(tmp_path / "t"), 0, like_t)
        got = jckpt.restore_checkpoint(str(tmp_path / "t"), 0, like_j)
    else:
        tckpt.save_checkpoint(str(tmp_path), 0, like_t)
        got = tckpt.restore_checkpoint(str(tmp_path), 0, like_t)
    if direction == "torch_to_jax":
        # what JAX restores from its own save of the same tree
        jckpt.save_checkpoint(str(tmp_path / "j"), 0, like_j)
        want = _leaf_bits(jckpt.restore_checkpoint(str(tmp_path / "j"), 0,
                                                   like_j))
    else:
        want = _leaf_bits(like_t)
    have = _leaf_bits(got)
    assert have.keys() == want.keys()
    for key in want:
        assert have[key].dtype == want[key].dtype, key
        assert np.array_equal(have[key], want[key]), key
    if direction != "torch_to_jax":
        assert got["bf16"].dtype == torch.bfloat16
        assert isinstance(got["layer"], list)


def test_restore_into_numpy_leaves_and_missing_leaf(tmp_path):
    tree = _tree(np.random.default_rng(2))
    tckpt.save_checkpoint(str(tmp_path), 1, {"a": tree["layer"][0]["b"]})
    got = tckpt.restore_checkpoint(str(tmp_path), 1,
                                   {"a": np.zeros(4, np.float64)})
    assert got["a"].dtype == np.float64
    assert np.array_equal(got["a"], tree["layer"][0]["b"])
    with pytest.raises(KeyError):
        tckpt.restore_checkpoint(str(tmp_path), 1, {"b": np.zeros(4)})
