"""The port's tiered bank store against itself and against the JAX package.

Inside the port, a tiered dispatch (slot-remapped rows through the banked
pipeline, edge-padded as the dense server pads) equals a dense bank of the
same rows BITWISE, cold and warm, across staging passes, promotions,
publishes and overlapped prefetches.  Against the JAX package's store fed
the same sequence of dispatches, prefetches, rebalances, publishes and
cold-marks, the slot maps, the clock hand, hotness, Eq.-5 seen counts and
every counter (``staging_conflicts`` included, single-threaded) are equal
exactly, and scores agree within the reference's f32 tolerance
(rtol = atol = 2e-5).  The JAX stores and servers run ``fused_kernel=False``
(the jnp oracle), so no Pallas kernel runs; the port's run ``ops`` on CPU
tensors (the plain banked version).  The tiered server, the calibration
controllers, the async engine's prefetch and the rollout warm start are
covered the same way.  The sharded case of the reference's suite waits for
the sharded bank (ROADMAP Queue 1 item 11).
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hotness as jhot
from repro.core.predictor import PredictorSpec as JSpec
from repro.core.quantiles import StreamingQuantileEstimator as JEstimator
from repro.core.routing import Condition as JCond
from repro.core.routing import Intent as JIntent
from repro.core.routing import RoutingTable as JTable
from repro.core.routing import ScoringRule as JRule
from repro.core.transforms import QuantileMap as JQM
from repro.serving import CalibrationController as JCalibration
from repro.serving import MuseServer as JServer
from repro.serving import RefreshPolicy as JPolicy
from repro.serving import ServerConfig as JConfig
from repro.serving import tiering as jtier
from repro.serving.types import ScoringRequest as JRequest
from repro_torch.core import hotness as thot
from repro_torch.core.coldstart import BetaMixtureFit
from repro_torch.core.predictor import PredictorSpec
from repro_torch.core.quantiles import (StreamingQuantileEstimator,
                                        required_sample_size)
from repro_torch.core.routing import Condition, Intent, RoutingTable, ScoringRule
from repro_torch.core.transforms import QuantileMap, TransformBank
from repro_torch.kernels import ops
from repro_torch.serving import (
    AsyncDispatchEngine,
    CalibrationController,
    FleetCalibrationController,
    MuseServer,
    RefreshPolicy,
    Replica,
    ReplicaSet,
    RollingUpdate,
    ServerConfig,
    StaleGenerationError,
)
from repro_torch.serving import tiering as ttier
from repro_torch.serving.tiering import (
    HostBankStore,
    TieredBankStore,
    TieringConfig,
    prior_bank_row,
)
from repro_torch.serving.types import ScoringRequest

TOL = dict(rtol=2e-5, atol=2e-5)
DIM = 8
# an "easy" Eq.-5 gate: required_sample_size(0.5, 1.0) == 4 events
EASY_GATE = dict(gate_alert_rate=0.5, gate_rel_error=1.0)
REF64 = np.linspace(0.0, 1.0, 64) ** 2


# --------------------------------------------------------------------------
# shared fixtures
# --------------------------------------------------------------------------

def _rows(rng, t, k=4, n=32):
    return (rng.uniform(0.05, 1.0, (t, k)).astype(np.float32),
            rng.uniform(0.1, 2.0, (t, k)).astype(np.float32),
            np.sort(rng.uniform(0, 1, (t, n)), -1).astype(np.float32),
            np.sort(rng.uniform(0, 1, (t, n)), -1).astype(np.float32))


def _pair(rng, t=32, hot=8, victims=4, admitted=None, **kw):
    """(port store, JAX store, rows) over the same host rows."""
    rows = _rows(rng, t, k=kw.pop("k", 4), n=kw.pop("n", 32))
    cfg = dict(hot_capacity=hot, victim_capacity=victims, **EASY_GATE, **kw)
    mine = TieredBankStore(HostBankStore(*rows, admitted=admitted),
                           TieringConfig(**cfg), device="cpu")
    theirs = jtier.TieredBankStore(
        jtier.HostBankStore(*rows, admitted=admitted),
        jtier.TieringConfig(**{**cfg, "fused_kernel": False}))
    return mine, theirs, rows


def _dense(rows, raws, tid):
    """The port's dense banked scores of the given rows (the parity
    oracle inside the port)."""
    return ops.score_pipeline_banked(
        torch.from_numpy(np.asarray(raws, np.float32)),
        torch.from_numpy(np.asarray(tid, np.int32)),
        *(torch.from_numpy(np.ascontiguousarray(r)) for r in rows)).numpy()


def _bitwise(a, b) -> bool:
    return np.array_equal(np.asarray(a, np.float32).view(np.uint32),
                          np.asarray(b, np.float32).view(np.uint32))


def _same_state(mine, theirs):
    """Every discrete piece of tier state equal across the packages."""
    assert np.array_equal(mine._slot_of, theirs._slot_of)
    assert np.array_equal(mine._owner, theirs._owner)
    assert mine._hand == theirs._hand
    assert np.array_equal(mine._seen, theirs._seen)
    assert np.array_equal(mine.host.admitted, theirs.host.admitted)
    assert mine.metrics == theirs.metrics
    assert mine.generation == theirs.generation
    assert np.array_equal(mine.tracker.scores(), theirs.tracker.scores())
    assert mine.device_bytes == theirs.device_bytes


def _view_rows(store):
    v = store._view
    return tuple(np.asarray(x) for x in (v.betas, v.weights,
                                         v.src_quantiles, v.ref_quantiles))


def _dispatch(mine, theirs, raws, tid, want_rows=None):
    """Dispatch on both stores: the port's scores bitwise the dense bank of
    ``want_rows`` (default: the host rows), the JAX store's within 2e-5,
    the state equal."""
    got, gen = mine.dispatch(raws, tid)
    jgot, jgen = theirs.dispatch(raws, tid)
    rows = want_rows if want_rows is not None else (
        mine.host.betas, mine.host.weights, mine.host.src_quantiles,
        mine.host.ref_quantiles)
    assert _bitwise(got, _dense(rows, raws, tid))
    np.testing.assert_allclose(got, np.asarray(jgot), **TOL)
    assert gen == jgen
    _same_state(mine, theirs)
    return got


# --------------------------------------------------------------------------
# hotness tracker (core/hotness.py, a copy of the reference's)
# --------------------------------------------------------------------------

class TestHotnessTracker:
    @pytest.mark.parametrize("decay", [0.5, 0.9, 1.0])
    def test_matches_reference_over_random_windows(self, decay):
        rng = np.random.default_rng(int(decay * 10))
        mine, theirs = thot.HotnessTracker(50, decay), \
            jhot.HotnessTracker(50, decay)
        for _ in range(200):
            keys = rng.integers(0, 50, int(rng.integers(0, 20)))
            mine.record(keys)
            theirs.record(keys)
            w = int(rng.integers(0, 4))
            mine.tick(w)
            theirs.tick(w)
            assert np.array_equal(mine.scores(), theirs.scores())
            assert np.array_equal(mine.top(7), theirs.top(7))
        assert mine.windows == theirs.windows

    def test_decay_orders_recent_over_stale(self):
        tr = thot.HotnessTracker(4, decay=0.5)
        tr.record(np.array([0, 0, 0, 0]))
        tr.tick(3)
        tr.record(np.array([1, 1]))
        assert tr.score(1) > tr.score(0)
        assert list(tr.top(2)) == [1, 0]

    def test_rescale_keeps_scores_exact(self):
        tr = thot.HotnessTracker(2, decay=0.5)
        tr.record(np.array([0]))
        tr.tick(400)
        tr.record(np.array([1]))
        assert tr.score(1) == pytest.approx(1.0, rel=1e-9)
        assert tr.score(0) == pytest.approx(0.0, abs=1e-100)

    def test_snapshot_adopt_roundtrip_and_resize(self):
        tr = thot.HotnessTracker(3, decay=0.9)
        tr.record(np.array([0, 1, 1]))
        tr.tick()
        snap = tr.snapshot()
        for size in (5, 2):
            other = thot.HotnessTracker(size, decay=0.9)
            other.adopt(snap)
            ref = jhot.HotnessTracker(size, decay=0.9)
            ref.adopt(snap)
            assert np.array_equal(other.scores(), ref.scores())
            assert other.score(0) == pytest.approx(tr.score(0))

    def test_invalid_decay_rejected(self):
        for decay in (0.0, 1.5):
            with pytest.raises(ValueError):
                thot.HotnessTracker(2, decay=decay)


# --------------------------------------------------------------------------
# host store
# --------------------------------------------------------------------------

class TestHostBankStore:
    def test_from_rows_matches_reference_and_dense_padding(self):
        rng = np.random.default_rng(0)
        params = [
            (rng.uniform(0.1, 1, 2), rng.uniform(0.5, 2, 2),
             np.sort(rng.uniform(0, 1, 16)), np.sort(rng.uniform(0, 1, 16))),
            (rng.uniform(0.1, 1, 3), rng.uniform(0.5, 2, 3),
             np.sort(rng.uniform(0, 1, 8)), np.sort(rng.uniform(0, 1, 8))),
        ]
        host = HostBankStore.from_rows(
            [tuple(torch.tensor(a, dtype=torch.float32) for a in p)
             for p in params])
        ref = jtier.HostBankStore.from_rows(params)
        bank = TransformBank.from_params(
            [tuple(torch.tensor(a, dtype=torch.float32) for a in p)
             for p in params])
        for name in ("betas", "weights", "src_quantiles", "ref_quantiles"):
            assert _bitwise(getattr(host, name), getattr(ref, name))
            assert _bitwise(getattr(host, name),
                            getattr(bank, name).numpy())
        assert host.num_rows == 2 and host.num_experts == 3
        assert host.num_quantiles == 16 and host.nbytes == ref.nbytes

    def test_write_rows_pads_like_with_rows(self):
        rng = np.random.default_rng(1)
        rows = _rows(rng, 4, n=32)
        host, ref = HostBankStore(*rows), jtier.HostBankStore(*rows)
        src = np.sort(rng.uniform(0, 1, 16)).astype(np.float32)
        dst = np.sort(rng.uniform(0, 1, 16)).astype(np.float32)
        assert list(host.write_rows(
            {2: QuantileMap(torch.tensor(src), torch.tensor(dst))})) == [2]
        ref.write_rows({2: JQM(jnp.asarray(src), jnp.asarray(dst))})
        bank = TransformBank(*(torch.tensor(r) for r in rows)).with_rows(
            {2: QuantileMap(torch.tensor(src), torch.tensor(dst))})
        for name in ("src_quantiles", "ref_quantiles"):
            assert _bitwise(getattr(host, name), getattr(bank, name).numpy())
            assert _bitwise(getattr(host, name), getattr(ref, name))

    def test_write_rows_rejects_bad_rows_and_wide_tables(self):
        rng = np.random.default_rng(2)
        rows = _rows(rng, 4, n=16)
        host = HostBankStore(*rows)
        before = host.src_quantiles.copy()
        with pytest.raises(IndexError):
            host.write_rows({9: QuantileMap.identity(16)})
        with pytest.raises(ValueError):
            host.write_rows({0: QuantileMap.identity(16),
                             1: QuantileMap.identity(64)})
        assert np.array_equal(host.src_quantiles, before)   # untouched

    def test_mismatched_row_counts_rejected(self):
        with pytest.raises(ValueError):
            HostBankStore(np.ones((3, 2)), np.ones((2, 2)),
                          np.ones((3, 8)), np.ones((3, 8)))

    def test_dense_bank_and_entry_points_default_to_the_card(self):
        host = HostBankStore(*_rows(np.random.default_rng(3), 4))
        bank = host.dense_bank(3, device="cpu")
        assert bank.generation == 3 and bank.betas.device.type == "cpu"
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                host.dense_bank()
            with pytest.raises(RuntimeError, match="device='cpu'"):
                TieredBankStore(host)


# --------------------------------------------------------------------------
# tiered store: parity with the dense bank and with the reference's store
# --------------------------------------------------------------------------

class TestTieredDispatchParity:
    def test_bitwise_parity_cold_and_warm(self):
        rng = np.random.default_rng(3)
        mine, theirs, _ = _pair(rng, t=32, hot=8, victims=4)
        raws = rng.uniform(0, 1, (64, 4)).astype(np.float32)
        tid = rng.integers(0, 32, 64)
        _dispatch(mine, theirs, raws, tid)            # all-miss first window
        assert mine.rebalance() == theirs.rebalance()
        _dispatch(mine, theirs, raws, tid)            # warm path
        assert mine.metrics["hot_hits"] > 0

    def test_plain_kernel_parity(self):
        rng = np.random.default_rng(4)
        mine, theirs, rows = _pair(rng, t=16, hot=4, victims=2,
                                   fused_kernel=False)
        raws = rng.uniform(0, 1, (16, 4)).astype(np.float32)
        _dispatch(mine, theirs, raws, rng.integers(0, 16, 16))

    def test_device_bytes_bounded_by_config_not_tenants(self):
        rng = np.random.default_rng(5)
        small, jsmall, _ = _pair(rng, t=32, hot=8, victims=4)
        large, jlarge, _ = _pair(rng, t=2048, hot=8, victims=4)
        assert small.device_bytes == large.device_bytes == \
            (8 + 4 + 1) * (2 * 4 + 2 * 32) * 4 == jlarge.device_bytes
        assert large.host_bytes == jlarge.host_bytes > 16 * small.device_bytes

    def test_window_wider_than_victim_cache_multi_pass(self):
        rng = np.random.default_rng(6)
        mine, theirs, _ = _pair(rng, t=32, hot=2, victims=2)
        raws = rng.uniform(0, 1, (24, 4)).astype(np.float32)
        _dispatch(mine, theirs, raws, np.arange(24) % 12)
        assert mine.metrics["extra_passes"] > 0

    def test_prefetch_removes_cold_miss_stalls(self):
        rng = np.random.default_rng(7)
        mine, theirs, _ = _pair(rng, t=32, hot=8, victims=4)
        tid = np.array([3, 9, 3, 17])
        assert mine.prefetch(tid) == theirs.prefetch(tid) == 3
        _same_state(mine, theirs)
        raws = rng.uniform(0, 1, (4, 4)).astype(np.float32)
        _dispatch(mine, theirs, raws, tid)
        assert mine.metrics["cold_miss_stalls"] == 0
        assert mine.metrics["victim_hits"] == 4
        assert mine.prefetch(tid) == theirs.prefetch(tid) == 0

    def test_promotion_moves_hot_tenants_to_hot_slots(self):
        rng = np.random.default_rng(8)
        mine, theirs, _ = _pair(rng, t=32, hot=4, victims=2)
        hot = np.repeat(np.array([5, 6, 7, 8]), 8)
        raws = rng.uniform(0, 1, (len(hot), 4)).astype(np.float32)
        _dispatch(mine, theirs, raws, hot)
        assert mine.rebalance() == theirs.rebalance()
        assert set(mine.hot_rows()) == {5, 6, 7, 8}
        shifted = np.repeat(np.array([1, 2, 3, 4]), 8)
        for _ in range(40):
            _dispatch(mine, theirs, raws, shifted)
            assert mine.rebalance() == theirs.rebalance()
        assert set(mine.hot_rows()) == {1, 2, 3, 4}
        assert mine.metrics["demotions"] >= 4

    def test_empty_window_is_noop(self):
        mine, theirs, _ = _pair(np.random.default_rng(9), t=8)
        out, gen = mine.dispatch(np.empty((0, 4), np.float32),
                                 np.empty(0, np.int64))
        assert out.shape == (0,) and gen == 0
        assert mine.metrics["dispatches"] == 0
        assert mine.prefetch(np.empty(0, np.int64)) == 0

    def test_multipass_pad_slot_eviction_parity(self):
        """The pad of a bucketed slot vector repeats the LAST event's slot,
        which may be a live victim slot; a later pass of the same window may
        evict it (protection is rebuilt from the unpadded slots)."""
        rng = np.random.default_rng(11)
        mine, theirs, _ = _pair(rng, t=8, hot=1, victims=2)
        seen = []
        orig = mine._score_slots

        def spy(raws, slots, view):
            seen.append((np.asarray(slots).copy(), mine._owner.copy()))
            return orig(raws, slots, view)

        mine._score_slots = spy
        tid = np.array([0, 0, 1, 2, 3])
        raws = rng.uniform(0, 1, (5, 4)).astype(np.float32)
        _dispatch(mine, theirs, raws, tid)
        assert mine.metrics["extra_passes"] >= 1 and len(seen) >= 2
        slots0, _ = seen[0]
        assert len(slots0) == 3
        pad_slot = int(slots0[-1])
        assert mine.hot_capacity <= pad_slot < mine.hot_capacity + 2
        owners = [own[pad_slot] for _, own in seen]
        assert any(o != owners[0] for o in owners[1:])

    @pytest.mark.parametrize("seed", range(4))
    def test_random_schedule_matches_reference(self, seed):
        """Random dispatch / rebalance / publish / mark-cold / prefetch
        schedules: after every step the port's state equals the JAX
        store's, and every window is bitwise the dense bank of the host
        rows (the prior row for un-admitted tenants)."""
        rng = np.random.default_rng(seed)
        t, k, n = 24, 2, 16
        admitted = rng.random(t) > 0.25
        mine, theirs, _ = _pair(
            rng, t=t, hot=int(rng.integers(2, 8)),
            victims=int(rng.integers(2, 5)), admitted=admitted, k=k, n=n)
        prior = _view_rows(mine)
        for _ in range(30):
            op = rng.integers(0, 5)
            if op == 0:
                b = int(rng.integers(1, 12))
                tid = rng.integers(0, t, b)
                raws = rng.uniform(0, 1, (b, k)).astype(np.float32)
                adm = mine.host.admitted[tid].copy()
                got, gen = mine.dispatch(raws, tid)
                jgot, jgen = theirs.dispatch(raws, tid)
                host = (mine.host.betas, mine.host.weights,
                        mine.host.src_quantiles, mine.host.ref_quantiles)
                # admitted rows: their host row; the rest: the prior row
                want = np.where(
                    adm, _dense(host, raws, np.where(adm, tid, 0)),
                    _dense(tuple(r[-1:] for r in prior), raws,
                           np.zeros(b, np.int64)))
                assert _bitwise(got, want) and gen == jgen
                np.testing.assert_allclose(got, np.asarray(jgot), **TOL)
            elif op == 1:
                assert mine.rebalance() == theirs.rebalance()
            elif op == 2:
                rows = rng.choice(t, size=int(rng.integers(1, 5)),
                                  replace=False)
                tables = {int(r): (np.sort(rng.uniform(0, 1, n)).astype(
                    np.float32), np.sort(rng.uniform(0, 1, n)).astype(
                        np.float32)) for r in rows}
                assert mine.apply_updates(
                    {r: QuantileMap(torch.tensor(s), torch.tensor(q))
                     for r, (s, q) in tables.items()}) == \
                    theirs.apply_updates(
                        {r: JQM(jnp.asarray(s), jnp.asarray(q))
                         for r, (s, q) in tables.items()})
            elif op == 3:
                row = [int(rng.integers(0, t))]
                mine.mark_cold(row)
                theirs.mark_cold(row)
            else:
                tid = rng.integers(0, t, 6)
                assert mine.prefetch(tid) == theirs.prefetch(tid)
            _same_state(mine, theirs)
            owners = mine._owner[mine._owner >= 0]
            assert len(owners) == len(set(owners.tolist()))
            for row in owners:
                assert mine._owner[mine._slot_of[row]] == row

    @pytest.mark.parametrize("size", [(0, 1_024), (1, 10_000)])
    def test_benchmark_stalls_match_reference(self, size):
        """The tiered benchmark's sequence at its first two sizes, at its
        full sizes (as the card runs it), on the port's store and on the JAX store over the same
        rows and windows: every counter equal, so the events that still
        stall after the prefetch (rows the window's own prefetch evicted)
        are the reference's policy, not the port's."""
        from repro_torch.benchmarks import bench_tiered_bank as bench

        i, t = size
        inputs = bench.size_inputs(i, t, 8192, 2048, 4)
        host = inputs["host"]
        cfg = dict(hot_capacity=bench.HOT, victim_capacity=bench.VICTIMS)
        mine = TieredBankStore(host, TieringConfig(**cfg), device="cpu")
        theirs = jtier.TieredBankStore(
            jtier.HostBankStore(host.betas, host.weights, host.src_quantiles,
                                host.ref_quantiles),
            jtier.TieringConfig(**cfg, fused_kernel=False))
        got = bench.size_run(mine, inputs, repeat=10)
        want = bench.size_run(theirs, inputs, repeat=10)
        _same_state(mine, theirs)
        for key in ("stall_rate_mixed", "stall_rate_prefetched"):
            assert got[key] == want[key]
        assert 0 < got["stall_rate_prefetched"] < got["stall_rate_mixed"]


# --------------------------------------------------------------------------
# overlapped staging and immutable views
# --------------------------------------------------------------------------

class TestOverlappedStaging:
    def test_dispatch_proceeds_while_prefetch_copy_in_flight(self,
                                                             monkeypatch):
        rng = np.random.default_rng(12)
        mine, _, rows = _pair(rng, t=16, hot=2, victims=4)
        mine.prefetch(np.array([1, 2]))
        orig = TieredBankStore._staged_view
        started, release = threading.Event(), threading.Event()

        def slow(self, view, slots, take):
            started.set()
            assert release.wait(timeout=30)
            return orig(self, view, slots, take)

        monkeypatch.setattr(TieredBankStore, "_staged_view", slow)
        result: dict = {}
        th = threading.Thread(
            target=lambda: result.update(n=mine.prefetch(np.array([5, 6]))))
        th.start()
        try:
            assert started.wait(timeout=30)
            tid = np.array([1, 2, 1])
            raws = rng.uniform(0, 1, (3, 4)).astype(np.float32)
            got, _ = mine.dispatch(raws, tid)   # the lock is free
            assert _bitwise(got, _dense(rows, raws, tid))
        finally:
            release.set()
            th.join(timeout=30)
        assert result["n"] == 2
        assert mine.metrics["staging_conflicts"] == 0
        assert {5, 6} <= set(mine.resident_rows())

    def test_conflicting_publish_invalidates_staged_view(self, monkeypatch):
        rng = np.random.default_rng(13)
        mine, theirs, _ = _pair(rng, t=16, hot=2, victims=4)
        src = np.sort(rng.uniform(0, 1, 32)).astype(np.float32)
        dst = (np.linspace(0.0, 1.0, 32) ** 2).astype(np.float32)
        for store, cls, qm in (
                (mine, TieredBankStore,
                 QuantileMap(torch.tensor(src), torch.tensor(dst))),
                (theirs, jtier.TieredBankStore,
                 JQM(jnp.asarray(src), jnp.asarray(dst)))):
            orig = cls._staged_view
            fired: list[int] = []

            def hostile(self, view, slots, take, store=store, qm=qm,
                        orig=orig, fired=fired):
                if not fired:
                    fired.append(1)
                    store.apply_updates({5: qm})
                return orig(self, view, slots, take)

            monkeypatch.setattr(cls, "_staged_view", hostile)
            assert store.prefetch(np.array([5, 6])) == 2   # restaged
        assert mine.metrics["staging_conflicts"] == 1
        _same_state(mine, theirs)
        tid = np.array([5, 6])
        raws = rng.uniform(0, 1, (2, 4)).astype(np.float32)
        monkeypatch.undo()
        got = _dispatch(mine, theirs, raws, tid)
        assert mine.metrics["cold_miss_stalls"] == 0 and len(got) == 2

    def test_mark_cold_during_copy_vetoes_commit(self, monkeypatch):
        rng = np.random.default_rng(14)
        mine, theirs, _ = _pair(rng, t=16, hot=2, victims=4)
        for store, cls in ((mine, TieredBankStore),
                           (theirs, jtier.TieredBankStore)):
            orig = cls._staged_view
            fired: list[int] = []

            def hostile(self, view, slots, take, store=store, orig=orig,
                        fired=fired):
                if not fired:
                    fired.append(1)
                    store.mark_cold([5])
                return orig(self, view, slots, take)

            monkeypatch.setattr(cls, "_staged_view", hostile)
            assert store.prefetch(np.array([5])) == 0
        assert mine.metrics["staging_conflicts"] == 1
        assert 5 not in set(mine.resident_rows())
        _same_state(mine, theirs)

    def test_locked_staging_still_correct(self):
        rng = np.random.default_rng(15)
        mine, theirs, _ = _pair(rng, t=16, hot=2, victims=4,
                                overlap_staging=False)
        tid = np.array([3, 4, 5])
        assert mine.prefetch(tid) == theirs.prefetch(tid) == 3
        raws = rng.uniform(0, 1, (4, 4)).astype(np.float32)
        _dispatch(mine, theirs, raws, np.array([3, 4, 5, 3]))
        assert mine.metrics["cold_miss_stalls"] == 0
        assert mine.metrics["staging_conflicts"] == 0

    def test_concurrent_prefetch_and_dispatch_stress(self):
        """Four prefetching threads and two dispatching ones on one store,
        the interpreter switching threads every 10 us: every window is
        bitwise the dense bank's, the slot maps stay a bijection, and no
        counter loses an update (every staged row is a stall or a
        prefetch; every event is counted)."""
        import sys
        rng = np.random.default_rng(17)
        mine, _, rows = _pair(rng, t=256, hot=8, victims=16)
        mine.tracker.record(np.arange(8))
        mine.rebalance()
        picks = [rng.integers(0, 256, 12) for _ in range(64)]
        windows = [(rng.uniform(0, 1, (40, 4)).astype(np.float32),
                    np.where(rng.random(40) < 0.7, rng.integers(0, 8, 40),
                             rng.integers(0, 256, 40))) for _ in range(120)]
        stop, errors, done = threading.Event(), [], []

        def prefetcher(k):
            i = k
            while not stop.is_set():
                mine.prefetch(picks[i % len(picks)])
                i += 4

        def dispatcher(k):
            try:
                for raws, tid in windows[k::2]:
                    got, _ = mine.dispatch(raws, tid)
                    assert _bitwise(got, _dense(rows, raws, tid))
                    done.append(len(tid))
            except BaseException as e:  # noqa: BLE001 — reported below
                errors.append(e)

        before = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            threads = [threading.Thread(target=prefetcher, args=(k,))
                       for k in range(4)]
            workers = [threading.Thread(target=dispatcher, args=(k,))
                       for k in range(2)]
            for th in threads + workers:
                th.start()
            for th in workers:
                th.join(timeout=60)
            stop.set()
            for th in threads:
                th.join(timeout=60)
        finally:
            stop.set()
            sys.setswitchinterval(before)
        assert not any(th.is_alive() for th in threads + workers)
        assert not errors, errors[:1]
        m = mine.metrics
        assert len(done) == len(windows)
        assert m["dispatches"] == len(windows) and m["events"] == sum(done)
        assert m["staged_rows"] == m["cold_miss_stalls"] + \
            m["prefetched_rows"]
        assert m["prefetched_rows"] > 0 and not mine._staging
        owners = mine._owner[mine._owner >= 0]
        assert len(owners) == len(set(owners.tolist()))
        for row in owners:
            assert mine._owner[mine._slot_of[row]] == row
        assert (mine._slot_of >= 0).sum() == len(owners)

    def test_views_are_never_written_in_place(self):
        """Staging, promotion and publishes build NEW tensors: a view a
        dispatch captured keeps its bits, whatever lands after it."""
        rng = np.random.default_rng(16)
        mine, _, _ = _pair(rng, t=16, hot=3, victims=2)
        old = mine._view
        before = [x.clone() for x in (old.betas, old.weights,
                                      old.src_quantiles, old.ref_quantiles)]
        raws = rng.uniform(0, 1, (8, 4)).astype(np.float32)
        mine.dispatch(raws, np.arange(8))                  # staging passes
        mine.prefetch(np.array([9, 10]))
        mine.rebalance()                                   # promotion
        mine.apply_updates({1: QuantileMap.identity(32)})  # publish
        assert mine._view is not old
        after = (old.betas, old.weights, old.src_quantiles,
                 old.ref_quantiles)
        assert all(torch.equal(a, b) for a, b in zip(before, after))
        # a publish shares the untouched betas/weights with the old view
        v = mine._view
        mine.apply_updates({2: QuantileMap.identity(32)})
        assert mine._view.betas is v.betas
        assert mine._view.src_quantiles is not v.src_quantiles


# --------------------------------------------------------------------------
# publish, fencing, cold start
# --------------------------------------------------------------------------

class TestTieredPublish:
    def test_publish_updates_hot_and_cold_rows_atomically(self):
        rng = np.random.default_rng(10)
        mine, theirs, rows = _pair(rng, t=16, hot=4, victims=2)
        hot = np.repeat(np.array([0, 1, 2, 3]), 4)
        raws16 = rng.uniform(0, 1, (16, 4)).astype(np.float32)
        _dispatch(mine, theirs, raws16, hot)
        assert mine.rebalance() == theirs.rebalance()
        tables = {r: (np.sort(rng.uniform(0, 1, 32)).astype(np.float32),
                      np.sort(rng.uniform(0, 1, 32)).astype(np.float32))
                  for r in (1, 9)}                    # one hot, one cold
        assert mine.apply_updates(
            {r: QuantileMap(torch.tensor(s), torch.tensor(q))
             for r, (s, q) in tables.items()}) == 1
        theirs.apply_updates({r: JQM(jnp.asarray(s), jnp.asarray(q))
                              for r, (s, q) in tables.items()})
        new = TransformBank(*(torch.tensor(r) for r in rows)).with_rows(
            {r: QuantileMap(torch.tensor(s), torch.tensor(q))
             for r, (s, q) in tables.items()}, generation=1)
        tid = np.array([1, 9, 1, 9, 4, 0])
        raws = rng.uniform(0, 1, (6, 4)).astype(np.float32)
        got = _dispatch(mine, theirs, raws, tid, want_rows=tuple(
            x.numpy() for x in (new.betas, new.weights, new.src_quantiles,
                                new.ref_quantiles)))
        assert mine.generation == 1 and len(got) == 6

    def test_fenced_publish_and_rebalance_fencing(self):
        from repro.serving.types import StaleGenerationError as JStale
        mine, theirs, _ = _pair(np.random.default_rng(11), t=8)
        for store, stale in ((mine, StaleGenerationError), (theirs, JStale)):
            assert store.apply_updates({}, generation=5) == 5
            with pytest.raises(stale):
                store.apply_updates({}, generation=5)
            with pytest.raises(stale):
                store.rebalance(generation=4)
            store.rebalance(generation=5)
            assert store.apply_updates({}) == 5
        with pytest.raises(StaleGenerationError):
            mine.apply_updates({0: QuantileMap.identity(32)}, generation=3)
        _same_state(mine, theirs)

    def test_mark_cold_evicts_and_routes_through_prior(self):
        rng = np.random.default_rng(13)
        prior_src = np.sort(rng.uniform(0, 1, 32))
        prior = prior_bank_row(prior_src, np.linspace(0, 1, 32), 4)
        jprior = jtier.prior_bank_row(prior_src, np.linspace(0, 1, 32), 4)
        assert all(_bitwise(a, b) for a, b in zip(prior, jprior))
        mine, theirs, _ = _pair(rng, t=8, hot=4, victims=2, prior=prior)
        raws = rng.uniform(0, 1, (8, 4)).astype(np.float32)
        tid = np.full(8, 2)
        _dispatch(mine, theirs, raws, tid)
        assert mine.rebalance() == theirs.rebalance()
        assert 2 in mine.hot_rows()
        mine.mark_cold([2])
        theirs.mark_cold([2])
        assert 2 not in mine.resident_rows()
        got, _ = mine.dispatch(raws, tid)
        jgot, _ = theirs.dispatch(raws, tid)
        want = _dense(tuple(r[None] for r in prior), raws, np.zeros(8))
        assert _bitwise(got, want)
        np.testing.assert_allclose(got, np.asarray(jgot), **TOL)
        assert mine.metrics["prior_scores"] >= 8
        _same_state(mine, theirs)
        # pre_quantile through the prior row, the reference's arithmetic
        assert _bitwise(mine.pre_quantile(raws, tid),
                        np.asarray(theirs.pre_quantile(raws, tid)))


class TestColdStartIntegration:
    def test_new_tenant_scores_through_fitted_prior_then_promotes(self):
        from repro.core.coldstart import BetaMixtureFit as JFit
        rng = np.random.default_rng(14)
        fit = dict(w=0.15, a0=2.0, b0=9.0, a1=7.0, b1=2.0, jsd=0.0,
                   moment_loss=0.0)
        ref = np.linspace(0.0, 1.0, 32) ** 1.5
        prior = prior_bank_row(BetaMixtureFit(**fit), ref, num_experts=4)
        jprior = jtier.prior_bank_row(JFit(**fit), ref, num_experts=4)
        assert all(_bitwise(a, b) for a, b in zip(prior, jprior))
        admitted = np.ones(8, bool)
        admitted[5] = False
        mine, theirs, rows = _pair(rng, t=8, hot=4, victims=2,
                                   admitted=admitted, prior=prior)
        assert mine.gate_samples == required_sample_size(0.5, 1.0) == \
            theirs.gate_samples
        raws = rng.uniform(0, 1, (2, 4)).astype(np.float32)
        tid = np.full(2, 5)
        # every row the prior's: tenant 5 scores through the prior slot
        prior_rows = tuple(np.repeat(r[None], 8, 0) for r in prior)
        for _ in range(2):                 # 2, then 4 events (== gate)
            _dispatch(mine, theirs, raws, tid, want_rows=prior_rows)
            assert mine.rebalance() == theirs.rebalance()
        assert mine.metrics["admissions"] == 1
        assert 5 in mine.hot_rows()
        _dispatch(mine, theirs, raws, tid)       # its own row now

    def test_prior_row_from_raw_table_interpolates(self):
        src = np.sort(np.random.default_rng(15).uniform(0, 1, 16))
        b, w, s, r = prior_bank_row(src, np.linspace(0, 1, 32), 3)
        jb, jw, js, jr = jtier.prior_bank_row(src, np.linspace(0, 1, 32), 3)
        assert b.shape == (3,) and s.shape == (32,) and r.shape == (32,)
        assert np.all(np.diff(s) >= 0)
        assert all(_bitwise(a, c) for a, c in ((b, jb), (w, jw), (s, js),
                                               (r, jr)))


# --------------------------------------------------------------------------
# the tiered server
# --------------------------------------------------------------------------

def _linear(seed):
    w = np.random.default_rng(seed).normal(0, 1, DIM).astype(np.float32)
    return lambda x: 1.0 / (1.0 + np.exp(-(np.asarray(x, np.float32) @ w)))


FACTORIES = {f"m{i}": (lambda i=i: _linear(i)) for i in (1, 2)}


def _jlinear(seed):
    f = _linear(seed)
    return lambda x: jnp.asarray(f(x))


JFACTORIES = {f"m{i}": (lambda i=i: _jlinear(i)) for i in (1, 2)}
TIER = dict(hot_capacity=3, victim_capacity=2, **EASY_GATE)


def _server(n=4, tiering=True, version="v1", **config):
    """A port server: one predictor per tenant over {m1, m2}."""
    rules = tuple(ScoringRule(Condition(tenants=(f"t{i}",)), f"p{i}")
                  for i in range(n)) + (ScoringRule(Condition(), "p0"),)
    server = MuseServer(
        RoutingTable(rules, version=version),
        ServerConfig(refresh_alert_rate=0.05, refresh_rel_error=0.5,
                     tiering=TieringConfig(**TIER) if tiering is True
                     else tiering or None, **config), device="cpu")
    for i in range(n):
        server.deploy(PredictorSpec(f"p{i}", ("m1", "m2"), (0.2, 0.4),
                                    (1.0, 1.0), QuantileMap.identity(64)),
                      FACTORIES)
    return server


def _jserver(n=4, version="v1"):
    """The JAX twin of a tiered :func:`_server`, jnp oracle throughout."""
    rules = tuple(JRule(JCond(tenants=(f"t{i}",)), f"p{i}")
                  for i in range(n)) + (JRule(JCond(), "p0"),)
    server = JServer(
        JTable(rules, version=version),
        JConfig(refresh_alert_rate=0.05, refresh_rel_error=0.5,
                fused_kernel=False,
                tiering=jtier.TieringConfig(fused_kernel=False, **TIER)))
    for i in range(n):
        server.deploy(JSpec(f"p{i}", ("m1", "m2"), (0.2, 0.4), (1.0, 1.0),
                            JQM.identity(64)), JFACTORIES)
    return server


def _req(tenant, seed):
    x = np.random.default_rng(seed).normal(0, 1, DIM).astype(np.float32)
    return ScoringRequest(intent=Intent(tenant=tenant), features=x)


def _jreq(tenant, seed):
    x = np.random.default_rng(seed).normal(0, 1, DIM).astype(np.float32)
    return JRequest(intent=JIntent(tenant=tenant), features=x)


def _reqs(specs):
    return [_req(t, s) for t, s in specs], [_jreq(t, s) for t, s in specs]


def _same_server(mine, theirs):
    assert mine.tier_metrics() == theirs.tier_metrics()
    assert mine.bank_generation == theirs.bank_generation
    assert mine.metrics == theirs.metrics
    for key, store in mine.tiered_stores().items():
        _same_state(store, theirs.tiered_stores()[key])


class TestTieredServer:
    def test_scores_match_dense_server_and_reference(self):
        dense, tiered, jtiered = _server(4, False), _server(4), _jserver(4)
        reqs, jreqs = _reqs([(f"t{i % 4}", i) for i in range(12)])
        rd, rt = dense.score_batch(reqs), tiered.score_batch(reqs)
        rj = jtiered.score_batch(jreqs)
        assert [r.score for r in rd] == [r.score for r in rt]
        np.testing.assert_allclose([r.score for r in rt],
                                   [r.score for r in rj], **TOL)
        assert {r.bank_generation for r in rt} == {0}
        assert tiered.metrics["tier_dispatches"] >= 1
        assert tiered.tier_metrics()["events"] == 12
        _same_server(tiered, jtiered)

    def test_publish_then_parity_and_generation_stamp(self):
        rng = np.random.default_rng(16)
        dense, tiered, jtiered = _server(4, False), _server(4), _jserver(4)
        reqs, jreqs = _reqs([(f"t{i % 4}", i) for i in range(8)])
        for s, r in ((dense, reqs), (tiered, reqs), (jtiered, jreqs)):
            s.score_batch(r)
        src = np.sort(rng.uniform(0, 1, 64)).astype(np.float32)
        qm = QuantileMap(torch.tensor(src), torch.tensor(REF64,
                                                         dtype=torch.float32))
        jqm = JQM(jnp.asarray(src), jnp.asarray(REF64, jnp.float32))
        assert dense.publish_quantile_maps({"p1": qm, "p3": qm}) == 1
        assert tiered.publish_quantile_maps({"p1": qm, "p3": qm}) == 1
        assert jtiered.publish_quantile_maps({"p1": jqm, "p3": jqm}) == 1
        rd, rt = dense.score_batch(reqs), tiered.score_batch(reqs)
        rj = jtiered.score_batch(jreqs)
        assert [r.score for r in rd] == [r.score for r in rt]
        np.testing.assert_allclose([r.score for r in rt],
                                   [r.score for r in rj], **TOL)
        assert {r.bank_generation for r in rt} == {1}
        _same_server(tiered, jtiered)

    def test_fenced_publish_fast_forwards_tiered_stores(self):
        tiered = _server(2)
        tiered.score_batch([_req("t0", 0)])
        tiered.publish_quantile_maps({}, generation=7)
        (store,) = tiered.tiered_stores().values()
        assert store.generation == 7
        assert tiered.score_batch([_req("t0", 1)])[0].bank_generation == 7
        with pytest.raises(StaleGenerationError):
            tiered.publish_quantile_maps({}, generation=7)

    def test_decommission_drops_group_stores(self):
        tiered = _server(2)
        tiered.score_batch([_req("t0", 0)])
        assert tiered.tiered_stores()
        tiered.decommission("p0")
        tiered.decommission("p1")
        assert not tiered.tiered_stores()

    def test_mark_cold_tenants_routes_through_prior(self):
        prior = prior_bank_row(np.linspace(0, 1, 64) ** 2, REF64, 2)
        cfg = TieringConfig(hot_capacity=3, victim_capacity=2, prior=prior,
                            **EASY_GATE)
        tiered, dense, oracle = _server(4, cfg), _server(4, False), \
            _server(4, False)
        oracle.deploy(PredictorSpec(
            "p2", ("m1", "m2"), (1.0, 1.0), (1.0, 1.0),
            QuantileMap(torch.tensor(prior[2]), torch.tensor(prior[3]))),
            FACTORIES)
        tiered.mark_cold_tenants(["p2"])
        reqs = [_req("t2", seed=i) for i in range(3)]
        rt, ro, rd = (s.score_batch(list(reqs))
                      for s in (tiered, oracle, dense))
        for a, b, c in zip(rt, ro, rd):
            assert a.score == b.score         # the prior row, bitwise
            assert a.score != c.score
        assert ("t2", "p2") in tiered.estimator_streams()

    def test_server_prefetch_endpoint(self):
        tiered, jtiered = _server(4), _jserver(4)
        reqs, jreqs = _reqs([(f"t{i}", i) for i in range(4)])
        tiered.score_batch(reqs)
        jtiered.score_batch(jreqs)
        assert tiered.prefetch_enabled and not _server(2, False)\
            .prefetch_enabled
        names = ["p0", "p1", "p2", "p3"]
        for _ in range(2):
            assert tiered.prefetch_transforms(names, create=False) == \
                jtiered.prefetch_transforms(names, create=False) == 2
        (store,) = tiered.tiered_stores().values()
        assert store.metrics["prefetched_rows"] == 4
        assert tiered.prefetch_transforms(["p0"], create=False) == 0
        _same_server(tiered, jtiered)

    def test_device_tracking_counts_tiered_windows(self):
        """Fused device tracking on a tiered server stages the host-side
        aggregate (``append_agg``): every event counted, the estimators
        bitwise those of eager tracking on a tiered twin."""
        eager, fused = _server(4), _server(4, track_device=True)
        windows = [[_req(f"t{(w + i) % 4}", 40 * w + i) for i in range(10)]
                   for w in range(5)]
        for reqs in windows:
            a, b = eager.score_batch(reqs), fused.score_batch(reqs)
            assert [r.score for r in a] == [r.score for r in b]
        assert fused.metrics["track_staged_windows"] == 5
        assert fused._tracker.pending_total() == 50
        want = eager.snapshot_estimator_checkpoints()
        got = fused.snapshot_estimator_checkpoints()
        assert want.keys() == got.keys()
        for key, (arrays, meta) in want.items():
            assert got[key][1] == meta
            assert _bitwise(got[key][0]["buf"][:meta["filled"]],
                            arrays["buf"][:meta["filled"]])


# --------------------------------------------------------------------------
# calibration through the tiers
# --------------------------------------------------------------------------

def _inject(server, tenant, pred, samples, seed, estimator):
    est = estimator(capacity=65536, seed=seed)
    est.update(samples)
    server._estimators[(tenant, pred)] = est


def _policy(mod, **kw):
    return mod(**{**dict(alert_rate=0.05, rel_error=0.5, n_levels=64), **kw})


class TestTieredCalibrationRefresh:
    def test_refresh_updates_hot_cold_and_promotes_admitted(self):
        rng = np.random.default_rng(17)
        gate = required_sample_size(0.05, 0.5)
        dense, tiered, jtiered = _server(3, False), _server(3), _jserver(3)
        for i in range(3):
            samples = rng.uniform(0, 1, gate + 50)
            _inject(dense, f"t{i}", f"p{i}", samples, i,
                    StreamingQuantileEstimator)
            _inject(tiered, f"t{i}", f"p{i}", samples, i,
                    StreamingQuantileEstimator)
            _inject(jtiered, f"t{i}", f"p{i}", samples, i, JEstimator)
        reqs, jreqs = _reqs([(f"t{i % 3}", i) for i in range(9)])
        dense.score_batch(reqs)
        tiered.score_batch(reqs)
        jtiered.score_batch(jreqs)
        rd = CalibrationController(dense, REF64,
                                   _policy(RefreshPolicy)).refresh_fleet()
        rt = CalibrationController(tiered, REF64,
                                   _policy(RefreshPolicy)).refresh_fleet()
        rj = JCalibration(jtiered, REF64, _policy(JPolicy)).refresh_fleet()
        keys = {(r.tenant, r.predictor) for r in rt.refreshed}
        assert keys and keys == {(r.tenant, r.predictor)
                                 for r in rd.refreshed} \
            == {(r.tenant, r.predictor) for r in rj.refreshed}
        assert tiered.bank_generation == dense.bank_generation == \
            jtiered.bank_generation
        out_d, out_t = dense.score_batch(reqs), tiered.score_batch(reqs)
        out_j = jtiered.score_batch(jreqs)
        assert [r.score for r in out_d] == [r.score for r in out_t]
        np.testing.assert_allclose([r.score for r in out_t],
                                   [r.score for r in out_j], **TOL)
        (store,) = tiered.tiered_stores().values()
        assert store.metrics["promotions"] >= 1
        _same_server(tiered, jtiered)

    def test_fleet_publish_lands_in_both_tiers_of_every_replica(self):
        rng = np.random.default_rng(18)
        gate = required_sample_size(0.05, 0.5)
        reps = [Replica(i, _server(3), "v1", ready=True) for i in range(2)]
        reqs = [_req(f"t{i % 3}", seed=i) for i in range(9)]
        for rep in reps:
            rep.server.score_batch(list(reqs))
            for i in range(3):
                _inject(rep.server, f"t{i}", f"p{i}",
                        rng.uniform(0, 1, gate // 2 + 40), i,
                        StreamingQuantileEstimator)
        res = FleetCalibrationController(
            ReplicaSet(reps), REF64, _policy(RefreshPolicy)).refresh_fleet()
        assert res.refreshed and not res.nacked
        gens = {rep.server.bank_generation for rep in reps}
        assert len(gens) == 1
        gen = gens.pop()
        outs = [rep.server.score_batch(list(reqs)) for rep in reps]
        for a, b in zip(*outs):
            assert a.score == b.score and a.bank_generation == gen
        for rep in reps:
            (store,) = rep.server.tiered_stores().values()
            assert store.generation == gen


# --------------------------------------------------------------------------
# the async engine's prefetch
# --------------------------------------------------------------------------

class TestEnginePrefetch:
    def test_poll_prefetches_pending_window_rows(self):
        tiered = _server(4)
        tiered.score_batch([_req(f"t{i}", i) for i in range(4)])
        (store,) = tiered.tiered_stores().values()
        base = store.metrics["prefetched_rows"]
        engine = AsyncDispatchEngine(tiered, max_batch=64, max_wait_ms=1e9)
        assert engine._prefetchable
        try:
            futs = [engine.submit(_req(f"t{i % 4}", seed=i))
                    for i in range(8)]
            engine.poll()
            assert store.metrics["prefetched_rows"] > base
            engine.flush()
            scores = [f.result(timeout=60).score for f in futs]
        finally:
            engine.close()
        want = [r.score for r in _server(4, False).score_batch(
            [_req(f"t{i % 4}", seed=i) for i in range(8)])]
        assert scores == want

    def test_poll_counts_unexpected_prefetch_faults(self, monkeypatch):
        tiered = _server(4)
        tiered.score_batch([_req(f"t{i}", i) for i in range(4)])
        engine = AsyncDispatchEngine(tiered, max_batch=64, max_wait_ms=1e9)
        try:
            engine.submit(_req("t1", seed=0))

            def boom(names, plane=None, *, create=False):
                raise IndexError("torn store ref")

            monkeypatch.setattr(tiered, "prefetch_transforms", boom)
            engine.poll()
            assert engine.prefetch_errors == 1
            assert any(isinstance(e, IndexError) for _, e in engine.errors)
            monkeypatch.undo()
            engine.flush()
            engine.drain()
        finally:
            engine.close()

    def test_poll_ignores_expected_dispatch_race(self, monkeypatch):
        tiered = _server(4)
        tiered.score_batch([_req(f"t{i}", i) for i in range(4)])
        engine = AsyncDispatchEngine(tiered, max_batch=64, max_wait_ms=1e9)
        try:
            engine.submit(_req("t1", seed=0))

            def race(names, plane=None, *, create=False):
                raise KeyError("p1")

            monkeypatch.setattr(tiered, "prefetch_transforms", race)
            engine.poll()
            assert engine.prefetch_errors == 0 and not engine.errors
        finally:
            engine.close()

    def test_model_stage_prefetch_fault_counted_window_survives(
            self, monkeypatch):
        tiered = _server(4)
        real = tiered.prefetch_transforms
        mode = {"exc": ValueError("bad tenant id")}

        def flaky(names, plane=None, *, create=False):
            if create and mode["exc"] is not None:
                raise mode["exc"]
            return real(names, plane, create=create)

        monkeypatch.setattr(tiered, "prefetch_transforms", flaky)
        engine = AsyncDispatchEngine(tiered, max_batch=4, max_wait_ms=1e9)
        try:
            futs = [engine.submit(_req(f"t{i}", seed=i)) for i in range(4)]
            engine.flush()
            scores = [f.result(timeout=60).score for f in futs]
            assert engine.prefetch_errors == 1
            want = [r.score for r in _server(4, False).score_batch(
                [_req(f"t{i}", seed=i) for i in range(4)])]
            assert scores == want
            mode["exc"] = KeyError("p0")
            futs = [engine.submit(_req(f"t{i}", seed=10 + i))
                    for i in range(4)]
            engine.flush()
            for f in futs:
                f.result(timeout=60)
            assert engine.prefetch_errors == 1
        finally:
            engine.close()

    def test_engine_pipeline_stalls_only_before_prefetch_lands(self):
        tiered = _server(4)
        engine = AsyncDispatchEngine(tiered, max_batch=4, max_wait_ms=1e9)
        try:
            futs = [engine.submit(_req(f"t{i}", seed=i)) for i in range(4)]
            engine.flush()
            for f in futs:
                f.result(timeout=60)
            (store,) = tiered.tiered_stores().values()
            first = store.metrics["stalled_events"]
            tiered.rebalance_tiers()
            for batch in range(1, 4):
                futs = [engine.submit(_req(f"t{i}", seed=batch * 4 + i))
                        for i in range(4)]
                engine.flush()
                for f in futs:
                    f.result(timeout=60)
            assert store.metrics["stalled_events"] == first
            assert store.metrics["prefetched_rows"] >= 1
        finally:
            engine.close()


# --------------------------------------------------------------------------
# rollout warm start
# --------------------------------------------------------------------------

class TestRolloutWarmStart:
    def test_warm_tiers_from_adopts_hot_set(self):
        old = _server(4)
        reqs = [_req("t1", seed=i) for i in range(3)] + \
            [_req("t2", seed=i + 100) for i in range(3)] + \
            [_req("t0", seed=200), _req("t3", seed=201)]
        old.score_batch(list(reqs))
        old.rebalance_tiers()
        (old_store,) = old.tiered_stores().values()
        assert {1, 2} <= set(old_store.hot_rows())
        new = _server(4, version="v2")
        assert new.warm_tiers_from(old) == 1
        (new_store,) = new.tiered_stores().values()
        assert set(new_store.hot_rows()) == set(old_store.hot_rows())
        new.score_batch(list(reqs))
        assert new_store.metrics["hot_hits"] >= 6
        assert new_store.metrics["stalled_events"] <= 2
        assert _server(2, False).warm_tiers_from(old) == 0
        assert new.warm_tiers_from(_server(2, False)) == 0

    def test_rolling_update_warms_surged_replicas(self):
        def make(version):
            return _server(3, version=version)

        reps = [Replica(i, make("v1"), "v1", ready=True) for i in range(2)]
        rs = ReplicaSet(reps)
        seed_reqs = [_req(f"t{i % 3}", seed=i) for i in range(12)]
        for rep in reps:
            rep.server.score_batch(list(seed_reqs))
            rep.server.rebalance_tiers()
        update = RollingUpdate(rs, lambda: make("v2"), "v2",
                               schema_dim=DIM, warmup_batch_sizes=(1, 2))

        def traffic():
            i = 0
            while True:
                yield [_req(f"t{i % 3}", seed=i),
                       _req(f"t{(i + 1) % 3}", seed=i + 1)]
                i += 2

        update.run_with_traffic(traffic(), batches_per_transition=1)
        assert all(rep.version == "v2" for rep in rs.replicas)
        for rep in rs.replicas:
            stores = rep.server.tiered_stores()
            assert stores
            assert any(len(s.hot_rows()) >= 1 for s in stores.values())


def test_module_surface_matches_the_reference():
    """The port's tiering module exports the reference's single-store API
    (the sharded store waits for ROADMAP Queue 1 item 11)."""
    assert set(ttier.__all__) == {"HostBankStore", "TieredBankStore",
                                  "TieringConfig", "prior_bank_row"}
    assert ttier._shape_bucket(5) == jtier._shape_bucket(5) == 8
    assert not hasattr(ttier, "ShardedTieredBankStore")
    assert TieringConfig().__dict__ == jtier.TieringConfig().__dict__
    for bad in (dict(hot_capacity=0), dict(victim_capacity=0)):
        with pytest.raises(ValueError):
            TieringConfig(**bad)
