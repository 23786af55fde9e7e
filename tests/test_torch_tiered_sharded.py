"""Tiered over sharded: the port's ``ShardedTieredBankStore`` against its own
dense bank and against the JAX package's composed store.

Every shard of the tenant axis owns a bounded hot tier, victim cache and
prior row over its slice of the host rows, on its placement's device, and
one launch of the banked kernel a placement a pass scores the placement's
shards' slot-remapped buckets.  Inside the port, composed scores equal the
dense bank's and the pure-sharded dispatcher's BITWISE — cold, warm,
across multi-pass victim overflow, after prefetch, rebalance and publish —
on 1/2/4/8 shards over one placement and at S = 8 over 2, 4 and 8 CPU
placements.  Against the JAX package's
composed store fed the same windows, the per-shard slot maps, clock hands,
seen counts, admission, hot and resident rows, every counter (``metrics``
and ``joint_metrics``) and the lockstep generations are equal exactly, and
scores agree within 2e-5.  The JAX store takes ``dispatcher=``: a
stand-in whose ``run_packed`` runs the JAX oracle ``banked_score_pipeline``
shard by shard, so no mesh (and no Pallas kernel) is needed there.  The
serving layer composes end to end: the server, the async engine's
prefetch, and ``warm_tiers_from`` across topologies.  On the CPU ``ops``
runs the plain versions.
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.transforms import banked_score_pipeline as jbanked
from repro.serving import tiering as jtier
from repro_torch.core.transforms import QuantileMap, ShardedTransformBank, shard_rows
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_tenant_mesh
from repro_torch.serving import (
    AsyncDispatchEngine,
    ShardedBankDispatcher,
    StaleGenerationError,
)
from repro_torch.serving.tiering import (
    HostBankStore,
    ShardedTieredBankStore,
    TieredBankStore,
    TieringConfig,
)
from test_torch_tiering import EASY_GATE, TIER, _req, _server

TOL = dict(rtol=2e-5, atol=2e-5)
SHARD_COUNTS = (1, 2, 4, 8)
# each shard count over one placement under its old id, then S = 8 over
# 2, 4 and 8 CPU placements
PLACED = [*(pytest.param(s, 1, id=str(s)) for s in SHARD_COUNTS),
          *(pytest.param(8, p, id=f"8-p{p}") for p in (2, 4, 8))]


class _ShardLoop:
    """The JAX composed store's dispatcher: each shard's packed rows
    through the JAX oracle against that shard's stacked view."""

    def run_packed(self, packed, pidx, betas, weights, src, ref):
        return np.stack([np.asarray(jbanked(
            jnp.asarray(packed[s]), jnp.asarray(pidx[s]), betas[s],
            weights[s], src[s], ref[s])) for s in range(packed.shape[0])])


def _bitwise(a, b) -> bool:
    return np.array_equal(np.asarray(a, np.float32).view(np.uint32),
                          np.asarray(b, np.float32).view(np.uint32))


def _mono(rng, t, n) -> np.ndarray:
    q = np.cumsum(rng.uniform(1e-3, 1.0, (t, n)).astype(np.float32),
                  axis=1, dtype=np.float32)
    return q / q[:, -1:]


def _rows(rng, t, k=4, n=32):
    return (rng.uniform(0.05, 1.0, (t, k)).astype(np.float32),
            rng.uniform(0.1, 2.0, (t, k)).astype(np.float32),
            _mono(rng, t, n), _mono(rng, t, n))


def _cfg(hot=4, victims=2, **kw) -> dict:
    return dict(hot_capacity=hot, victim_capacity=victims, **EASY_GATE, **kw)


def _pair(rng, t, s, *, hot=4, victims=2, shard_of=None, placements=1,
          **kw):
    """(port store over ``placements`` CPU placements, JAX store, rows)
    over the same host rows."""
    rows = _rows(rng, t)
    cfg = _cfg(hot, victims, **kw)
    mine = ShardedTieredBankStore(HostBankStore(*rows), s,
                                  TieringConfig(**cfg), shard_of=shard_of,
                                  device=["cpu"] * placements)
    theirs = jtier.ShardedTieredBankStore(
        jtier.HostBankStore(*rows), s,
        jtier.TieringConfig(**{**cfg, "fused_kernel": False}),
        dispatcher=_ShardLoop(), shard_of=shard_of)
    return mine, theirs, rows


def _dense(store, raws, tid) -> np.ndarray:
    bank = store.dense_bank(0, "cpu")
    return ops.score_pipeline_banked(
        torch.from_numpy(np.asarray(raws, np.float32)),
        torch.from_numpy(np.asarray(tid, np.int32)), bank.betas,
        bank.weights, bank.src_quantiles, bank.ref_quantiles).numpy()


def _same_state(mine, theirs) -> None:
    """Every discrete piece of composed state equal across the packages."""
    assert mine.metrics == theirs.metrics
    assert mine.joint_metrics == theirs.joint_metrics
    assert mine.generation == theirs.generation
    assert sorted(mine.hot_rows()) == sorted(theirs.hot_rows())
    assert sorted(mine.resident_rows()) == sorted(theirs.resident_rows())
    assert mine.device_bytes == theirs.device_bytes
    assert mine.host_bytes == theirs.host_bytes
    for a, b in zip(mine.shards, theirs.shards, strict=True):
        assert np.array_equal(a._slot_of, b._slot_of)
        assert np.array_equal(a._owner, b._owner)
        assert a._hand == b._hand
        assert np.array_equal(a._seen, b._seen)
        assert np.array_equal(a.host.admitted, b.host.admitted)
        assert a.metrics == b.metrics
        assert a.generation == b.generation == mine.generation
        assert np.array_equal(a.tracker.scores(), b.tracker.scores())


def _admitted(store) -> np.ndarray:
    adm = np.zeros(store.num_rows, bool)
    for s, sub in enumerate(store.shards):
        adm[store.global_of[s]] = sub.host.admitted
    return adm


def _dispatch(mine, theirs, raws, tid):
    """Both stores on one window: the port's admitted rows bitwise its
    dense bank, the JAX store's scores within 2e-5, the state equal."""
    got, gen = mine.dispatch(raws, tid)
    jgot, jgen = theirs.dispatch(raws, tid)
    mask = _admitted(mine)[np.asarray(tid)]
    assert _bitwise(got[mask], _dense(mine, raws, tid)[mask])
    np.testing.assert_allclose(got, jgot, **TOL)
    assert gen == jgen == mine.generation
    _same_state(mine, theirs)
    return got


# --------------------------------------------------------------------------
# store-level parity (dense, pure-sharded and the JAX store)
# --------------------------------------------------------------------------

class TestComposedParity:
    @pytest.mark.parametrize("s,placements", PLACED)
    def test_bitwise_parity_vs_dense_and_pure_sharded(self, s, placements):
        rng = np.random.default_rng(100 + s)
        t, k = 37, 4
        mine, theirs, _ = _pair(rng, t, s, placements=placements)
        assert mine.placements == (torch.device("cpu"),) * placements
        raws = rng.uniform(0, 1, (48, k)).astype(np.float32)
        tid = rng.integers(0, t, 48)
        want = _dense(mine, raws, tid)
        mesh = make_tenant_mesh(s, ["cpu"] * placements)
        dispatcher = ShardedBankDispatcher(mesh)
        sharded = ShardedTransformBank.from_dense(
            mine.dense_bank(0, "cpu"), s, placements=mesh.placements)
        assert _bitwise(dispatcher(raws, tid, sharded), want)
        # cold: every row pages through victim caches (multi-pass)
        got = _dispatch(mine, theirs, raws, tid)
        assert _bitwise(got, want)
        assert mine.metrics["cold_miss_stalls"] > 0
        # warm, then after a prefetch and a rebalance
        assert _bitwise(_dispatch(mine, theirs, raws, tid), want)
        assert mine.prefetch(tid) == theirs.prefetch(tid)
        assert mine.rebalance() == theirs.rebalance()
        _same_state(mine, theirs)
        assert _bitwise(_dispatch(mine, theirs, raws, tid), want)

    @pytest.mark.parametrize("s,placements", PLACED)
    def test_multipass_overflow_parity(self, s, placements):
        rng = np.random.default_rng(200 + s)
        t = 64
        mine, theirs, _ = _pair(rng, t, s, hot=2, victims=1,
                                placements=placements)
        tid = np.arange(t)
        raws = rng.uniform(0, 1, (t, 4)).astype(np.float32)
        _dispatch(mine, theirs, raws, tid)
        assert mine.metrics["extra_passes"] > 0

    def test_one_launch_a_pass(self, monkeypatch):
        """Each pass is ONE call of the kernel wrapper a placement, over
        that placement's stacked views: P times dispatches plus extra
        passes count the launches."""
        calls = []
        real = ops.score_pipeline_banked

        def spy(*args):
            calls.append((args[0].shape, args[2].data_ptr()))
            return real(*args)

        monkeypatch.setattr(ops, "score_pipeline_banked", spy)
        for placements in (1, 2, 4):
            rng = np.random.default_rng(5)
            mine, _, _ = _pair(rng, 40, 4, hot=2, victims=2,
                               placements=placements)
            calls.clear()
            for seed in range(3):
                tid = np.random.default_rng(seed).integers(0, 40, 64)
                mine.dispatch(np.full((64, 4), 0.5, np.float32), tid)
            m = mine.metrics
            assert len(calls) == \
                placements * (m["dispatches"] + m["extra_passes"])
            assert m["extra_passes"] > 0
            # the last pass read each placement's own cached stack
            stacks = mine._stacked
            assert [c[1] for c in calls[-placements:]] == \
                [st[0].data_ptr() for st in stacks]
            assert all(st[0].shape[0] == 4 // placements for st in stacks)

    def test_row_partition_matches_sharded_bank_rule(self):
        assign, local, counts = shard_rows(11, 4)
        rows = _rows(np.random.default_rng(3), 11)
        store = ShardedTieredBankStore(HostBankStore(*rows), 4,
                                       TieringConfig(**_cfg()),
                                       dispatcher=object(), device="cpu")
        theirs = jtier.ShardedTieredBankStore(
            jtier.HostBankStore(*rows), 4, jtier.TieringConfig(**_cfg()),
            dispatcher=object())
        for name, want in (("shard_of", assign), ("local_of", local),
                           ("row_counts", counts)):
            assert np.array_equal(getattr(store, name), want)
            assert np.array_equal(getattr(theirs, name), want)

    @pytest.mark.parametrize("s", (3, 4))
    def test_uneven_and_empty_shards(self, s):
        rng = np.random.default_rng(40 + s)
        t = 30
        assign = np.where(rng.random(t) < 0.8, 0, s - 1)   # middle empty
        mine, theirs, _ = _pair(rng, t, s, shard_of=assign)
        assert mine.row_counts[1] == 0
        for _ in range(3):
            tid = rng.integers(0, t, 40)
            raws = rng.uniform(0, 1, (40, 4)).astype(np.float32)
            _dispatch(mine, theirs, raws, tid)
            assert mine.rebalance() == theirs.rebalance()


# --------------------------------------------------------------------------
# per-shard residency bound
# --------------------------------------------------------------------------

class TestComposedResidency:
    def test_per_shard_device_bytes_independent_of_tenants(self):
        rng = np.random.default_rng(7)
        k, n, hot, victims = 4, 32, 4, 2
        one = (hot + victims + 1) * (2 * k + 2 * n) * 4
        sizes = set()
        for t in (16, 64, 256):
            store = ShardedTieredBankStore(
                HostBankStore(*_rows(rng, t, k, n)), 1,
                TieringConfig(**_cfg(hot, victims)), device="cpu")
            sizes.add(store.per_shard_device_bytes)
        assert sizes == {one}
        # a placement: (S/P)·(hot+victims+1)·(2K+2N)·4 at S = 8, once
        # every shard has its hot slots' worth of rows
        for t in (64, 256):
            for p in (1, 2, 4, 8):
                placed = ShardedTieredBankStore(
                    HostBankStore(*_rows(rng, t, k, n)), 8,
                    TieringConfig(**_cfg(hot, victims)), device=["cpu"] * p)
                assert placed.per_placement_device_bytes == 8 // p * one

    @pytest.mark.parametrize("s,placements", PLACED)
    def test_device_bytes_scale_with_shards_not_tenants(self, s, placements):
        rng = np.random.default_rng(8)
        mine, theirs, rows = _pair(rng, 61, s, placements=placements)
        assert mine.device_bytes == s * mine.per_shard_device_bytes \
            == theirs.device_bytes \
            == placements * mine.per_placement_device_bytes
        assert mine.host_bytes == HostBankStore(*rows).nbytes \
            == theirs.host_bytes
        # every shard's view on its placement's device
        per = s // placements
        for i, st in enumerate(mine.shards):
            assert st.device == mine.placements[i // per]
            assert st._view.betas.device == st.device

    def test_uneven_shards_share_hot_slot_count(self):
        store = ShardedTieredBankStore(
            HostBankStore(*_rows(np.random.default_rng(9), 5)), 4,
            TieringConfig(**_cfg(hot=8)), dispatcher=object(), device="cpu")
        assert len({st.hot_capacity for st in store.shards}) == 1
        assert len({st.device_bytes for st in store.shards}) == 1


# --------------------------------------------------------------------------
# fenced publish across shards
# --------------------------------------------------------------------------

def _qm(rng, n):
    src, ref = np.sort(rng.uniform(0, 1, n)), np.linspace(0, 1, n) ** 2
    return (QuantileMap(torch.tensor(src, dtype=torch.float32),
                        torch.tensor(ref, dtype=torch.float32)),
            jtier.QuantileMap(jnp.asarray(src, jnp.float32),
                              jnp.asarray(ref, jnp.float32)))


class TestComposedPublish:
    @pytest.mark.parametrize("s,placements", PLACED)
    def test_publish_lands_on_every_shard_under_one_generation(
            self, s, placements):
        rng = np.random.default_rng(11)
        t = 13
        mine, theirs, _ = _pair(rng, t, s, placements=placements)
        raws = rng.uniform(0, 1, (t, 4)).astype(np.float32)
        tid = np.arange(t)
        _dispatch(mine, theirs, raws, tid)         # rows device-resident
        pairs = {row: _qm(rng, 32) for row in range(0, t, 3)}
        assert mine.apply_updates({r: p[0] for r, p in pairs.items()}) == \
            theirs.apply_updates({r: p[1] for r, p in pairs.items()}) == 1
        assert all(st.generation == 1 for st in mine.shards)
        # bitwise against the dense bank of the updated host rows: hot
        # AND victim device copies were rescattered everywhere
        _dispatch(mine, theirs, raws, tid)

    def test_fenced_fast_forward_and_stale_rejection(self):
        mine, theirs, _ = _pair(np.random.default_rng(12), 13, 2)
        for store, stale in ((mine, StaleGenerationError),
                             (theirs, jtier.StaleGenerationError)):
            assert store.apply_updates({}, generation=5) == 5
            assert store.generation == 5
            assert all(st.generation == 5 for st in store.shards)
            assert store.apply_updates({}) == 5      # unfenced no-op
            with pytest.raises(stale):
                store.apply_updates({}, generation=5)
            with pytest.raises(stale):
                store.rebalance(generation=4)
            assert store.rebalance(generation=5)["generation"] == 5
            assert store.generation == 5              # rebalance never bumps
        _same_state(mine, theirs)

    def test_bad_update_touches_no_shard(self):
        rng = np.random.default_rng(13)
        mine, theirs, _ = _pair(rng, 6, 2)
        good = _qm(rng, 32)
        wide = _qm(rng, 64)
        for i, store in enumerate((mine, theirs)):
            before = [st.host.src_quantiles.copy() for st in store.shards]
            with pytest.raises(ValueError):
                store.apply_updates({0: good[i], 5: wide[i]})
            with pytest.raises(IndexError):
                store.apply_updates({99: good[i]})
            assert store.generation == 0
            for st, b in zip(store.shards, before):
                assert np.array_equal(st.host.src_quantiles, b)
        _same_state(mine, theirs)


# --------------------------------------------------------------------------
# property sweep: random op schedules, lockstep and equal to the JAX store
# --------------------------------------------------------------------------

class TestComposedScheduleProperty:
    @settings(max_examples=10, deadline=None)
    @given(st.integers(0, 2 ** 32 - 1), st.integers(1, 4))
    def test_random_schedule_lockstep_generations_and_parity(self, seed, s):
        rng = np.random.default_rng(seed)
        t = int(rng.integers(5, 24))
        mine, theirs, _ = _pair(rng, t, s, hot=3, victims=2)
        for _ in range(12):
            op = rng.choice(["dispatch", "prefetch", "rebalance",
                             "publish", "fenced", "mark_cold"])
            if op == "dispatch":
                b = int(rng.integers(1, 17))
                tid = rng.integers(0, t, b)
                raws = rng.uniform(0, 1, (b, 4)).astype(np.float32)
                _dispatch(mine, theirs, raws, tid)
            elif op == "prefetch":
                ids = rng.integers(0, t, 8)
                assert mine.prefetch(ids) == theirs.prefetch(ids)
            elif op == "rebalance":
                assert mine.rebalance() == theirs.rebalance()
            elif op == "publish":
                rows = rng.choice(t, rng.integers(1, 4), replace=False)
                pairs = {int(r): _qm(rng, 32) for r in rows}
                assert mine.apply_updates(
                    {r: p[0] for r, p in pairs.items()}) == \
                    theirs.apply_updates({r: p[1] for r, p in pairs.items()})
            elif op == "fenced":
                gen = mine.generation + 3
                assert mine.apply_updates({}, generation=gen) == \
                    theirs.apply_updates({}, generation=gen)
            else:
                row = int(rng.integers(0, t))
                mine.mark_cold([row])
                theirs.mark_cold([row])
            assert {st.generation for st in mine.shards} == {mine.generation}
            _same_state(mine, theirs)
            assert mine.hotness_snapshot()["seen"].tolist() == \
                theirs.hotness_snapshot()["seen"].tolist()
            row = int(rng.integers(0, t))
            assert mine.seen(row) == theirs.seen(row)


class TestComposedConcurrency:
    @pytest.mark.parametrize("overlap", (True, False))
    def test_prefetch_thread_against_dispatch_and_publish(self, overlap):
        """A thread prefetching per shard without pause, beside dispatches
        and publishes that take every shard's lock: no deadlock (lock
        order), every window bitwise the dense bank of its generation."""
        rng = np.random.default_rng(21)
        t, s = 48, 4
        mine, _, _ = _pair(rng, t, s, hot=2, victims=3,
                           overlap_staging=overlap)
        churn = [rng.integers(0, t, 16) for _ in range(64)]
        windows = [rng.integers(0, t, 32) for _ in range(30)]
        raws = rng.uniform(0, 1, (32, 4)).astype(np.float32)
        stop = threading.Event()

        def churner():
            i = 0
            while not stop.is_set():
                mine.prefetch(churn[i % len(churn)])
                i += 1

        th = threading.Thread(target=churner, daemon=True)
        th.start()
        try:
            for w, tid in enumerate(windows):
                if w % 10 == 5:
                    mine.apply_updates({int(tid[0]): _qm(rng, 32)[0]})
                got, gen = mine.dispatch(raws, tid)
                assert gen == mine.generation
                assert _bitwise(got, _dense(mine, raws, tid))
        finally:
            stop.set()
            th.join(timeout=60)
        assert not th.is_alive()
        assert mine.metrics["prefetched_rows"] > 0
        assert {st.generation for st in mine.shards} == {3}


# --------------------------------------------------------------------------
# serving layer: server, engine, rollout warm start
# --------------------------------------------------------------------------

def _composed_server(n=4, shards=2, tiering=True, placements=1):
    return _server(n, tiering=tiering, tenant_shards=shards,
                   device=["cpu"] * placements)


class TestComposedServing:
    @pytest.mark.parametrize("shards", SHARD_COUNTS)
    def test_server_parity_and_store_type(self, shards):
        comp, dense = _composed_server(8, shards), _server(8, False)
        sharded = _server(8, False, tenant_shards=shards)
        reqs = [_req(f"t{i % 8}", seed=i) for i in range(40)]
        rd, rc = dense.score_batch(reqs), comp.score_batch(reqs)
        rs = sharded.score_batch(reqs)
        for a, b, c in zip(rd, rc, rs):
            assert a.score == b.score == c.score
            assert a.bank_generation == b.bank_generation \
                == c.bank_generation == 0
        (store,) = comp.tiered_stores().values()
        want = ShardedTieredBankStore if shards > 1 else TieredBankStore
        assert type(store) is want
        assert comp.metrics["tier_dispatches"] == 1
        assert comp.metrics["shard_dispatches"] == (1 if shards > 1 else 0)
        if shards > 1:
            assert store.num_shards == shards

    def test_server_publish_parity_and_stamp(self):
        rng = np.random.default_rng(21)
        comp, dense = _composed_server(), _server(4, False)
        reqs = [_req(f"t{i % 4}", seed=i) for i in range(8)]
        comp.score_batch(reqs)
        dense.score_batch(reqs)
        qm = QuantileMap(
            torch.tensor(np.sort(rng.uniform(0, 1, 64)), dtype=torch.float32),
            torch.tensor(np.linspace(0.0, 1.0, 64) ** 2, dtype=torch.float32))
        assert dense.publish_quantile_maps({"p1": qm, "p2": qm}) == 1
        assert comp.publish_quantile_maps({"p1": qm, "p2": qm}) == 1
        for a, b in zip(dense.score_batch(reqs), comp.score_batch(reqs)):
            assert a.score == b.score
            assert b.bank_generation == 1
        assert comp.publish_quantile_maps({}, generation=4) == 4
        (store,) = comp.tiered_stores().values()
        assert {st.generation for st in store.shards} == {4}

    def test_engine_pipeline_parity(self):
        """At S = 2 over one placement and at S = 4 over 4."""
        dense = _server(4, False)
        want = [r.score for r in dense.score_batch(
            [_req(f"t{i % 4}", seed=i) for i in range(24)])]
        for shards, placements in ((2, 1), (4, 4)):
            comp = _composed_server(shards=shards, placements=placements)
            engine = AsyncDispatchEngine(comp, max_batch=6, max_wait_ms=1e9)
            try:
                futs = [engine.submit(_req(f"t{i % 4}", seed=i))
                        for i in range(24)]
                engine.flush()
                scores = [f.result(timeout=60).score for f in futs]
                assert not engine.errors
            finally:
                engine.close()
            assert scores == want
            assert comp.metrics["shard_dispatches"] == 4
            (store,) = comp.tiered_stores().values()
            assert len(store.placements) == placements

    def test_engine_prefetch_routes_to_composed_store(self):
        # 8 predictors over 2 shards: 4 rows a shard, hot=3 + victims=2
        # slots — a full window leaves cold rows for prefetch to stage
        comp = _composed_server(n=8)
        comp.score_batch([_req(f"t{i}", i) for i in range(8)])
        assert comp.prefetch_enabled
        names = [f"p{i}" for i in range(8)]
        staged = comp.prefetch_transforms(names, create=False)
        assert staged >= 1
        (store,) = comp.tiered_stores().values()
        assert isinstance(store, ShardedTieredBankStore)
        assert store.metrics["prefetched_rows"] >= staged

    def test_warm_tiers_across_topologies(self):
        single = _server(4, tiering=TieringConfig(**TIER))
        reqs = [_req("t1", seed=i) for i in range(3)] + \
            [_req("t2", seed=i + 100) for i in range(3)] + \
            [_req("t0", seed=200), _req("t3", seed=201)]
        single.score_batch(reqs)
        single.rebalance_tiers()
        (old,) = single.tiered_stores().values()
        assert {1, 2} <= set(old.hot_rows().tolist())
        # surge a composed replica from the single-tier one: the global
        # snapshot scatters hotness onto the owning shards
        comp = _composed_server()
        assert comp.warm_tiers_from(single) == 1
        (store,) = comp.tiered_stores().values()
        assert isinstance(store, ShardedTieredBankStore)
        assert {1, 2} <= set(store.hot_rows().tolist())
        # ... and back: a single-tier replica warms from the composed one
        single2 = _server(4, tiering=TieringConfig(**TIER))
        assert single2.warm_tiers_from(comp) == 1
        (s2,) = single2.tiered_stores().values()
        assert {1, 2} <= set(s2.hot_rows().tolist())
        assert np.array_equal(s2.hotness_snapshot()["seen"],
                              store.hotness_snapshot()["seen"])
