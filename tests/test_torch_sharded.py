"""The port's tenant-sharded bank, its dispatcher and the sharded server,
against the port's dense path and against the JAX package.

Structure: the port's :class:`ShardedTransformBank` and the JAX package's,
built from the same numpy rows over 1/2/4/8 shards and round-robin, uneven,
empty-shard and arbitrary assignments, hold the same remaps and BITWISE the
same (S, Tl, ·) stacks (the padding rows are the float32 ``np.linspace``
grid); ``shard_bank``, ``to_dense``, ``locate`` and ``with_rows`` agree, and
bad assignments raise the same errors.  The JAX bank needs no mesh, so this
runs on the one JAX device of a plain test run.

Scores: the port's sharded dispatch (one launch over every shard's rows) is
bitwise equal to the port's dense launch and within 2e-5 of the JAX oracle
``banked_score_pipeline`` on the same inputs, across a sweep of
assignments with empty shards and tenants absent from the window.  The
sharded server is bitwise equal to the dense server at S = 1, 2, 4, 8
(same generations), through the async engine, and through fleet publishes
landing under live traffic.  One witness of the reference's sharded server
runs in a subprocess with 8 forced host devices and ``fused_kernel=False``
(its Pallas kernel needs ``pallas.load``, which jax 0.9.0 lacks): its
scores agree with the port's within 2e-5, its generations and
``shard_dispatches`` exactly.  On the CPU ``ops`` runs the plain versions.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.transforms import QuantileMap as JQM
from repro.core.transforms import ShardedTransformBank as JSharded
from repro.core.transforms import TransformBank as JBank
from repro.core.transforms import banked_score_pipeline as jbanked
from repro_torch.core.predictor import PredictorSpec
from repro_torch.core.quantiles import StreamingQuantileEstimator
from repro_torch.core.routing import Condition, Intent, RoutingTable, ScoringRule
from repro_torch.core.transforms import (
    TENANT_AXIS,
    QuantileMap,
    ShardedTransformBank,
    TransformBank,
    shard_rows,
)
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_tenant_mesh, tenant_axis_size
from repro_torch.serving import (
    AsyncDispatchEngine,
    CalibrationController,
    MuseServer,
    RefreshPolicy,
    ServerConfig,
    ShardedBankDispatcher,
)
from repro_torch.serving.types import ScoringRequest

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-5, atol=2e-5)
DIM = 8
SHARD_COUNTS = (1, 2, 4, 8)
LAYOUTS = ("round_robin", "uneven", "empty", "arbitrary")


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def _bitwise(a, b) -> bool:
    return np.array_equal(_bits(a), _bits(b))


def _rows(rng, t, k, n):
    return (rng.uniform(0.05, 1.0, (t, k)).astype(np.float32),
            rng.uniform(0.1, 2.0, (t, k)).astype(np.float32),
            np.sort(rng.uniform(0, 1, (t, n)), -1).astype(np.float32),
            np.sort(rng.uniform(0, 1, (t, n)), -1).astype(np.float32))


def _banks(rows, generation=0):
    """(port bank on the CPU, JAX bank) over the same numpy rows."""
    mine = TransformBank(*(torch.from_numpy(a.copy()) for a in rows),
                         generation=generation)
    theirs = JBank(*(jnp.asarray(a) for a in rows), generation=generation)
    return mine, theirs


def _assignment(layout, rng, t, s):
    if layout == "round_robin":
        return None
    if layout == "uneven":       # most rows on shard 0, the rest spread
        return np.where(rng.random(t) < 0.7, 0, rng.integers(0, s, t))
    if layout == "empty":        # every row on the last shard
        return np.full(t, s - 1)
    return rng.integers(0, s, t)


def _stacks(sb):
    return [np.asarray(x) for x in (sb.betas, sb.weights, sb.src_quantiles,
                                    sb.ref_quantiles)]


def _same_bank(mine: TransformBank, theirs: JBank) -> None:
    for a, b in zip((mine.betas, mine.weights, mine.src_quantiles,
                     mine.ref_quantiles),
                    (theirs.betas, theirs.weights, theirs.src_quantiles,
                     theirs.ref_quantiles)):
        assert _bitwise(a.numpy(), np.asarray(b))
    assert mine.generation == theirs.generation


def _dense(bank: TransformBank, raws, tid) -> np.ndarray:
    return ops.score_pipeline_banked(
        torch.from_numpy(np.asarray(raws, np.float32)),
        torch.from_numpy(np.asarray(tid, np.int32)), bank.betas,
        bank.weights, bank.src_quantiles, bank.ref_quantiles).numpy()


def _oracle(jbank: JBank, raws, tid) -> np.ndarray:
    return np.asarray(jbanked(jnp.asarray(raws), jnp.asarray(tid, jnp.int32),
                              jbank.betas, jbank.weights, jbank.src_quantiles,
                              jbank.ref_quantiles))


def _dispatcher(s, fused=True):
    return ShardedBankDispatcher(make_tenant_mesh(s, "cpu"), fused=fused)


# ---------------------------------------------------------------------------
# structure against the JAX package
# ---------------------------------------------------------------------------

class TestShardedBankStructure:
    @pytest.mark.parametrize("layout", LAYOUTS)
    @pytest.mark.parametrize("shards", SHARD_COUNTS)
    def test_structure_matches_reference_bitwise(self, shards, layout):
        rng = np.random.default_rng(10 * shards + LAYOUTS.index(layout))
        t, k, n = 13, 3, 256
        mine_d, theirs_d = _banks(_rows(rng, t, k, n), generation=7)
        assign = _assignment(layout, rng, t, shards)
        mine = ShardedTransformBank.from_dense(mine_d, shards, shard_of=assign)
        theirs = JSharded.from_dense(theirs_d, shards, shard_of=assign)
        for name in ("shard_of", "local_of", "row_counts"):
            assert np.array_equal(getattr(mine, name), getattr(theirs, name))
        # the stacks, padding rows included (np.linspace, not torch's grid)
        for a, b in zip(_stacks(mine), _stacks(theirs)):
            assert a.shape == b.shape and _bitwise(a, b)
        for name in ("num_shards", "num_rows", "rows_per_shard",
                     "num_experts", "num_quantiles", "per_shard_bytes",
                     "generation"):
            assert getattr(mine, name) == getattr(theirs, name), name
        for s in range(shards):
            _same_bank(mine.shard_bank(s), theirs.shard_bank(s))
        _same_bank(mine.to_dense(), theirs.to_dense())
        _same_bank(mine.to_dense(), theirs_d)
        tid = rng.integers(0, t, 40)
        for a, b in zip(mine.locate(tid), theirs.locate(tid)):
            assert np.array_equal(a, b)

    @pytest.mark.parametrize("layout", LAYOUTS)
    @pytest.mark.parametrize("shards", SHARD_COUNTS)
    def test_with_rows_matches_reference_bitwise(self, shards, layout):
        rng = np.random.default_rng(100 + 10 * shards + LAYOUTS.index(layout))
        t, k, n = 11, 2, 32
        mine_d, theirs_d = _banks(_rows(rng, t, k, n))
        assign = _assignment(layout, rng, t, shards)
        mine = ShardedTransformBank.from_dense(mine_d, shards, shard_of=assign)
        theirs = JSharded.from_dense(theirs_d, shards, shard_of=assign)
        # a full-width table and a narrow one (edge-padded to N)
        tables = {2: (np.sort(rng.uniform(0, 1, n)), np.linspace(0, 1, n) ** 2),
                  7: (np.sort(rng.uniform(0, 1, 9)), np.linspace(0, 1, 9))}
        ours = {r: QuantileMap(torch.tensor(a, dtype=torch.float32),
                               torch.tensor(b, dtype=torch.float32))
                for r, (a, b) in tables.items()}
        refs = {r: JQM(jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32))
                for r, (a, b) in tables.items()}
        for gen in (None, 5):
            got = mine.with_rows(ours, generation=gen)
            want = theirs.with_rows(refs, generation=gen)
            for a, b in zip(_stacks(got), _stacks(want)):
                assert _bitwise(a, b)
            assert got.generation == want.generation
            # the receiver is untouched
            for a, b in zip(_stacks(mine), _stacks(theirs)):
                assert _bitwise(a, b)
            # and the dense bank takes the same rows
            _same_bank(got.to_dense(), theirs_d.with_rows(refs, generation=gen))
        assert mine.with_rows({}) is mine
        assert mine.with_rows({}, generation=9).generation == 9

    def test_with_rows_scatters_only_into_owning_shard(self):
        rng = np.random.default_rng(3)
        bank, _ = _banks(_rows(rng, 8, 2, 16))
        sbank = ShardedTransformBank.from_dense(bank, 4)   # t % 4
        qm = QuantileMap(torch.linspace(0, 1, 16), torch.linspace(0, 1, 16) ** 2)
        out = sbank.with_rows({5: qm})
        owner = int(sbank.shard_of[5])
        assert owner == 1
        for s in range(4):
            same = _bitwise(out.src_quantiles[s].numpy(),
                            sbank.src_quantiles[s].numpy())
            assert same == (s != owner)
        assert torch.equal(out.src_quantiles[owner, int(sbank.local_of[5])],
                           qm.src_quantiles)
        assert out.generation == sbank.generation + 1

    @pytest.mark.parametrize("case", ["zero_shards", "short_assignment",
                                      "shard_out_of_range", "row_out_of_range",
                                      "wide_table"])
    def test_bad_input_raises_as_the_reference(self, case):
        rows = _rows(np.random.default_rng(5), 4, 2, 8)
        mine, theirs = _banks(rows)
        n = 8

        def call(mod_sharded, bank, qm_cls, lin):
            if case == "zero_shards":
                mod_sharded.from_dense(bank, 0)
            elif case == "short_assignment":
                mod_sharded.from_dense(bank, 2, shard_of=np.array([0, 1]))
            elif case == "shard_out_of_range":
                mod_sharded.from_dense(bank, 2,
                                       shard_of=np.array([0, 1, 2, 0]))
            elif case == "row_out_of_range":
                mod_sharded.from_dense(bank, 2).with_rows(
                    {9: qm_cls(lin(0, 1, n), lin(0, 1, n))})
            else:
                mod_sharded.from_dense(bank, 2).with_rows(
                    {0: qm_cls(lin(0, 1, 2 * n), lin(0, 1, 2 * n))})

        errors = []
        for args in ((ShardedTransformBank, mine, QuantileMap, torch.linspace),
                     (JSharded, theirs, JQM, jnp.linspace)):
            with pytest.raises((ValueError, IndexError)) as info:
                call(*args)
            errors.append(info.type)
        assert errors[0] is errors[1]

    def test_shard_rows_and_mesh(self):
        assign, local, counts = shard_rows(11, 4)
        assert np.array_equal(assign, np.arange(11) % 4)
        assert np.array_equal(counts, [3, 3, 3, 2])
        assert np.array_equal(local, np.arange(11) // 4)
        mesh = make_tenant_mesh(4, "cpu")
        assert mesh.num_shards == tenant_axis_size(mesh) == 4
        assert mesh.shape == {TENANT_AXIS: 4} and TENANT_AXIS == "tenants"
        assert mesh.device == torch.device("cpu")
        assert make_tenant_mesh(2, ["cpu", "cpu"]).device.type == "cpu"
        with pytest.raises(ValueError):
            make_tenant_mesh(0, "cpu")
        with pytest.raises(NotImplementedError, match="11b"):
            make_tenant_mesh(2, ["cpu", "meta"])

    def test_per_shard_bytes_shrink_with_shard_count(self):
        bank, _ = _banks(_rows(np.random.default_rng(2), 64, 4, 256))
        dense_bytes = 64 * (2 * 4 + 2 * 256) * 4
        for s in SHARD_COUNTS:
            assert ShardedTransformBank.from_dense(bank, s).per_shard_bytes \
                == dense_bytes // s


# ---------------------------------------------------------------------------
# the dispatcher: bitwise the dense launch, within 2e-5 of the JAX oracle
# ---------------------------------------------------------------------------

class TestShardedDispatchParity:
    @pytest.mark.parametrize("shards", SHARD_COUNTS)
    def test_bitwise_parity_vs_dense_kernel(self, shards):
        rng = np.random.default_rng(100 + shards)
        t, k, n, b = 23, 3, 64, 517
        rows = _rows(rng, t, k, n)
        bank, jbank = _banks(rows)
        scores = rng.uniform(0, 1, (b, k)).astype(np.float32)
        tid = rng.integers(0, t, b)
        dense = _dense(bank, scores, tid)
        got = _dispatcher(shards)(
            scores, tid, ShardedTransformBank.from_dense(bank, shards))
        assert _bitwise(got, dense)
        np.testing.assert_allclose(got, _oracle(jbank, scores, tid), **TOL)

    @pytest.mark.parametrize("shards", SHARD_COUNTS)
    def test_unfused_fallback_parity(self, shards):
        rng = np.random.default_rng(200 + shards)
        t, k, n, b = 11, 2, 32, 260
        bank, jbank = _banks(_rows(rng, t, k, n))
        scores = rng.uniform(0, 1, (b, k)).astype(np.float32)
        tid = rng.integers(0, t, b)
        sbank = ShardedTransformBank.from_dense(bank, shards)
        got = _dispatcher(shards, fused=False)(scores, tid, sbank)
        assert _bitwise(got, bank(torch.from_numpy(scores),
                                  torch.from_numpy(tid)).numpy())
        np.testing.assert_allclose(got, _oracle(jbank, scores, tid), **TOL)

    def test_run_packed_is_one_launch_over_views(self, monkeypatch):
        """One call of the kernel wrapper a pass, on (S·Bs, K) scores, ids
        offset by s·Tl, and the stacks' own storage (views, not copies);
        an empty shard's padding rows read its local row 0."""
        rng = np.random.default_rng(4)
        bank, _ = _banks(_rows(rng, 10, 2, 16))
        sbank = ShardedTransformBank.from_dense(
            bank, 4, shard_of=np.array([0, 0, 0, 1, 1, 3, 3, 3, 3, 3]))
        tid = np.array([0, 3, 9, 5, 1, 4, 2])
        raws = rng.uniform(0, 1, (7, 2)).astype(np.float32)
        want = _dense(bank, raws, tid)
        calls = []
        real = ops.score_pipeline_banked

        def spy(scores, idx, *params):
            calls.append((tuple(scores.shape), idx.clone(),
                          [p.data_ptr() for p in params]))
            return real(scores, idx, *params)

        monkeypatch.setattr(ops, "score_pipeline_banked", spy)
        got = _dispatcher(4)(raws, tid, sbank)
        assert _bitwise(got, want)
        ((shape, idx, ptrs),) = calls
        tl = sbank.rows_per_shard
        assert tl == 5 and shape == (4 * 4, 2)    # widest shard: 3 -> 4
        assert ptrs == [x.data_ptr() for x in (
            sbank.betas, sbank.weights, sbank.src_quantiles,
            sbank.ref_quantiles)]
        idx = idx.view(4, 4).numpy()
        assert list(idx[0]) == [0, 1, 2, 2]            # edge pad
        assert list(idx[1]) == [tl, tl + 1, tl + 1, tl + 1]
        assert list(idx[2]) == [2 * tl] * 4            # empty shard: row 0
        assert list(idx[3]) == [3 * tl + 4, 3 * tl, 3 * tl, 3 * tl]
        with pytest.raises(RuntimeError):             # a copy would hide it
            _dispatcher(4).run_packed(
                np.zeros((4, 1, 2), np.float32), np.zeros((4, 1), np.int32),
                sbank.betas.transpose(0, 1), sbank.weights,
                sbank.src_quantiles, sbank.ref_quantiles)


class TestShardedProperties:
    @settings(max_examples=10, deadline=None)
    @given(st.integers(0, 10_000), st.integers(1, 8), st.integers(1, 31))
    def test_arbitrary_assignment_preserves_scores_bitwise(
            self, seed, shards, t):
        """Any tenant->shard assignment — uneven, with empty shards, with
        tenants absent from the batch — serves the dense launch's bits,
        within 2e-5 of the JAX oracle."""
        rng = np.random.default_rng(seed)
        k, n, b = 2, 16, 97
        bank, jbank = _banks(_rows(rng, t, k, n))
        assign = rng.integers(0, shards, t)
        sbank = ShardedTransformBank.from_dense(bank, shards, shard_of=assign)
        present = rng.choice(t, size=max(1, t // 2), replace=False)
        tid = rng.choice(present, size=b)
        scores = rng.uniform(0, 1, (b, k)).astype(np.float32)
        got = _dispatcher(shards)(scores, tid, sbank)
        assert _bitwise(got, _dense(bank, scores, tid))
        np.testing.assert_allclose(got, _oracle(jbank, scores, tid), **TOL)
        assert _bitwise(sbank.to_dense().src_quantiles.numpy(),
                        bank.src_quantiles.numpy())

    @settings(max_examples=8, deadline=None)
    @given(st.integers(0, 10_000), st.integers(2, 8))
    def test_permuted_assignment_equals_default(self, seed, shards):
        rng = np.random.default_rng(seed)
        t, k, n, b = 12, 3, 32, 130
        bank, _ = _banks(_rows(rng, t, k, n))
        scores = rng.uniform(0, 1, (b, k)).astype(np.float32)
        tid = rng.integers(0, t, b)
        disp = _dispatcher(shards)
        default = disp(scores, tid, ShardedTransformBank.from_dense(bank, shards))
        permuted = disp(scores, tid, ShardedTransformBank.from_dense(
            bank, shards, shard_of=rng.permutation(t) % shards))
        assert _bitwise(default, permuted)


# ---------------------------------------------------------------------------
# the sharded server
# ---------------------------------------------------------------------------

def _linear_model(seed: int):
    w = np.random.default_rng(seed).normal(0, 1, DIM).astype(np.float32)
    return lambda x: 1.0 / (1.0 + np.exp(-(np.asarray(x, np.float32) @ w)))


FACTORIES = {f"m{i}": (lambda i=i: _linear_model(i)) for i in (1, 2, 3)}


def _req(tenant, seed):
    x = np.random.default_rng(seed).normal(0, 1, DIM).astype(np.float32)
    return ScoringRequest(intent=Intent(tenant=tenant), features=x)


def _fleet(n_tenants=6, *, shards=1, **config) -> MuseServer:
    """One predictor per tenant, all sharing one model group, so a mixed
    batch is ONE multi-tenant banked window (the reference test's fleet)."""
    rules = tuple(ScoringRule(Condition(tenants=(f"t{i}",)), f"p{i}")
                  for i in range(n_tenants)) + \
        (ScoringRule(Condition(), "p0"),)
    server = MuseServer(
        RoutingTable(rules, version="v1"),
        ServerConfig(refresh_alert_rate=0.05, refresh_rel_error=0.5,
                     tenant_shards=shards, **config), device="cpu")
    rng = np.random.default_rng(42)
    for i in range(n_tenants):
        qm = QuantileMap(
            torch.tensor(np.sort(rng.uniform(0, 1, 32)), dtype=torch.float32),
            torch.tensor(np.sort(rng.uniform(0, 1, 32)), dtype=torch.float32))
        server.deploy(PredictorSpec(f"p{i}", ("m1", "m2"),
                                    (0.2 + 0.1 * (i % 3), 0.4),
                                    (1.0, 1.0 + i % 2), qm), FACTORIES)
    return server


def _same_responses(got, want):
    assert [r.request_id for r in got] == [r.request_id for r in want]
    for a, b in zip(got, want):
        assert (a.score, a.predictor, a.bank_generation) == \
            (b.score, b.predictor, b.bank_generation)


class TestShardedServerParity:
    @pytest.mark.parametrize("shards", SHARD_COUNTS)
    def test_score_batch_bitwise_vs_dense_server(self, shards):
        dense, sharded = _fleet(6), _fleet(6, shards=shards)
        reqs = [_req(f"t{i % 6}", 1000 + i) for i in range(37)]
        _same_responses(sharded.score_batch(reqs), dense.score_batch(reqs))
        # tenant_shards=1 IS the dense path by design
        if shards > 1:
            assert sharded.metrics["shard_dispatches"] == \
                sharded.metrics["kernel_dispatches"] == 1
            entry = next(iter(sharded.plane.banks.values()))
            assert entry.sharded.num_shards == shards
            assert entry.sharded.generation == entry.bank.generation
        else:
            assert sharded.metrics["shard_dispatches"] == 0
        assert dense.metrics["shard_dispatches"] == 0
        assert sharded.metrics["skip_blocks_total"] == \
            (0 if shards > 1 else dense.metrics["skip_blocks_total"])

    @pytest.mark.parametrize("shards", (2, 4))
    def test_publish_keeps_shards_and_dense_bank_in_one_generation(
            self, shards):
        dense, sharded = _fleet(6), _fleet(6, shards=shards)
        reqs = [_req(f"t{i % 6}", 3000 + i) for i in range(24)]
        dense.score_batch(reqs)
        sharded.score_batch(reqs)
        rng = np.random.default_rng(8)
        qm = QuantileMap(
            torch.tensor(np.sort(rng.uniform(0, 1, 32)), dtype=torch.float32),
            torch.tensor(np.linspace(0, 1, 32) ** 2, dtype=torch.float32))
        wide = QuantileMap(torch.linspace(0, 1, 64), torch.linspace(0, 1, 64))
        # a refresh; a wider table, which rebuilds the bank (and its
        # shards) from params; a fenced empty publish, which re-stamps
        for updates, fence, gen in (({"p1": qm, "p4": qm}, None, 1),
                                    ({"p2": wide}, None, 2), ({}, 7, 7)):
            for server in (dense, sharded):
                assert server.publish_quantile_maps(
                    updates, generation=fence) == gen
            _same_responses(sharded.score_batch(reqs), dense.score_batch(reqs))
        entry = next(iter(sharded.plane.banks.values()))
        assert entry.bank.generation == entry.sharded.generation == 7
        assert entry.sharded.num_quantiles == 64
        assert sharded.metrics["shard_dispatches"] == \
            sharded.metrics["kernel_dispatches"] == 4

    def test_engine_serves_through_sharded_path(self):
        dense, sharded = _fleet(4), _fleet(4, shards=4)
        reqs = [_req(f"t{i % 4}", 2000 + i) for i in range(32)]
        want = {r.request_id: r.score for r in dense.score_batch(reqs)}
        engine = AsyncDispatchEngine(sharded, max_batch=8, max_wait_ms=1e9)
        try:
            out = engine.score_batch(reqs)
        finally:
            engine.close()
        assert sharded.metrics["shard_dispatches"] == 4
        assert {r.request_id: r.score for r in out} == want


def _inject(server, tenant, pred, n=5000, seed=0):
    est = StreamingQuantileEstimator(capacity=131072, seed=seed)
    est.update(np.random.default_rng(seed).uniform(0, 1, n))
    server._estimators[(tenant, pred)] = est


def _pipelines(server):
    return {n: p.pipeline for n, p in server.predictors.items()}


class TestShardedRefreshAtomicity:
    """Fleet refreshes land atomically ACROSS shards: the dense bank and
    every per-shard sub-bank swap in one control-plane assignment, so a
    traffic thread never sees shard A at generation g and shard B at g+1,
    and generations are monotone."""

    def test_publishes_are_atomic_across_shards(self):
        n_t = 8
        server = _fleet(n_t, shards=4)
        for i in range(n_t):
            _inject(server, f"t{i}", f"p{i}", seed=i)
        ctrl = CalibrationController(
            server, np.linspace(0.0, 1.0, 64) ** 2,
            RefreshPolicy(alert_rate=0.05, rel_error=0.5, n_levels=64))
        registry = {0: _pipelines(server)}
        assert ctrl.refresh_fleet().generation == 1
        registry[1] = _pipelines(server)
        engine = AsyncDispatchEngine(server, max_batch=16, max_wait_ms=1e9,
                                     facade_timeout_s=120.0)
        reqs = [_req(f"t{i % n_t}", i) for i in range(480)]
        stop = threading.Event()
        published: list[int] = []

        def writer():
            while not stop.is_set() and len(published) < 12:
                res = ctrl.refresh_fleet()
                registry[res.generation] = _pipelines(server)
                published.append(res.generation)

        wt = threading.Thread(target=writer)
        tt = threading.Thread(target=lambda: [engine.submit(r) for r in reqs])
        wt.start()
        tt.start()
        tt.join(timeout=120.0)
        assert not tt.is_alive(), "traffic thread wedged"
        responses = engine.drain(timeout=120.0)
        stop.set()
        wt.join(timeout=120.0)
        assert not wt.is_alive(), "refresh writer wedged"
        engine.close()
        assert not engine.errors
        assert sorted(r.request_id for r in responses) == \
            sorted(r.request_id for r in reqs)
        assert len(published) >= 2
        assert published == list(range(2, 2 + len(published)))
        # every response replays bit for bit through a one-row bank of the
        # pipeline of the ONE generation it is stamped with
        for resp in responses:
            pipe = registry[resp.bank_generation][resp.predictor]
            one = TransformBank.from_params(
                [(pipe.betas, pipe.weights, pipe.src_quantiles,
                  pipe.ref_quantiles)])
            want = _dense(one, np.asarray([resp.raw_scores]), [0])[0]
            assert _bitwise(resp.score, want), \
                (resp.request_id, resp.predictor, resp.bank_generation)
        seen: dict[str, int] = {}
        for resp in sorted(responses, key=lambda r: r.request_id):
            assert resp.bank_generation >= seen.get(resp.predictor, -1)
            seen[resp.predictor] = resp.bank_generation


# ---------------------------------------------------------------------------
# one witness of the reference's sharded server (8 forced host devices)
# ---------------------------------------------------------------------------

WITNESS = textwrap.dedent("""
    import json
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.core.predictor import PredictorSpec
    from repro.core.routing import Condition, Intent, RoutingTable, ScoringRule
    from repro.core.transforms import QuantileMap
    from repro.serving import MuseServer, ServerConfig
    from repro.serving.types import ScoringRequest

    assert jax.device_count() == 8, jax.device_count()
    DIM = 8

    def linear(seed):
        w = np.random.default_rng(seed).normal(0, 1, DIM).astype(np.float32)
        return lambda x: jnp.asarray(
            1.0 / (1.0 + np.exp(-(np.asarray(x, np.float32) @ w))))

    factories = {f"m{i}": (lambda i=i: linear(i)) for i in (1, 2, 3)}
    rules = tuple(ScoringRule(Condition(tenants=(f"t{i}",)), f"p{i}")
                  for i in range(6)) + (ScoringRule(Condition(), "p0"),)
    server = MuseServer(RoutingTable(rules, version="v1"), ServerConfig(
        refresh_alert_rate=0.05, refresh_rel_error=0.5, tenant_shards=4,
        fused_kernel=False))
    rng = np.random.default_rng(42)
    for i in range(6):
        qm = QuantileMap(
            jnp.asarray(np.sort(rng.uniform(0, 1, 32)), jnp.float32),
            jnp.asarray(np.sort(rng.uniform(0, 1, 32)), jnp.float32))
        server.deploy(PredictorSpec(f"p{i}", ("m1", "m2"),
                                    (0.2 + 0.1 * (i % 3), 0.4),
                                    (1.0, 1.0 + i % 2), qm), factories)

    def req(tenant, seed):
        x = np.random.default_rng(seed).normal(0, 1, DIM).astype(np.float32)
        return ScoringRequest(intent=Intent(tenant=tenant), features=x)

    reqs = [req(f"t{i % 6}", 1000 + i) for i in range(37)]
    out = [server.score_batch(reqs)]
    src, ref = np.sort(np.random.default_rng(8).uniform(0, 1, 32)), \\
        np.linspace(0, 1, 32) ** 2
    qm = QuantileMap(jnp.asarray(src, jnp.float32),
                     jnp.asarray(ref, jnp.float32))
    gens = [server.publish_quantile_maps({"p1": qm, "p4": qm}),
            server.publish_quantile_maps({}, generation=5)]
    out.append(server.score_batch(reqs))
    print(json.dumps({
        "scores": [[r.score for r in o] for o in out],
        "predictors": [[r.predictor for r in o] for o in out],
        "generations": [[r.bank_generation for r in o] for o in out],
        "published": gens,
        "shard_dispatches": server.metrics["shard_dispatches"],
        "kernel_dispatches": server.metrics["kernel_dispatches"]}))
""")


def test_reference_sharded_server_witness():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    proc = subprocess.run([sys.executable, "-c", WITNESS], capture_output=True,
                          text=True, env=env, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    theirs = json.loads(proc.stdout.strip().splitlines()[-1])

    server = _fleet(6, shards=4)
    reqs = [_req(f"t{i % 6}", 1000 + i) for i in range(37)]
    out = [server.score_batch(reqs)]
    src = np.sort(np.random.default_rng(8).uniform(0, 1, 32))
    qm = QuantileMap(torch.tensor(src, dtype=torch.float32),
                     torch.tensor(np.linspace(0, 1, 32) ** 2,
                                  dtype=torch.float32))
    gens = [server.publish_quantile_maps({"p1": qm, "p4": qm}),
            server.publish_quantile_maps({}, generation=5)]
    out.append(server.score_batch(reqs))
    assert gens == theirs["published"] == [1, 5]
    assert [[r.predictor for r in o] for o in out] == theirs["predictors"]
    assert [[r.bank_generation for r in o] for o in out] == \
        theirs["generations"] == [[0] * 37, [5] * 37]
    for o, want in zip(out, theirs["scores"]):
        np.testing.assert_allclose([r.score for r in o], want, **TOL)
    assert server.metrics["shard_dispatches"] == theirs["shard_dispatches"] \
        == server.metrics["kernel_dispatches"] \
        == theirs["kernel_dispatches"] == 2
