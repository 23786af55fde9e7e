"""The port's transforms, predictor pipeline, cold-start map and parameter
conversion against the JAX package, on the same numpy inputs.

Float results agree to the reference's f32 kernel tolerance
(rtol = atol = 2e-5); padding, tables fitted on the host and generations
match exactly.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coldstart as jcold
from repro.core import predictor as jpred
from repro.core import transforms as jt
from repro.experiments.fraud_world import Expert as JExpert
from repro_torch import convert
from repro_torch.core import coldstart as tcold
from repro_torch.core import predictor as tpred
from repro_torch.core import transforms as tt

TOL = dict(rtol=2e-5, atol=2e-5)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tables(rng, n, lo=0.0, hi=1.0):
    src = np.sort(rng.uniform(lo, hi, n)).astype(np.float32)
    ref = np.sort(rng.uniform(0, 1, n)).astype(np.float32)
    return src, ref


class TestElementwise:
    @pytest.mark.parametrize("shape", [(7,), (33, 4), (5, 6, 3)])
    def test_posterior_correction(self, shape):
        rng = np.random.default_rng(len(shape))
        y = rng.uniform(0, 1, shape).astype(np.float32)
        beta = rng.uniform(0.05, 1, shape[-1:]).astype(np.float32)
        got = tt.posterior_correction(torch.from_numpy(y), torch.from_numpy(beta))
        want = jt.posterior_correction(jnp.asarray(y), jnp.asarray(beta))
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
        # scalar beta and the node form
        node = tt.PosteriorCorrection(torch.tensor(0.3))
        np.testing.assert_allclose(
            _np(node(torch.from_numpy(y))),
            _np(jt.PosteriorCorrection(jnp.float32(0.3))(jnp.asarray(y))),
            **TOL)

    @pytest.mark.parametrize("shape", [(7,), (33, 4), (5, 6, 3)])
    def test_posterior_correction_inverse(self, shape):
        rng = np.random.default_rng(10 + len(shape))
        y = rng.uniform(0, 1, shape).astype(np.float32)
        beta = rng.uniform(0.05, 1, shape[-1:]).astype(np.float32)
        got = tt.posterior_correction_inverse(torch.from_numpy(y),
                                              torch.from_numpy(beta))
        want = jt.posterior_correction_inverse(jnp.asarray(y),
                                               jnp.asarray(beta))
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
        np.testing.assert_allclose(
            _np(tt.posterior_correction_inverse(torch.from_numpy(y), 0.3)),
            _np(jt.posterior_correction_inverse(jnp.asarray(y), 0.3)), **TOL)

    @pytest.mark.parametrize("beta", [0.02, 0.18, 0.5])
    def test_inverse_round_trips_the_correction(self, beta):
        """The reference's round trip (tests/test_transforms.py)."""
        y = tt._unit_grid(23) * 0.98 + 0.01
        biased = tt.posterior_correction_inverse(y, beta)
        np.testing.assert_allclose(
            _np(tt.posterior_correction(biased, beta)), _np(y), rtol=1e-5,
            atol=1e-6)

    def test_identity_correction_and_uniform_aggregation(self):
        y = torch.linspace(0, 1, 11)
        assert torch.equal(tt.PosteriorCorrection.identity()(y), y)
        rng = np.random.default_rng(4)
        s = rng.uniform(0, 1, (9, 3)).astype(np.float32)
        w = rng.uniform(0.1, 2, 3).astype(np.float32)
        np.testing.assert_allclose(
            _np(tt.Aggregation(torch.from_numpy(w))(torch.from_numpy(s))),
            _np(jt.Aggregation(jnp.asarray(w))(jnp.asarray(s))), **TOL)
        np.testing.assert_allclose(
            _np(tt.Aggregation.uniform(3)(torch.from_numpy(s))),
            _np(jt.Aggregation.uniform(3)(jnp.asarray(s))), **TOL)

    @pytest.mark.parametrize("n,m", [(8, 50), (64, 1000), (256, 333)])
    def test_quantile_map(self, n, m):
        rng = np.random.default_rng(n)
        src, ref = _tables(rng, n, 0.2, 0.8)
        src[3:6] = src[3]                 # a flat segment
        x = rng.uniform(-0.1, 1.1, m).astype(np.float32)
        x[:n] = src                       # ties on every knot
        got = tt.quantile_map(torch.from_numpy(x), torch.from_numpy(src),
                              torch.from_numpy(ref))
        want = jt.quantile_map(jnp.asarray(x), jnp.asarray(src),
                               jnp.asarray(ref))
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
        qm = tt.QuantileMap(torch.from_numpy(src), torch.from_numpy(ref))
        assert qm.num_quantiles == n
        np.testing.assert_allclose(_np(qm(torch.from_numpy(x))), _np(want),
                                   **TOL)

    @pytest.mark.parametrize("k", [1, 3, 8])
    def test_score_pipeline(self, k):
        rng = np.random.default_rng(k)
        y = rng.uniform(0, 1, (200, k)).astype(np.float32)
        betas = rng.uniform(0.05, 1, k).astype(np.float32)
        w = rng.uniform(0.1, 2, k).astype(np.float32)
        src, ref = _tables(rng, 64)
        got = tt.score_pipeline(*(torch.from_numpy(a)
                                  for a in (y, betas, w, src, ref)))
        want = jt.score_pipeline(*(jnp.asarray(a)
                                   for a in (y, betas, w, src, ref)))
        np.testing.assert_allclose(_np(got), _np(want), **TOL)


class TestTables:
    def test_fit_matches_exactly(self):
        rng = np.random.default_rng(0)
        scores = rng.beta(0.5, 6, 5000)
        ref = np.asarray(jt.fraud_reference_quantiles(64))
        got = tt.QuantileMap.fit(scores, torch.tensor(ref))
        want = jt.QuantileMap.fit(scores, jnp.asarray(ref))
        np.testing.assert_array_equal(_np(got.src_quantiles),
                                      _np(want.src_quantiles))
        np.testing.assert_array_equal(_np(got.ref_quantiles),
                                      _np(want.ref_quantiles))
        assert got.src_quantiles.dtype == torch.float32

    def test_reference_quantiles_match_exactly(self):
        np.testing.assert_array_equal(
            _np(tt.fraud_reference_quantiles(256)),
            _np(jt.fraud_reference_quantiles(256)))
        np.testing.assert_array_equal(
            _np(tt.uniform_reference_quantiles(256)),
            _np(jt.uniform_reference_quantiles(256)))
        np.testing.assert_array_equal(
            _np(tt.QuantileMap.identity(32).src_quantiles),
            _np(jt.QuantileMap.identity(32).src_quantiles))

    @pytest.mark.parametrize("n_in", [5, 16])
    def test_pad_quantile_tables(self, n_in):
        rng = np.random.default_rng(n_in)
        src, ref = _tables(rng, n_in)
        got = tt.pad_quantile_tables(
            tt.QuantileMap(torch.from_numpy(src), torch.from_numpy(ref)), 16)
        want = jt.pad_quantile_tables((jnp.asarray(src), jnp.asarray(ref)), 16)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), _np(w))
        with pytest.raises(ValueError, match="row 3"):
            tt.pad_quantile_tables((torch.zeros(17), torch.zeros(17)), 16,
                                   row=3)

    def test_default_quantile_map_from_a_fit(self):
        fit_j = jcold.BetaMixtureFit(0.01, 0.9, 7.0, 5.0, 1.4, 0.0, 0.0)
        fit_t = tcold.BetaMixtureFit(0.01, 0.9, 7.0, 5.0, 1.4, 0.0, 0.0)
        ref = np.asarray(jt.fraud_reference_quantiles(128))
        got = tcold.default_quantile_map(fit_t, torch.tensor(ref))
        want = jcold.default_quantile_map(fit_j, jnp.asarray(ref))
        np.testing.assert_array_equal(_np(got.src_quantiles),
                                      _np(want.src_quantiles))
        np.testing.assert_array_equal(_np(got.ref_quantiles),
                                      _np(want.ref_quantiles))


def _ragged_rows(rng):
    rows = []
    for k, n in ((2, 8), (1, 16), (3, 12), (3, 16)):
        src, ref = _tables(rng, n)
        rows.append((rng.uniform(0.1, 1, k).astype(np.float32),
                     rng.uniform(0.5, 2, k).astype(np.float32), src, ref))
    return rows


def _banks(rng):
    rows = _ragged_rows(rng)
    jb = jt.TransformBank.from_params(
        [tuple(jnp.asarray(a) for a in r) for r in rows], generation=4)
    tb = tt.TransformBank.from_params(
        [tuple(torch.from_numpy(a) for a in r) for r in rows], generation=4)
    return jb, tb


FIELDS = ("betas", "weights", "src_quantiles", "ref_quantiles")


def _assert_same_bank(tb, jb):
    for f in FIELDS:
        np.testing.assert_array_equal(_np(getattr(tb, f)), _np(getattr(jb, f)))
    assert tb.generation == jb.generation


class TestTransformBank:
    def test_from_params_padding_is_exact(self):
        jb, tb = _banks(np.random.default_rng(1))
        _assert_same_bank(tb, jb)
        assert (tb.num_rows, tb.num_experts, tb.num_quantiles) == (4, 3, 16)
        # padded expert columns: beta 1, weight 0
        assert tb.betas[1, 1:].tolist() == [1.0, 1.0]
        assert tb.weights[1, 1:].tolist() == [0.0, 0.0]
        with pytest.raises(ValueError):
            tt.TransformBank.from_params([])

    def test_with_rows_is_functional(self):
        rng = np.random.default_rng(2)
        jb, tb = _banks(rng)
        old = {f: getattr(tb, f).clone() for f in FIELDS}
        src, ref = _tables(rng, 10)        # narrower: edge-padded to 16
        src2, ref2 = _tables(rng, 16)
        t_new = tb.with_rows({
            2: tt.QuantileMap(torch.from_numpy(src), torch.from_numpy(ref)),
            0: (torch.from_numpy(src2), torch.from_numpy(ref2))})
        j_new = jb.with_rows({
            2: jt.QuantileMap(jnp.asarray(src), jnp.asarray(ref)),
            0: (jnp.asarray(src2), jnp.asarray(ref2))})
        _assert_same_bank(t_new, j_new)
        assert t_new.generation == tb.generation + 1
        assert not torch.equal(t_new.src_quantiles, tb.src_quantiles)
        for f in FIELDS:                    # the receiver is untouched
            assert torch.equal(getattr(tb, f), old[f])
        assert tb.with_rows({}) is tb
        assert tb.with_rows({}, generation=9).generation == 9
        assert tb.with_rows({1: (torch.from_numpy(src2),
                                 torch.from_numpy(ref2))},
                            generation=11).generation == 11
        with pytest.raises(IndexError):
            tb.with_rows({4: (torch.from_numpy(src2), torch.from_numpy(ref2))})
        with pytest.raises(ValueError):
            tb.with_rows({0: (torch.zeros(17), torch.zeros(17))})
        # src and ref of different lengths: a ValueError in both packages
        # (the server's publish rebuilds the bank from its pipelines then)
        with pytest.raises(ValueError):
            tb.with_rows({0: (torch.zeros(4), torch.zeros(8))})
        with pytest.raises(ValueError):
            jb.with_rows({0: (jnp.zeros(4), jnp.zeros(8))})

    def test_pre_quantile_and_call(self):
        rng = np.random.default_rng(3)
        jb, tb = _banks(rng)
        y = rng.uniform(0, 1, (120, 3)).astype(np.float32)
        tid = rng.integers(0, 4, 120).astype(np.int32)
        np.testing.assert_allclose(
            _np(tb.pre_quantile(torch.from_numpy(y), torch.from_numpy(tid))),
            _np(jb.pre_quantile(jnp.asarray(y), jnp.asarray(tid))), **TOL)
        np.testing.assert_allclose(
            _np(tb(torch.from_numpy(y), torch.from_numpy(tid))),
            _np(jb(jnp.asarray(y), jnp.asarray(tid))), **TOL)


def _bank_inputs(seed, t=4, k=3, n=16, m=40):
    rng = np.random.default_rng(seed)
    params = (rng.uniform(0.05, 1, (t, k)).astype(np.float32),
              rng.uniform(0.1, 2, (t, k)).astype(np.float32),
              np.sort(rng.uniform(0, 1, (t, n)), -1).astype(np.float32),
              np.sort(rng.uniform(0, 1, (t, n)), -1).astype(np.float32))
    y = rng.uniform(0, 1, (m, k)).astype(np.float32)
    return rng, params, y


def _banked_both(params, y, tid):
    got = _np(tt.banked_score_pipeline(
        torch.from_numpy(y), torch.from_numpy(tid),
        *(torch.from_numpy(p) for p in params)))
    want = _np(jt.banked_score_pipeline(
        jnp.asarray(y), jnp.asarray(tid), *(jnp.asarray(p) for p in params)))
    return got, want


class TestOutOfRangeIds:
    """A row whose tenant id lies outside [0, T) scores NaN; every other
    row is what it is without such rows."""

    @pytest.mark.parametrize("bad", [[4], [4, 9, 1 << 20], [2 ** 31 - 1]])
    def test_ids_past_the_bank_are_nan_where_the_oracle_is(self, bad):
        rng, params, y = _bank_inputs(20 + len(bad))
        tid = rng.integers(0, 4, 40).astype(np.int32)
        rows = rng.choice(40, 3 * len(bad), replace=False)
        tid[rows] = np.resize(np.asarray(bad, np.int32), rows.size)
        got, want = _banked_both(params, y, tid)
        assert np.array_equal(np.isnan(got), np.isnan(want))
        assert np.isnan(got[rows]).all()
        ok = ~np.isnan(want)
        np.testing.assert_allclose(got[ok], want[ok], **TOL)

    def test_negative_ids_are_nan(self):
        """The port follows the CUDA kernel and the reference's Pallas
        kernel.  The reference's jnp.take oracle wraps a negative id
        instead (-1 reads row T-1), so it is not compared here."""
        rng, params, y = _bank_inputs(30)
        tid = rng.integers(0, 4, 40).astype(np.int32)
        tid[[1, 7, 33]] = [-1, -4, -(2 ** 31)]
        got, want = _banked_both(params, y, tid)
        assert np.isnan(got[[1, 7, 33]]).all()
        ok = tid >= 0
        assert not np.isnan(got[ok]).any()
        np.testing.assert_allclose(got[ok], want[ok], **TOL)

    def test_other_rows_are_unchanged_bit_for_bit(self):
        rng, params, y = _bank_inputs(31)
        tid = rng.integers(0, 4, 40).astype(np.int32)
        clean, _ = _banked_both(params, y, tid)
        bad = tid.copy()
        bad[::5] = 7
        bad[2::9] = -2
        got, _ = _banked_both(params, y, bad)
        ok = (bad >= 0) & (bad < 4)
        assert np.array_equal(got[ok], clean[ok])
        assert np.isnan(got[~ok]).all()

    def test_pre_quantile_still_raises(self):
        """``track`` forms its ids from the bank; an id outside it is a
        caller's fault there, not a score."""
        _, params, y = _bank_inputs(32)
        tb = tt.TransformBank(*(torch.from_numpy(p) for p in params))
        with pytest.raises(IndexError):
            tb.pre_quantile(torch.from_numpy(y[:2]), torch.tensor([0, 4]))


def _steep_bank(seed, k, t=4096, n=256):
    """Random uniform tables as in the on-card T = 4,096 bank, one row a
    tenant, each source segment holding a row's aggregate squeezed to
    2e-6 around it: there one ulp of the aggregate moves the score by about
    1e-4, so the order of the sums over K shows in the score."""
    _, params, y = _bank_inputs(seed, t=t, k=k, n=n, m=t)
    betas, weights, src, ref = params
    tid = np.arange(t, dtype=np.int32)
    agg = _np(tt.TransformBank(*(torch.from_numpy(p) for p in params))
              .pre_quantile(torch.from_numpy(y), torch.from_numpy(tid)))
    j = (agg[:, None] >= src).sum(-1) - 1
    inner = np.flatnonzero((j >= 0) & (j < n - 1))
    lo, hi = src[inner, j[inner]], src[inner, j[inner] + 1]
    src[inner, j[inner]] = np.maximum(lo, agg[inner] - np.float32(1e-6))
    src[inner, j[inner] + 1] = np.minimum(hi, agg[inner] + np.float32(1e-6))
    assert (np.diff(src, axis=-1) >= 0).all()
    return (betas, weights, src, ref), y, tid


def _sum_reversed(x):
    total = x[..., -1]
    for e in range(x.shape[-1] - 2, -1, -1):
        total = total + x[..., e]
    return total


class TestSumOverK:
    """The plain banked version sums weights and terms over K in k order,
    as the CUDA kernel does; held against the JAX oracle where a T^Q
    segment is steep enough for the order to move a score past 2e-5."""

    @pytest.mark.parametrize("k", [3, 8])
    def test_k_order_matches_the_oracle_on_steep_segments(self, k,
                                                          monkeypatch):
        params, y, tid = _steep_bank(40 + k, k)
        got, want = _banked_both(params, y, tid)
        np.testing.assert_allclose(got, want, **TOL)
        # another order moves some score past the tolerance: the input is
        # steep where it has to be
        monkeypatch.setattr(tt, "_sum_k", _sum_reversed)
        other, _ = _banked_both(params, y, tid)
        assert np.abs(other - want).max() > 2e-5

    @pytest.mark.parametrize("k", [3, 8])
    def test_pre_quantile_sums_in_k_order(self, k):
        """``track`` records the aggregate that is scored: float32 terms
        and sums in k order, bit for bit."""
        _, params, y = _bank_inputs(50 + k, k=k)
        betas, weights = params[:2]
        tid = np.arange(40, dtype=np.int32) % 4
        got = _np(tt.TransformBank(*(torch.from_numpy(p) for p in params))
                  .pre_quantile(torch.from_numpy(y), torch.from_numpy(tid)))
        b, w = betas[tid], weights[tid]
        c = (b * y) / (np.float32(1) - (np.float32(1) - b) * y)
        wsum, agg = w[:, 0], np.zeros_like(got)
        for e in range(1, k):
            wsum = wsum + w[:, e]
        for e in range(k):
            agg = agg + c[:, e] * (w[:, e] / wsum)
        assert np.array_equal(got, agg)


class TestPipeline:
    def _specs(self):
        rng = np.random.default_rng(6)
        src, ref = _tables(rng, 32)
        args = ("p", ("m1", "m2"), (0.2, 0.5), (1.0, 3.0))
        js = jpred.PredictorSpec(*args, jt.QuantileMap(jnp.asarray(src),
                                                       jnp.asarray(ref)))
        ts = tpred.PredictorSpec(*args, tt.QuantileMap(torch.from_numpy(src),
                                                       torch.from_numpy(ref)))
        return js, ts, rng

    def test_pipeline_call_and_pre_quantile(self):
        js, ts, rng = self._specs()
        jp, tp = js.pipeline(), ts.pipeline("cpu")
        y = rng.uniform(0, 1, (64, 2)).astype(np.float32)
        np.testing.assert_allclose(_np(tp(torch.from_numpy(y))),
                                   _np(jp(jnp.asarray(y))), **TOL)
        np.testing.assert_allclose(_np(tp.pre_quantile(torch.from_numpy(y))),
                                   _np(jp.pre_quantile(jnp.asarray(y))), **TOL)
        assert tp.num_experts == 2
        w = tp.with_weights([2.0, 1.0])
        assert w.weights.tolist() == [2.0, 1.0] and tp.weights.tolist() == [1.0, 3.0]

    def test_single_model_spec_skips_correction(self):
        qm = tt.QuantileMap.identity(8)
        spec = tpred.PredictorSpec("s", ("m1",), (0.2,), (1.0,), qm)
        assert spec.pipeline().betas.tolist() == [1.0]
        assert not spec.is_ensemble
        with pytest.raises(ValueError):
            tpred.PredictorSpec("bad", ("m1", "m2"), (0.2,), (1.0, 1.0), qm)


class TestConvert:
    def test_bank_round_trip(self):
        jb, _ = _banks(np.random.default_rng(7))
        tb = convert.bank_from_numpy(
            *(np.asarray(getattr(jb, f)) for f in FIELDS),
            generation=jb.generation, device="cpu")
        _assert_same_bank(tb, jb)
        back = [tb_f.numpy() for tb_f in (tb.betas, tb.weights,
                                          tb.src_quantiles, tb.ref_quantiles)]
        for f, arr in zip(FIELDS, back):
            np.testing.assert_array_equal(arr, np.asarray(getattr(jb, f)))

    def test_quantile_map_round_trip(self):
        src, ref = _tables(np.random.default_rng(8), 20)
        jq = jt.QuantileMap(jnp.asarray(src), jnp.asarray(ref))
        tq = convert.quantile_map_from_numpy(np.asarray(jq.src_quantiles),
                                             np.asarray(jq.ref_quantiles),
                                             "cpu")
        np.testing.assert_array_equal(tq.src_quantiles.numpy(), src)
        np.testing.assert_array_equal(tq.ref_quantiles.numpy(), ref)

    def test_expert_round_trip(self):
        rng = np.random.default_rng(9)
        je = JExpert("m1", 0.18, rng.normal(0, 1, 16), 0.3,
                     (rng.random(16) < 0.8).astype(np.float64))
        te = convert.expert_from_numpy(**dataclasses.asdict(je))
        x = rng.normal(0, 1, (40, 16)).astype(np.float32)
        np.testing.assert_array_equal(te.score(x), je.score(x))
        np.testing.assert_allclose(te.score_fn("cpu")(x).numpy(),
                                   np.asarray(je.score_fn()(x)), **TOL)
        assert te.score_fn("cpu")(x).dtype == torch.float32
