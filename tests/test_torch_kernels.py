"""The port's banked score-pipeline entry point against the JAX package.

``repro_torch.kernels.ops.score_pipeline_banked`` on CPU tensors runs its
plain PyTorch version; it is held to the JAX package's Pallas kernel (in
interpret mode, block 64, as the JAX tests run it) and to the JAX oracle
``banked_score_pipeline`` on the same numpy inputs.  Tolerance is the
reference's own f32 kernel tolerance (``tests/test_kernels.py``):
rtol = atol = 2e-5.  ``banked_skip_stats`` must match exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.transforms import TransformBank as JBank
from repro.core.transforms import banked_score_pipeline as j_banked
from repro.kernels import ops as jops
from repro.kernels.score_pipeline import banked_skip_stats as j_skip_stats
from repro_torch.core.transforms import TransformBank as TBank
from repro_torch.kernels import ops as tops
from repro_torch.kernels import score_pipeline as tsp

TOL = dict(rtol=2e-5, atol=2e-5)
BLOCK = 64


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


def _random_params(rng, t, k, n):
    betas = rng.uniform(0.05, 1.0, (t, k)).astype(np.float32)
    weights = rng.uniform(0.1, 2.0, (t, k)).astype(np.float32)
    src = np.sort(rng.uniform(0.0, 1.0, (t, n)), axis=-1).astype(np.float32)
    ref = np.sort(rng.uniform(0.0, 1.0, (t, n)), axis=-1).astype(np.float32)
    return betas, weights, src, ref


def _jax(params, scores, tid):
    """(Pallas kernel in interpret mode, jnp oracle) on numpy inputs."""
    jp = [jnp.asarray(p) for p in params]
    kern = np.asarray(jops.score_pipeline_banked(
        jnp.asarray(scores), jnp.asarray(tid), *jp, block=BLOCK))
    oracle = np.asarray(j_banked(jnp.asarray(scores), jnp.asarray(tid), *jp))
    return kern, oracle


def _torch(params, scores, tid):
    tp = [torch.tensor(p) for p in params]
    return tops.score_pipeline_banked(
        torch.tensor(scores), torch.tensor(tid), *tp).numpy()


def _check(params, scores, tid):
    got = _torch(params, scores, tid)
    kern, oracle = _jax(params, scores, tid)
    assert got.shape == tid.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, kern, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)
    return got


def _layout(name, rng, t, b):
    if name == "sorted":          # block-aligned tenant runs
        return np.repeat(np.arange(t), -(-b // t))[:b].astype(np.int32)
    if name == "interleaved":     # tenants alternate row by row
        return (np.arange(b) % t).astype(np.int32)
    if name == "mixed":           # [all-2s] [mixed] [all-0s] [mixed]
        return np.concatenate([
            np.full(64, 2), np.arange(64) % 3,
            np.zeros(64), np.arange(64) % 2]).astype(np.int32)[:b]
    if name == "random":
        return rng.integers(0, t, b).astype(np.int32)
    if name == "partial_tail":    # 17-row tail, all tenant 2
        return np.concatenate([np.arange(64) % t,
                               np.full(b - 64, 2)]).astype(np.int32)
    raise ValueError(name)


LAYOUTS = ["sorted", "interleaved", "mixed", "random", "partial_tail"]


class TestBankedParity:
    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_layouts_match_pallas_and_oracle(self, layout):
        rng = np.random.default_rng(LAYOUTS.index(layout))
        t, k, n = 3, 3, 32
        b = 64 + 17 if layout == "partial_tail" else 256
        params = _random_params(rng, t, k, n)
        scores = rng.uniform(0, 1, (b, k)).astype(np.float32)
        _check(params, scores, _layout(layout, rng, t, b))

    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_skip_stats_match_reference(self, layout):
        rng = np.random.default_rng(100 + LAYOUTS.index(layout))
        b = 64 + 17 if layout == "partial_tail" else 256
        tid = _layout(layout, rng, 3, b)
        for block in (BLOCK, 1024):
            assert tsp.banked_skip_stats(tid, block=block) == \
                j_skip_stats(tid, block=block)
            assert tops.banked_skip_stats(tid, block=block) == \
                j_skip_stats(tid, block=block)

    @pytest.mark.parametrize("t,k,n,b", [(3, 2, 32, 97), (8, 4, 64, 1000),
                                         (8, 8, 256, 300)])
    def test_random_banks(self, t, k, n, b):
        rng = np.random.default_rng(t * 1000 + b)
        params = _random_params(rng, t, k, n)
        scores = rng.uniform(0, 1, (b, k)).astype(np.float32)
        _check(params, scores, rng.integers(0, t, b).astype(np.int32))

    def test_flat_source_segments(self):
        rng = np.random.default_rng(7)
        t, k, n, b = 4, 3, 16, 512
        betas, weights, src, ref = _random_params(rng, t, k, n)
        src[:, 4:9] = src[:, 4:5]         # 5-knot plateau in every tenant
        src[1, :] = 0.5                   # tenant 1: fully degenerate table
        scores = rng.uniform(0, 1, (b, k)).astype(np.float32)
        got = _check((betas, weights, src, ref), scores,
                     rng.integers(0, t, b).astype(np.int32))
        assert np.isfinite(got).all()

    def test_ties_on_flat_knots_pick_the_reference_bucket(self):
        """Aggregates exactly on a knot, including knots of a flat source
        segment whose reference values jump: only the exact count
        #{n : a >= qs_n} lands on the right side of the jump, so the
        outputs must be EQUAL, not just close."""
        n = 16
        src = np.linspace(0, 1, n).astype(np.float32)
        src[5:8] = src[5]                 # flat source segment
        ref = np.sort(np.random.default_rng(1).uniform(0, 1, n)).astype(
            np.float32)
        params = (np.ones((1, 1), np.float32), np.ones((1, 1), np.float32),
                  src[None], ref[None])   # identity T^C and A: agg == score
        scores = src[:, None].copy()
        tid = np.zeros(n, np.int32)
        got = _torch(params, scores, tid)
        kern, oracle = _jax(params, scores, tid)
        np.testing.assert_array_equal(got, oracle)
        np.testing.assert_array_equal(got, kern)
        assert got[5] == ref[7]           # past the jump of the flat segment

    def test_scores_outside_fitted_support(self):
        rng = np.random.default_rng(11)
        t, k, n = 3, 2, 32
        betas = np.ones((t, k), np.float32)
        weights = np.ones((t, k), np.float32)
        src = np.sort(rng.uniform(0.4, 0.6, (t, n)), axis=-1).astype(np.float32)
        ref = np.sort(rng.uniform(0.2, 0.8, (t, n)), axis=-1).astype(np.float32)
        scores = np.concatenate([np.full((64, k), 0.01, np.float32),
                                 np.full((64, k), 0.99, np.float32)])
        tid = np.tile(np.arange(t, dtype=np.int32), 128 // t + 1)[:128]
        got = _check((betas, weights, src, ref), scores, tid)
        np.testing.assert_allclose(got[:64], ref[tid[:64], 0], **TOL)
        np.testing.assert_allclose(got[64:], ref[tid[64:], -1], **TOL)

    def test_nan_scores_propagate_like_the_reference(self):
        rng = np.random.default_rng(12)
        params = _random_params(rng, 3, 2, 16)
        scores = rng.uniform(0, 1, (128, 2)).astype(np.float32)
        scores[::5, 1] = np.nan
        tid = rng.integers(0, 3, 128).astype(np.int32)
        got = _torch(params, scores, tid)
        kern, oracle = _jax(params, scores, tid)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(oracle))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(kern))
        assert np.isnan(got[::5]).all()
        ok = ~np.isnan(got)
        np.testing.assert_allclose(got[ok], oracle[ok], **TOL)

    def test_single_tenant_bank(self):
        rng = np.random.default_rng(3)
        params = _random_params(rng, 1, 4, 64)
        scores = rng.uniform(0, 1, (33, 4)).astype(np.float32)
        _check(params, scores, np.zeros(33, np.int32))

    def test_ragged_from_params_banks(self):
        """Ragged K/N rows padded by each package's ``from_params`` give the
        same bank bit for bit, and the same scores."""
        rng = np.random.default_rng(5)
        raw = [(rng.uniform(0.1, 1, 2), rng.uniform(0.5, 2, 2),
                np.sort(rng.uniform(0, 1, 8)), np.sort(rng.uniform(0, 1, 8))),
               (rng.uniform(0.1, 1, 1), rng.uniform(0.5, 2, 1),
                np.sort(rng.uniform(0, 1, 16)), np.sort(rng.uniform(0, 1, 16))),
               (rng.uniform(0.1, 1, 3), rng.uniform(0.5, 2, 3),
                np.sort(rng.uniform(0, 1, 12)), np.sort(rng.uniform(0, 1, 12)))]
        raw = [tuple(np.asarray(a, np.float32) for a in row) for row in raw]
        jb = JBank.from_params([tuple(jnp.asarray(a) for a in r) for r in raw])
        tb = TBank.from_params([tuple(torch.from_numpy(a) for a in r)
                                for r in raw])
        params = []
        for name in ("betas", "weights", "src_quantiles", "ref_quantiles"):
            want = np.asarray(getattr(jb, name))
            np.testing.assert_array_equal(getattr(tb, name).numpy(), want)
            params.append(want)
        scores = rng.uniform(0, 1, (90, 3)).astype(np.float32)
        _check(tuple(params), scores, rng.integers(0, 3, 90).astype(np.int32))

    def test_batched_leading_axes(self):
        rng = np.random.default_rng(9)
        params = _random_params(rng, 4, 3, 16)
        scores = rng.uniform(0, 1, (6, 10, 3)).astype(np.float32)
        tid = rng.integers(0, 4, (6, 10)).astype(np.int32)
        got = _torch(params, scores, tid)
        assert got.shape == (6, 10)
        oracle = np.asarray(j_banked(jnp.asarray(scores), jnp.asarray(tid),
                                     *[jnp.asarray(p) for p in params]))
        np.testing.assert_allclose(got, oracle, **TOL)

    def test_tenant_idx_length_mismatch_raises(self):
        params = [torch.from_numpy(p) for p in
                  _random_params(np.random.default_rng(0), 2, 2, 8)]
        with pytest.raises(ValueError):
            tops.score_pipeline_banked(torch.zeros(4, 2),
                                       torch.zeros(3, dtype=torch.int32),
                                       *params)
        with pytest.raises(ValueError):
            jops.score_pipeline_banked(
                jnp.zeros((4, 2)), jnp.zeros((3,), jnp.int32),
                *[jnp.asarray(p.numpy()) for p in params])


class TestNoFallback:
    """The CUDA wrapper takes CUDA tensors or raises; nothing routes a
    tensor of another device to the plain version behind the caller."""

    def _params(self):
        return [torch.from_numpy(p) for p in
                _random_params(np.random.default_rng(1), 2, 2, 8)]

    def test_cuda_wrapper_rejects_cpu_tensors(self):
        before = dict(tsp.LAUNCHES)
        with pytest.raises(ValueError, match="CUDA"):
            tsp.score_pipeline_banked(torch.zeros(4, 2),
                                      torch.zeros(4, dtype=torch.int32),
                                      *self._params())
        assert tsp.LAUNCHES == before

    def test_other_devices_raise(self):
        params = [p.to("meta") for p in self._params()]
        with pytest.raises(ValueError, match="device"):
            tops.score_pipeline_banked(
                torch.zeros(4, 2, device="meta"),
                torch.zeros(4, dtype=torch.int32, device="meta"), *params)

    def test_cpu_path_counts_no_launch(self):
        before = dict(tops.LAUNCHES)
        tops.score_pipeline_banked(torch.zeros(4, 2),
                                   torch.zeros(4, dtype=torch.int32),
                                   *self._params())
        assert tops.LAUNCHES == before
        assert tops.LAUNCHES is tsp.LAUNCHES
