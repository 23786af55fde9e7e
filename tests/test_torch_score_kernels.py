"""The port's quantile-map and shared-parameter score-pipeline entry points
against the JAX package, on the CPU.

``repro_torch.kernels.ops.quantile_map`` / ``score_pipeline`` on CPU tensors
run their plain versions (``kernels/ref.py``: float32 math, the result in
the scores' dtype, as the TPU kernels compute).  They are held to the JAX
oracles (``repro.kernels.ref``) on float32 input over the reference's own
cases, and on a few cases to the Pallas kernels themselves in interpret
mode, in float32 and bfloat16 (on bfloat16 the JAX oracle rounds its
tables to bfloat16, the kernels do not).  Tolerances are the reference's
``_tol`` (``tests/test_kernels.py``): 2e-5 in float32, 2e-2 in bfloat16.
The CUDA wrappers' argument checks run here too: they raise before any
CUDA call.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quantile_map as tqm
from repro_torch.kernels import score_pipeline as tsp

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
TOL = dict(rtol=2e-5, atol=2e-5)


def _tables(n, seed=0):
    """The reference tests' tables: sorted uniform, the source on [0, 1]."""
    rng = np.random.default_rng(seed)
    src = np.sort(rng.uniform(0, 1, n)).astype(np.float32)
    refq = np.sort(rng.uniform(0, 1, n)).astype(np.float32)
    src[0], src[-1] = 0.0, 1.0
    return src, refq


def _params(rng, k):
    return (rng.uniform(0.02, 1.0, k).astype(np.float32),
            rng.uniform(0.5, 2.0, k).astype(np.float32))


def _t(*arrays, dtype=torch.float32):
    return [torch.tensor(a).to(dtype) for a in arrays]


def _j(*arrays, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrays]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("n_scores,n_q", [(16, 8), (1000, 64), (4096, 256),
                                          (333, 33)])
def test_quantile_map_matches_jax_oracle(n_scores, n_q):
    scores = np.random.default_rng(1).uniform(0, 1, n_scores).astype(
        np.float32)
    tables = _tables(n_q)
    want = jref.quantile_map(*_j(scores, *tables))
    got = tops.quantile_map(*_t(scores, *tables))
    assert got.dtype == torch.float32 and got.shape == (n_scores,)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL)


@pytest.mark.parametrize("n,k,nq", [(64, 3, 32), (1000, 8, 256), (7, 1, 8)])
def test_score_pipeline_matches_jax_oracle(n, k, nq):
    rng = np.random.default_rng(3)
    scores = rng.uniform(0.01, 0.99, (n, k)).astype(np.float32)
    params = (*_params(rng, k), *_tables(nq))
    want = jref.score_pipeline(*_j(scores, *params))
    got = tops.score_pipeline(*_t(scores, *params))
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n_scores,n_q", [(333, 33), (1000, 64)])
def test_quantile_map_matches_pallas_kernel(n_scores, n_q, dtype):
    jd, td, tol = DTYPES[dtype]
    scores = np.random.default_rng(4).uniform(-0.1, 1.1, n_scores)
    tables = _tables(n_q, seed=4)
    want = jops.quantile_map(jnp.asarray(scores, jd), *_j(*tables),
                             block=256, interpret=True)
    got = tops.quantile_map(torch.tensor(scores).to(td), *_t(*tables))
    assert got.dtype == td
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n,k,nq", [(64, 3, 32), (7, 1, 8)])
def test_score_pipeline_matches_pallas_kernel(n, k, nq, dtype):
    jd, td, tol = DTYPES[dtype]
    rng = np.random.default_rng(5)
    scores = rng.uniform(0.01, 0.99, (n, k))
    params = (*_params(rng, k), *_tables(nq, seed=5))
    want = jops.score_pipeline(jnp.asarray(scores, jd), *_j(*params),
                               block=128, interpret=True)
    got = tops.score_pipeline(torch.tensor(scores).to(td), *_t(*params))
    assert got.dtype == td and got.shape == (n,)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_batched_shapes():
    rng = np.random.default_rng(2)
    src, refq = _tables(32)
    scores = rng.uniform(0, 1, (4, 7, 9)).astype(np.float32)
    got = tops.quantile_map(*_t(scores, src, refq))
    assert got.shape == (4, 7, 9)
    np.testing.assert_allclose(
        _f32(got), _f32(jref.quantile_map(*_j(scores, src, refq))), **TOL)
    y = rng.uniform(0, 1, (4, 7, 9, 3)).astype(np.float32)
    params = (*_params(rng, 3), src, refq)
    got = tops.score_pipeline(*_t(y, *params))
    assert got.shape == (4, 7, 9)
    np.testing.assert_allclose(
        _f32(got), _f32(jref.score_pipeline(*_j(y, *params))), **TOL)


def test_scores_on_knots_are_bitwise():
    """A score ON knot j maps to qr[j] exactly in all three (the oracle,
    the Pallas kernel and the port), flat run included: s - qs[j] = 0.
    The last knot is reached by interpolating its segment and is left out:
    the kernel multiplies before it divides, the oracle does not."""
    src, refq = _tables(256, seed=6)
    src[100:120] = src[100]
    on = src[:-1].copy()
    got = _f32(tops.quantile_map(*_t(on, src, refq)))
    oracle = _f32(jref.quantile_map(*_j(on, src, refq)))
    kernel = _f32(jops.quantile_map(*_j(on, src, refq), block=256,
                                    interpret=True))
    assert np.array_equal(got, oracle) and np.array_equal(got, kernel)
    j = np.minimum((on[:, None] >= src).sum(-1) - 1, 254)
    assert np.array_equal(got, refq[j])
    one = np.ones(1, np.float32)
    got = _f32(tops.score_pipeline(*_t(on[:, None], one, one, src, refq)))
    assert np.array_equal(got, refq[j])


def test_nan_scores_map_to_nan():
    src, refq = _tables(64, seed=7)
    scores = np.random.default_rng(7).uniform(0, 1, 300).astype(np.float32)
    scores[::7] = np.nan
    got = _f32(tops.quantile_map(*_t(scores, src, refq)))
    kernel = _f32(jops.quantile_map(*_j(scores, src, refq), block=128,
                                    interpret=True))
    assert np.array_equal(np.isnan(got), np.isnan(scores))
    assert np.array_equal(np.isnan(kernel), np.isnan(scores))
    ok = ~np.isnan(scores)
    np.testing.assert_allclose(got[ok], kernel[ok], **TOL)
    y = np.random.default_rng(8).uniform(0, 1, (300, 3)).astype(np.float32)
    y[::5, 1] = np.nan
    got = _f32(tops.score_pipeline(*_t(y, *_params(np.random.default_rng(8),
                                                   3), src, refq)))
    assert np.array_equal(np.isnan(got), np.isnan(y).any(-1))


@pytest.mark.parametrize("table", ["flat_run", "all_flat", "unsorted"])
def test_degenerate_tables_match_jax_oracle(table):
    rng = np.random.default_rng(9)
    src, refq = _tables(64, seed=9)
    if table == "flat_run":
        src[10:40] = src[10]
    elif table == "all_flat":
        src[:] = 0.5
    else:
        src = rng.uniform(0, 1, 64).astype(np.float32)
    scores = rng.uniform(-0.2, 1.2, 2000).astype(np.float32)
    np.testing.assert_allclose(
        _f32(tops.quantile_map(*_t(scores, src, refq))),
        _f32(jref.quantile_map(*_j(scores, src, refq))), **TOL)
    y = rng.uniform(0, 1, (2000, 4)).astype(np.float32)
    params = (*_params(rng, 4), src, refq)
    np.testing.assert_allclose(
        _f32(tops.score_pipeline(*_t(y, *params))),
        _f32(jref.score_pipeline(*_j(y, *params))), **TOL)


def test_score_pipeline_is_monotone_in_expert_scores():
    """The pipeline keeps the ranking (tests/test_kernels.py:95-103)."""
    src, refq = _tables(64)
    base = np.linspace(0.01, 0.99, 50, dtype=np.float32)[:, None] * \
        np.ones((1, 3), np.float32)
    betas = np.asarray([0.2, 0.1, 0.5], np.float32)
    out = _f32(tops.score_pipeline(*_t(base, betas, np.ones(3, np.float32),
                                       src, refq)))
    assert (np.diff(out) >= -1e-6).all()


def test_cpu_tensors_run_the_plain_version():
    src, refq = _t(*_tables(16))
    before = dict(tops.LAUNCHES)
    tops.quantile_map(torch.rand(10), src, refq)
    tops.score_pipeline(torch.rand(10, 2), torch.ones(2), torch.ones(2), src,
                        refq)
    assert tops.LAUNCHES == before
    assert {"quantile_map", "score_pipeline"} <= set(tops.LAUNCHES)


@pytest.mark.parametrize("bad", ["cpu", "knots", "int", "table_dtype",
                                 "table_shape", "k", "empty"])
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(bad):
    src, refq = _t(*_tables(16))
    x, b, w = torch.rand(8, 3), torch.rand(3), torch.ones(3)
    match = {"cpu": "CUDA tensors", "knots": "N >= 2", "int": "dtype",
             "table_dtype": "dtype", "table_shape": "differ",
             "k": r"\(3,\)", "empty": "empty"}[bad]
    if bad == "knots":
        src, refq = src[:1], refq[:1]
    elif bad == "int":
        x = (x * 10).int()
    elif bad == "table_dtype":
        src = src.double()
    elif bad == "table_shape":
        src = src[:8]
    elif bad == "k":
        b = b[:2]
    elif bad == "empty":
        x = x[:0]
    with pytest.raises(ValueError, match=match):
        tsp.score_pipeline(x, b, w, src, refq)
    if bad != "k":
        with pytest.raises(ValueError, match=match):
            tqm.quantile_map(x[:, 0], src, refq)
