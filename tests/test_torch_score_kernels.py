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
The CUDA wrappers' argument checks, the banked kernel's host-side path
choice and a float32 emulation of the kernels' guarded bucket search run
here too: they need no card.
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


def _banked_args(seed, t=5, k=3, n=16, m=60):
    rng = np.random.default_rng(seed)
    params = (rng.uniform(0.05, 1, (t, k)), rng.uniform(0.1, 2, (t, k)),
              np.sort(rng.uniform(0, 1, (t, n)), -1),
              np.sort(rng.uniform(0, 1, (t, n)), -1))
    return rng, _t(*params), torch.tensor(rng.uniform(0, 1, (m, k)),
                                          dtype=torch.float32)


@pytest.mark.parametrize("dtype", [torch.int64, torch.int16, torch.uint8])
def test_banked_ids_of_any_integer_type_score_as_int32(dtype):
    rng, params, y = _banked_args(40)
    ids = rng.integers(0, 5, 60)
    ids[::7] = 9                           # out of range: NaN either way
    want = tops.score_pipeline_banked(y, torch.tensor(ids, dtype=torch.int32),
                                      *params)
    got = tops.score_pipeline_banked(y, torch.tensor(ids).to(dtype), *params)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(got[~torch.isnan(want)], want[~torch.isnan(want)])


def test_banked_float_ids_raise():
    _, params, y = _banked_args(41)
    with pytest.raises(ValueError, match="integer"):
        tops.score_pipeline_banked(y, torch.zeros(60), *params)


H100 = (232_448, 132)   # opt-in shared memory per block, SMs


@pytest.mark.parametrize("t,n,m,path", [
    (64, 256, 65_536, "shared"),    # bench_kernels' window and bank
    (64, 256, 1_024, "global"),     # the serve window: too few rows a SM
    (64, 256, 32_768, "shared"),    # past 200 rows an SM
    (64, 256, 26_399, "global"),
    (4096, 256, 65_536, "global"),  # chip_smoke's large bank
    (1, 2, 10 ** 6, "shared")])
def test_banked_path_choice(t, n, m, path):
    """K does not enter (beta and w are read through L1 on both paths):
    the serve window's K = 3 and bench_kernels' K = 8 take one rule."""
    assert tsp.banked_path(t, n, m, *H100) == path


def test_banked_shared_bytes_cover_the_bank():
    """Both tables (rows padded to an odd number of 16-byte quads) and a
    flag a tenant; the limit falls between T and T + 1."""
    assert tsp.banked_shared_bytes(64, 256) == 4 * 64 * (2 * 260 + 1)
    assert tsp.banked_shared_bytes(3, 33) == 4 * 3 * (2 * 36 + 1)
    assert tsp.banked_shared_bytes(3, 28) == 4 * 3 * (2 * 28 + 1)
    t = H100[0] // tsp.banked_shared_bytes(1, 256)
    assert tsp.banked_path(t, 256, 10 ** 6, *H100) == "shared"
    assert tsp.banked_path(t + 1, 256, 10 ** 6, *H100) == "global"


# The kernels' bucket (csrc/quantile_knots.cuh): search_le on a table the
# block proved non-decreasing and free of NaN, the count over every knot on
# any other.  Emulated here in float32, one table a row, and held to the
# JAX count exactly.

def _search_le(a, qs):
    """search_le: ceil(log2 N) probes, then one more compare."""
    base = torch.zeros(a.shape, dtype=torch.long)
    length = qs.shape[-1]
    while length > 1:
        half = length // 2
        probe = torch.gather(qs, -1, (base + half)[:, None])[:, 0]
        base = torch.where(a >= probe, base + half, base)
        length -= half
    return base + (a >= torch.gather(qs, -1, base[:, None])[:, 0]).long()


def _proved_sorted(qs):
    """sorted_at over every knot: each neighbour pair in order, the last
    knot a number (a NaN anywhere fails a pair)."""
    last = qs[..., -1]
    return (qs[..., :-1] <= qs[..., 1:]).all(-1) & (last == last)


def _kernel_bucket(a, qs):
    count = (a[:, None] >= qs).sum(-1)
    return torch.where(_proved_sorted(qs), _search_le(a, qs), count)


def _tables_of(kind, rng, rows, n):
    qs = np.sort(rng.uniform(0, 1, (rows, n)), -1).astype(np.float32)
    if kind == "tied":                       # flat runs, and a flat table
        qs[:, n // 4:n // 2] = qs[:, n // 4:n // 4 + 1]
        qs[::3] = 0.5
    elif kind == "unsorted":
        qs = rng.uniform(0, 1, (rows, n)).astype(np.float32)
    elif kind == "nan_knot":
        qs[np.arange(rows), rng.integers(0, n, rows)] = np.nan
    elif kind == "mixed":                    # one of each, row by row
        qs[1::4] = rng.uniform(0, 1, (len(qs[1::4]), n))
        qs[2::4, n // 3] = np.nan
        qs[3::4, 2:n - 1] = qs[3::4, 2:3]
    return qs


def _aggregates(rng, qs):
    rows, n = qs.shape
    a = rng.uniform(-0.2, 1.2, rows).astype(np.float32)
    a[::5] = qs[::5, rng.integers(0, n)]     # on a knot
    a[1::11] = np.nan
    a[2::13] = np.inf
    a[3::17] = -np.inf
    return a


@pytest.mark.parametrize("n", [2, 3, 33, 256])
@pytest.mark.parametrize("kind", ["sorted", "tied", "unsorted", "nan_knot",
                                  "mixed"])
def test_guarded_search_is_the_jax_count(kind, n):
    rng = np.random.default_rng(n)
    qs = _tables_of(kind, rng, 400, n)
    a = _aggregates(rng, qs)
    want = np.asarray(jnp.sum(jnp.asarray(a)[:, None] >= jnp.asarray(qs),
                              axis=-1))
    got = _kernel_bucket(torch.from_numpy(a), torch.from_numpy(qs))
    assert np.array_equal(got.numpy(), want)
    if kind == "sorted":
        assert _proved_sorted(torch.from_numpy(qs)).all()
    elif kind in ("unsorted", "nan_knot") and n >= 33:
        # the guard is what keeps these right: the bare search is not
        assert not _proved_sorted(torch.from_numpy(qs)).any()
        bare = _search_le(torch.from_numpy(a), torch.from_numpy(qs))
        assert not np.array_equal(bare.numpy(), want)


def test_guarded_search_through_the_interpolation_matches_jax():
    """The guarded bucket through T^Q's interpolation gives the JAX
    oracle's scores, one table a row, on every kind of table."""
    rng = np.random.default_rng(3)
    kinds = ["sorted", "tied", "unsorted", "nan_knot", "mixed"]
    qs = np.concatenate([_tables_of(k, rng, 80, 64) for k in kinds])
    qr = np.sort(rng.uniform(0, 1, qs.shape), -1).astype(np.float32)
    y = _aggregates(rng, qs)
    tqs, tqr, ty = torch.from_numpy(qs), torch.from_numpy(qr), \
        torch.from_numpy(y)
    # K = 1, beta = w = 1: T^C and A as the kernel runs them (an infinite
    # score becomes NaN there: 0 * inf)
    ta = 0.0 + (1.0 * ty) / (1.0 - (1.0 - 1.0) * ty) * 1.0
    j = torch.clamp(_kernel_bucket(ta, tqs) - 1, 0, 62)[:, None]
    qs_i, qs_n = tqs.gather(-1, j)[:, 0], tqs.gather(-1, j + 1)[:, 0]
    qr_i, qr_n = tqr.gather(-1, j)[:, 0], tqr.gather(-1, j + 1)[:, 0]
    d = torch.where(qs_n - qs_i > 0, qs_n - qs_i, torch.ones_like(qs_i))
    got = torch.clamp(qr_i + (ta - qs_i) * (qr_n - qr_i) / d, tqr[:, 0],
                      tqr[:, -1])
    t = np.arange(len(y), dtype=np.int32)
    ones = jnp.ones((len(y), 1), jnp.float32)
    want = np.asarray(jref.score_pipeline_banked(
        jnp.asarray(y)[:, None], jnp.asarray(t), ones, ones,
        jnp.asarray(qs), jnp.asarray(qr)))
    assert np.array_equal(np.isnan(got.numpy()), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got.numpy()[ok], want[ok], **TOL)
