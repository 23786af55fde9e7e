"""The port's xLSTM mixers (``models/xlstm.py``) and the xlstm-1.3b smoke
model against the JAX package, on the CPU.

mLSTM and sLSTM forward and decode steps on the reference's converted
weights, float32 within rtol = atol = 1e-4 and bfloat16 within 5e-2, with
their final and carried states: a T shorter than the chunk, a multiple of
it and one that is not (the reference pads the last chunk; the port runs it
short), and a state carried from one call into the next.  The smoke model
(one sLSTM and one mLSTM block): forward, prefill and decode against the
JAX model (logits 1e-4, risk 1e-5), and decode against the port's own
forward as the reference's smoke tests hold it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import xlstm as j_x
from repro.models.model import Model as JModel
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import xlstm as t_x
from repro_torch.models.model import Model

F32 = dict(rtol=1e-4, atol=1e-4)
RISK = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)
DTYPES = {"float32": (jnp.float32, torch.float32, F32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16)}
ARCH = "xlstm-1.3b"


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _states_close(got, want, tol):
    assert type(got).__name__ == type(want).__name__
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        _close(g, w, tol)


def _grouped(params):
    return jax.tree.map(lambda a: np.asarray(a)[None], params)


def _mlstm(seed=1):
    cfg = j_smoke(ARCH)
    params = j_x.init_mlstm(jax.random.key(seed), cfg.d_model, cfg.n_heads,
                            cfg.xlstm)
    mod = t_x.MLSTM(cfg.d_model, cfg.n_heads, get_smoke_config(ARCH).xlstm,
                    device="cpu")
    convert._copy_mlstm(mod, _grouped(params), 0)
    return cfg, params, mod


def _slstm(seed=2):
    cfg = j_smoke(ARCH)
    params = j_x.init_slstm(jax.random.key(seed), cfg.d_model, cfg.xlstm)
    mod = t_x.SLSTM(cfg.d_model, get_smoke_config(ARCH).xlstm, device="cpu")
    convert._copy_slstm(mod, _grouped(params), 0)
    return cfg, params, mod


def mod_xc():
    return get_smoke_config(ARCH).xlstm


def _x(t, d=128, seed=0, scale=0.5):
    return (scale * np.random.default_rng(seed).standard_normal(
        (2, t, d))).astype(np.float32)


def test_mlstm_head_width_is_d_in_over_heads():
    full = get_config(ARCH)
    mod = t_x.MLSTM(full.d_model, full.n_heads, full.xlstm, device="meta")
    assert tuple(mod.wq.shape) == (4, 1024, 1024) != (4, full.head_dim,
                                                      full.head_dim)
    assert tuple(t_x.init_mlstm_state(1, full.d_model, full.n_heads,
                                      full.xlstm, "meta").c.shape) \
        == (1, 4, 1024, 1024)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("t", [24, 64, 70])
def test_mlstm_forward_matches_reference(t, dtype):
    """T = 24 (one short chunk), 64 (two of 32), 70 (two and a 6-token
    tail): out and the final state."""
    jd, td, tol = DTYPES[dtype]
    cfg, params, mod = _mlstm()
    x = _x(t)
    want, want_state = j_x.mlstm_forward(
        params, jnp.asarray(x).astype(jd), cfg.n_heads, cfg.xlstm,
        return_state=True)
    got, state = t_x.mlstm_forward(mod, torch.tensor(x).to(td), cfg.n_heads,
                                   mod_xc(), return_state=True)
    assert got.dtype == td
    _close(got, want, tol)
    _states_close(state, want_state, tol)


def test_mlstm_state_carries_across_calls():
    """40 tokens then 30 more from the first call's state: the second
    call's out and state equal the reference's same two calls, and the
    state after both the one-call state over 70 tokens."""
    cfg, params, mod = _mlstm()
    x = _x(70, seed=3)
    _, js1 = j_x.mlstm_forward(params, jnp.asarray(x[:, :40]), cfg.n_heads,
                               cfg.xlstm, return_state=True)
    want, js2 = j_x.mlstm_forward(params, jnp.asarray(x[:, 40:]),
                                  cfg.n_heads, cfg.xlstm, initial_state=js1,
                                  return_state=True)
    _, ts1 = t_x.mlstm_forward(mod, torch.tensor(x[:, :40]), cfg.n_heads,
                               mod_xc(), return_state=True)
    got, ts2 = t_x.mlstm_forward(mod, torch.tensor(x[:, 40:]), cfg.n_heads,
                                 mod_xc(), initial_state=ts1,
                                 return_state=True)
    _close(got, want, F32)
    _states_close(ts2, js2, F32)
    _, whole = t_x.mlstm_forward(mod, torch.tensor(x), cfg.n_heads,
                                 mod_xc(), return_state=True)
    for got_leaf, whole_leaf in zip(ts2, whole):
        torch.testing.assert_close(got_leaf, whole_leaf, **F32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mlstm_decode_step_matches_reference(dtype):
    """Three decode steps from the state of a 37-token forward."""
    jd, td, tol = DTYPES[dtype]
    cfg, params, mod = _mlstm()
    x = _x(40, seed=5)
    _, jstate = j_x.mlstm_forward(params, jnp.asarray(x[:, :37]).astype(jd),
                                  cfg.n_heads, cfg.xlstm, return_state=True)
    _, tstate = t_x.mlstm_forward(mod, torch.tensor(x[:, :37]).to(td),
                                  cfg.n_heads, mod_xc(), return_state=True)
    for s in range(37, 40):
        want, jstate = j_x.mlstm_decode_step(
            params, jnp.asarray(x[:, s:s + 1]).astype(jd), cfg.n_heads,
            cfg.xlstm, jstate)
        got, tstate = t_x.mlstm_decode_step(
            mod, torch.tensor(x[:, s:s + 1]).to(td), cfg.n_heads, mod_xc(),
            tstate)
        assert got.dtype == td
        _close(got, want, tol)
        _states_close(tstate, jstate, tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("t", [1, 24, 45])
def test_slstm_forward_matches_reference(t, dtype):
    jd, td, tol = DTYPES[dtype]
    cfg, params, mod = _slstm()
    x = _x(t, seed=7, scale=1.0)
    want, want_state = j_x.slstm_forward(params, jnp.asarray(x).astype(jd),
                                         cfg.xlstm, return_state=True)
    got, state = t_x.slstm_forward(mod, torch.tensor(x).to(td), mod_xc(),
                                   return_state=True)
    assert got.dtype == td
    _close(got, want, tol)
    _states_close(state, want_state, tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_slstm_decode_and_carried_state_match_reference(dtype):
    """A forward over 20 tokens, a second forward from its state, then
    three decode steps: outs and states against the reference's."""
    jd, td, tol = DTYPES[dtype]
    cfg, params, mod = _slstm()
    x = _x(33, seed=8, scale=1.0)
    xj, xt = jnp.asarray(x).astype(jd), torch.tensor(x).to(td)
    _, js = j_x.slstm_forward(params, xj[:, :20], cfg.xlstm,
                              return_state=True)
    _, ts = t_x.slstm_forward(mod, xt[:, :20], mod_xc(), return_state=True)
    want, js = j_x.slstm_forward(params, xj[:, 20:30], cfg.xlstm,
                                 initial_state=js, return_state=True)
    got, ts = t_x.slstm_forward(mod, xt[:, 20:30], mod_xc(),
                                initial_state=ts, return_state=True)
    _close(got, want, tol)
    _states_close(ts, js, tol)
    for s in range(30, 33):
        want, js = j_x.slstm_decode_step(params, xj[:, s:s + 1], cfg.xlstm,
                                         js)
        got, ts = t_x.slstm_decode_step(mod, xt[:, s:s + 1], mod_xc(), ts)
        _close(got, want, tol)
        _states_close(ts, js, tol)


# ---------------------------------------------------------------- model

@pytest.fixture(scope="module")
def pair():
    jm = JModel(j_smoke(ARCH))
    params = jm.init(jax.random.key(42))
    tm = convert.model_from_numpy(get_smoke_config(ARCH),
                                  jax.tree.map(np.asarray, params),
                                  device="cpu")
    return jm, params, tm


def _tokens(seq, seed):
    toks = np.random.default_rng(seed).integers(0, 512, (2, seq)).astype(
        np.int32)
    return jnp.asarray(toks), torch.tensor(toks, dtype=torch.long)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_smoke_forward_matches_reference(pair, dtype):
    jd, td, tol = DTYPES[dtype]
    jm, params, tm = pair
    jt, tt = _tokens(40, seed=0)
    want = jm.forward(params, tokens=jt, compute_dtype=jd)
    got = tm(tt, compute_dtype=td)
    _close(got.logits, want.logits, tol)
    _close(got.risk_score, want.risk_score,
           RISK if dtype == "float32" else tol)
    assert float(got.moe_aux) == 0.0
    assert tm.param_count() == jm.param_count(params)


def test_prefill_and_decode_match_reference(pair):
    """A 37-token prefill (one full chunk of 32 and a tail), its cache of
    states against the reference's, then three decode steps."""
    jm, params, tm = pair
    t, steps = 37, 3
    jt, tt = _tokens(t + steps, seed=1)
    kw = dict(cache_capacity=t + steps)
    jout, jcache = jm.prefill(params, tokens=jt[:, :t], **kw,
                              compute_dtype=jnp.float32,
                              cache_dtype=jnp.float32)
    tout, tcache = tm.prefill(tt[:, :t], **kw, compute_dtype=torch.float32,
                              cache_dtype=torch.float32)
    _close(tout.logits, jout.logits, F32)
    for jc, tc in zip(jcache, tcache):
        _states_close(tc, jc, F32)
    for s in range(steps):
        jdec = jm.decode_step(params, jcache, tokens=jt[:, t + s:t + s + 1],
                              pos=t + s, compute_dtype=jnp.float32)
        tdec = tm.decode_step(tcache, tt[:, t + s:t + s + 1], pos=t + s,
                              compute_dtype=torch.float32)
        jcache, tcache = jdec.cache, tdec.cache
        _close(tdec.logits, jdec.logits, F32)
        _close(tdec.risk_score, jdec.risk_score, RISK)
        for jc, tc in zip(jcache, tcache):
            _states_close(tc, jc, F32)


def test_init_cache_stacks_states_over_groups():
    cfg = get_smoke_config(ARCH)
    cache = Model(cfg, device="cpu").init_cache(3, 10)
    assert [type(c).__name__ for c in cache] == ["SLSTMState", "MLSTMState"]
    assert tuple(cache[0].m.shape) == (cfg.n_groups, 3, cfg.d_model)
    assert tuple(cache[1].c.shape) == (cfg.n_groups, 3, 2, 128, 128)
    assert all(a.dtype == torch.float32 for c in cache for a in c)
    assert len({a.data_ptr() for a in cache[0]}) == 4


def test_decode_matches_forward(pair):
    """The reference's ``test_decode_matches_forward`` and
    ``test_multi_step_decode_matches_forward`` on the port (2e-3 / 3e-3)."""
    _, _, tm = pair
    t, steps = 24, 3
    _, tt = _tokens(t + steps, seed=7)
    full = tm(tt, compute_dtype=torch.float32)
    _, cache = tm.prefill(tt[:, :t], cache_capacity=t + steps,
                          compute_dtype=torch.float32,
                          cache_dtype=torch.float32)
    for s in range(steps):
        dec = tm.decode_step(cache, tt[:, t + s:t + s + 1], pos=t + s,
                             compute_dtype=torch.float32)
        cache = dec.cache
        tol = 2e-3 if s == 0 else 3e-3
        torch.testing.assert_close(dec.logits, full.logits[:, t + s],
                                   rtol=tol, atol=tol)
