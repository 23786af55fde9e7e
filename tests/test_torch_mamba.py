"""The port's Mamba mixer (``models/mamba.py``), its scan's plain version
(``kernels/ref.py::selective_scan``) and the jamba smoke model against the
JAX package, on the CPU.

The mixer on the reference's converted weights, float32 within rtol = atol
= 1e-4 and bfloat16 within 5e-2: the forward with T no multiple of the
reference's ``chunk_size`` (a small one is passed to it), with and without
an initial state, a sequence split in two equal to the whole, the conv tail
of ``return_state`` (T shorter than d_conv - 1 too), the decode step, and
eight decode steps after a prefill equal to the forward.  The plain scan
against the reference's own chunk step (``_ssm_chunk``) on the same float32
inputs.  The jamba smoke model (one Mamba + MLP and one attention + MoE
block; capacity factor 2.0 drops nothing, so float32 routes are
deterministic): converted weights, prefill and decode against the JAX
model, and the serve launcher in a subprocess.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.models import mamba as j_m
from repro.models.model import Model as JModel
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels import selective_scan as ss
from repro_torch.models import mamba as t_m
from repro_torch.models.model import Model

ROOT = pathlib.Path(__file__).resolve().parents[1]
F32 = dict(rtol=1e-4, atol=1e-4)
RISK = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)
DTYPES = {"float32": (jnp.float32, torch.float32, F32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16)}
ARCH = "jamba-1.5-large-398b"
D_MODEL = 64       # the mixer's own tests: d_in 128, N 8, d_conv 4


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _mc():
    return get_smoke_config(ARCH).mamba


def _mixer(seed=1, dtype=torch.float32):
    """The reference's ``init_mamba`` weights and the port's mixer holding
    them."""
    jmc = j_smoke(ARCH).mamba
    params = j_m.init_mamba(jax.random.key(seed), D_MODEL, jmc)
    mod = t_m.Mamba(D_MODEL, _mc(), device="cpu", dtype=dtype)
    convert._copy_module(mod, jax.tree.map(lambda a: np.asarray(a)[None],
                                           params), 0)
    return jmc, params, mod


def _x(t, seed=0, batch=2):
    return np.random.default_rng(seed).standard_normal(
        (batch, t, D_MODEL)).astype(np.float32)


def _state(jstate, dtype=torch.float32):
    return t_m.MambaState(conv=torch.tensor(_np(jstate.conv)).to(dtype),
                          ssm=torch.tensor(_np(jstate.ssm)))


def _states_close(got, want, tol):
    assert tuple(got.conv.shape) == want.conv.shape
    assert got.ssm.dtype == torch.float32
    _close(got.conv, want.conv, tol)
    _close(got.ssm, want.ssm, tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("t,chunk", [(21, 8), (16, 8), (5, 256)])
def test_forward_matches_reference(t, chunk, dtype):
    """T = 21 over chunks of 8 (a 5-step tail the reference pads), 16 (two
    whole chunks) and 5 (one short chunk): out and the final state."""
    jd, td, tol = DTYPES[dtype]
    jmc, params, mod = _mixer()
    x = _x(t)
    want, jstate = j_m.mamba_forward(params, jnp.asarray(x).astype(jd), jmc,
                                     chunk_size=chunk, return_state=True)
    got, state = t_m.mamba_forward(mod, torch.tensor(x).to(td), _mc(),
                                   return_state=True)
    assert got.dtype == td and state.conv.dtype == td
    _close(got, want, tol)
    _states_close(state, jstate, tol)


def test_forward_continues_from_an_initial_state():
    """13 tokens, then 11 more from the first call's state: the second
    call's out and state equal the reference's same two calls, and the two
    calls together the one call over 24 tokens."""
    jmc, params, mod = _mixer()
    x = _x(24, seed=3)
    _, js1 = j_m.mamba_forward(params, jnp.asarray(x[:, :13]), jmc,
                               chunk_size=8, return_state=True)
    want, js2 = j_m.mamba_forward(params, jnp.asarray(x[:, 13:]), jmc,
                                  chunk_size=8, initial_state=js1,
                                  return_state=True)
    first, s1 = t_m.mamba_forward(mod, torch.tensor(x[:, :13]), _mc(),
                                  return_state=True)
    _states_close(s1, js1, F32)
    second, s2 = t_m.mamba_forward(mod, torch.tensor(x[:, 13:]), _mc(),
                                   initial_state=s1, return_state=True)
    _close(second, want, F32)
    _states_close(s2, js2, F32)
    whole, s_whole = t_m.mamba_forward(mod, torch.tensor(x), _mc(),
                                       return_state=True)
    _close(torch.cat([first, second], dim=1), whole, F32)
    _close(s2.ssm, s_whole.ssm, F32)
    assert torch.equal(s2.conv, s_whole.conv)


@pytest.mark.parametrize("t", [1, 2, 3, 7])
@pytest.mark.parametrize("continued", [False, True])
def test_conv_tail_matches_reference(t, continued):
    """The tail ``return_state`` keeps: the last d_conv - 1 = 3 inputs
    before the conv, left-padded with zeros when T < 3, or taken across
    the initial state's tail when one is given."""
    jmc, params, mod = _mixer()
    x = _x(t + 4, seed=t)
    jinit = tinit = None
    if continued:
        _, jinit = j_m.mamba_forward(params, jnp.asarray(x[:, :4]), jmc,
                                     return_state=True)
        tinit = _state(jinit)
    want, jstate = j_m.mamba_forward(params, jnp.asarray(x[:, 4:]), jmc,
                                     initial_state=jinit, return_state=True)
    got, state = t_m.mamba_forward(mod, torch.tensor(x[:, 4:]), _mc(),
                                   initial_state=tinit, return_state=True)
    assert tuple(state.conv.shape) == (2, 3, 2 * D_MODEL)
    _close(state.conv, jstate.conv, F32)
    pad = 0 if continued else max(3 - t, 0)
    assert not state.conv[:, :pad].any() and state.conv[:, pad:].all()
    _close(got, want, F32)
    _close(state.ssm, jstate.ssm, F32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_step_matches_reference(dtype):
    """One step from a prefilled state: out, the new conv tail and the new
    SSM state, which the port writes into the state it was given."""
    jd, td, tol = DTYPES[dtype]
    jmc, params, mod = _mixer()
    x = _x(10, seed=5)
    _, jstate = j_m.mamba_forward(params, jnp.asarray(x[:, :9]).astype(jd),
                                  jmc, return_state=True)
    want, jnew = j_m.mamba_decode_step(
        params, jnp.asarray(x[:, 9:]).astype(jd), jmc, jstate)
    state = _state(jstate, td)
    ssm = state.ssm
    got, new = t_m.mamba_decode_step(mod, torch.tensor(x[:, 9:]).to(td),
                                     _mc(), state)
    assert got.dtype == td and new.ssm is ssm   # written in place
    _close(got, want, tol)
    _states_close(new, jnew, tol)


def test_decode_steps_after_a_prefill_equal_the_forward():
    """Eight decode steps after a 12-token prefill: each step's out equals
    the forward's at its position, and the reference's own steps."""
    jmc, params, mod = _mixer()
    x = _x(20, seed=6)
    full, _ = t_m.mamba_forward(mod, torch.tensor(x), _mc())
    _, state = t_m.mamba_forward(mod, torch.tensor(x[:, :12]), _mc(),
                                 return_state=True)
    _, jstate = j_m.mamba_forward(params, jnp.asarray(x[:, :12]), jmc,
                                  return_state=True)
    for s in range(12, 20):
        out, state = t_m.mamba_decode_step(mod, torch.tensor(x[:, s:s + 1]),
                                           _mc(), state)
        want, jstate = j_m.mamba_decode_step(
            params, jnp.asarray(x[:, s:s + 1]), jmc, jstate)
        _close(out, full[:, s:s + 1], F32)
        _close(out, want, F32)
    _states_close(state, jstate, F32)


def _scan_inputs(b, t, c, n, seed):
    rng = np.random.default_rng(seed)
    dt = rng.uniform(0.001, 0.2, (b, t, c)).astype(np.float32)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    bm = rng.standard_normal((b, t, n)).astype(np.float32)
    cm = rng.standard_normal((b, t, n)).astype(np.float32)
    a = -np.tile(np.arange(1, n + 1, dtype=np.float32), (c, 1))
    h0 = rng.standard_normal((b, c, n)).astype(np.float32)
    return dt, x, bm, cm, a, h0


def _reference_scan(dt, x, bm, cm, a, h0, q):
    """The reference's ``chunk_step`` (``mamba.py:148-154``) over chunks of
    q, the last one short, carrying h."""
    h, ys = jnp.asarray(h0), []
    for s in range(0, dt.shape[1], q):
        dt_i, xc_i = jnp.asarray(dt[:, s:s + q]), jnp.asarray(x[:, s:s + q])
        b_i, c_i = jnp.asarray(bm[:, s:s + q]), jnp.asarray(cm[:, s:s + q])
        abar = jnp.exp(dt_i[..., None] * jnp.asarray(a))
        bx = (dt_i * xc_i)[..., None] * b_i[:, :, None, :]
        h_seq, h = j_m._ssm_chunk(abar, bx, h)
        ys.append(jnp.einsum("bqcn,bqn->bqc", h_seq, c_i))
    return jnp.concatenate(ys, axis=1), h


@pytest.mark.parametrize("t,n,given", [(1, 16, True), (70, 8, False),
                                       (130, 16, True), (64, 4, False),
                                       (37, 1, True), (19, 3, False),
                                       (45, 5, True)])
def test_plain_scan_matches_the_references(t, n, given):
    """T = 1, T across the plain version's 16-step chunks and not a
    multiple of 16, 64 or the reference's 32, N = 1 / 3 / 4 / 5 / 8 / 16,
    h0 given or zeros."""
    dt, x, bm, cm, a, h0 = _scan_inputs(2, t, 24, n, seed=t)
    h0 = h0 if given else np.zeros_like(h0)
    want_y, want_h = _reference_scan(dt, x, bm, cm, a, h0, q=32)
    args = [torch.tensor(v) for v in (dt, x, bm, cm, a)]
    y, h = ref.selective_scan(*args, torch.tensor(h0) if given else None)
    assert y.shape == (2, t, 24) and h.shape == (2, 24, n)
    assert h.is_contiguous()
    _close(y, want_y, F32)
    _close(h, want_h, F32)


def test_ops_scan_writes_an_aliased_state_in_place():
    """On CPU tensors ``ops.selective_scan`` runs the plain version and
    writes h_T into ``state_out``, which may be h0 itself; no kernel
    launches."""
    dt, x, bm, cm, a, h0 = _scan_inputs(3, 1, 40, 16, seed=9)
    args = [torch.tensor(v) for v in (dt, x, bm, cm, a)]
    want_y, want_h = ref.selective_scan(*args, torch.tensor(h0))
    state = torch.tensor(h0)
    before = dict(ops.LAUNCHES)
    y, h = ops.selective_scan(*args, state, state_out=state)
    assert ops.LAUNCHES == before and "selective_scan" in ops.LAUNCHES
    assert h is state
    assert torch.equal(y, want_y) and torch.equal(state, want_h)


@pytest.mark.parametrize("bad", ["bf16", "strided", "n17", "shape", "h0",
                                 "cpu"])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(bad):
    dt, x, bm, cm, a, h0 = (torch.tensor(v) for v in
                            _scan_inputs(2, 5, 8, 16, seed=1))
    kw = {}
    if bad == "bf16":
        x = x.to(torch.bfloat16)
    elif bad == "strided":
        bm = torch.cat([bm, cm], dim=-1)[..., :16]
    elif bad == "n17":
        a, bm, cm = (torch.zeros(v.shape[:-1] + (17,)) for v in (a, bm, cm))
    elif bad == "shape":
        dt = dt[:, :4].contiguous()
    elif bad == "h0":
        kw["state_out"] = h0[:1].contiguous()
    with pytest.raises(ValueError):
        ss.selective_scan(dt, x, bm, cm, a, h0, **kw)


def test_reset_parameters_is_the_references_init():
    """A_log = log(1..N) a row, D = 1, conv_b = 0, and dt = softplus(
    dt_bias) within the reference's [0.001, 0.1]."""
    mod = t_m.Mamba(D_MODEL, _mc(), device="cpu")
    mod.reset_parameters(torch.Generator().manual_seed(0))
    n = _mc().d_state
    assert torch.equal(mod.A_log, torch.log(torch.arange(
        1, n + 1, dtype=torch.float32)).expand(2 * D_MODEL, n))
    assert torch.equal(mod.D, torch.ones(2 * D_MODEL))
    assert torch.equal(mod.conv_b, torch.zeros(2 * D_MODEL))
    dt = torch.nn.functional.softplus(mod.dt_bias)
    assert float(dt.min()) >= 0.001 * (1 - 1e-5)
    assert float(dt.max()) <= 0.1 * (1 + 1e-5)


# ---------------------------------------------------------------- models

def _pair(seed=42):
    jm = JModel(j_smoke(ARCH))
    params = jm.init(jax.random.key(seed))
    tm = convert.model_from_numpy(get_smoke_config(ARCH),
                                  jax.tree.map(np.asarray, params),
                                  device="cpu")
    return jm, params, tm


def _tokens(cfg, seq, seed=0, batch=2):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    return jnp.asarray(toks), torch.tensor(toks, dtype=torch.long)


def test_model_from_numpy_copies_every_mamba_leaf():
    """jamba smoke: each Mamba leaf of the converted model is the
    reference's, the linears transposed, conv_w (K, C) and A_log (C, N)
    as they are; the parameter counts agree."""
    jm, params, tm = _pair()
    src = params["stack"][0]["mixer"]
    mixer = tm.stack[0].mixer
    for name in ("in_proj", "x_proj", "dt_proj", "out_proj"):
        np.testing.assert_array_equal(
            getattr(mixer, name).weight.numpy(),
            np.asarray(src[name]["w"][0]).T)
    for name in ("conv_w", "conv_b", "dt_bias", "A_log", "D"):
        np.testing.assert_array_equal(getattr(mixer, name).numpy(),
                                      np.asarray(src[name][0]))
    assert tm.param_count() == jm.param_count(params)


def test_smoke_forward_matches_reference():
    jm, params, tm = _pair()
    jt, tt = _tokens(tm.cfg, 24)
    want = jm.forward(params, tokens=jt, compute_dtype=jnp.float32)
    got = tm(tt, compute_dtype=torch.float32)
    _close(got.logits, want.logits, F32)
    _close(got.risk_score, want.risk_score, RISK)
    _close(got.moe_aux, want.moe_aux, RISK)


def test_smoke_prefill_and_decode_match_reference():
    """float32 prefill of 24 tokens and 4 decode steps: logits, risk, the
    Mamba state of the cache after each step (conv tail and SSM state)."""
    jm, params, tm = _pair()
    t, steps = 24, 4
    jt, tt = _tokens(tm.cfg, t + steps, seed=7)
    kw = dict(cache_capacity=t + steps)
    jout, jcache = jm.prefill(params, tokens=jt[:, :t], **kw,
                              compute_dtype=jnp.float32,
                              cache_dtype=jnp.float32)
    tout, tcache = tm.prefill(tt[:, :t], **kw, compute_dtype=torch.float32)
    _close(tout.logits, jout.logits, F32)
    _close(tout.risk_score, jout.risk_score, RISK)
    assert type(tcache[0]).__name__ == "MambaState"
    _states_close(tcache[0], jcache[0], F32)
    ssm = tcache[0].ssm
    for s in range(steps):
        jdec = jm.decode_step(params, jcache, tokens=jt[:, t + s:t + s + 1],
                              pos=t + s, compute_dtype=jnp.float32)
        tdec = tm.decode_step(tcache, tt[:, t + s:t + s + 1], pos=t + s,
                              compute_dtype=torch.float32)
        jcache, tcache = jdec.cache, tdec.cache
        assert tcache[0].ssm is ssm           # the cache is written in place
        _close(tdec.logits, jdec.logits, F32)
        _close(tdec.risk_score, jdec.risk_score, RISK)
        _states_close(tcache[0], jcache[0], F32)


def test_decode_writes_the_ssm_state_once(monkeypatch):
    """A decode step writes each Mamba layer's SSM state into the cache
    once (here the CPU branch of ``ops.selective_scan`` into its aliased
    ``state_out``): the stack copies back only the leaves a mixer returns
    anew, not the one it wrote in place."""
    _, _, tm = _pair()
    t = 24
    _, tt = _tokens(tm.cfg, t + 1, seed=7)
    _, cache = tm.prefill(tt[:, :t], cache_capacity=t + 1,
                          compute_dtype=torch.float32)
    ssm = [c.ssm for c in cache if type(c).__name__ == "MambaState"]
    n_mamba = sum(s.mixer == "mamba" for s in tm.cfg.layer_pattern)
    assert len(ssm) == n_mamba >= 1
    storages = {a.untyped_storage().data_ptr() for a in ssm}
    writes = []
    copy = torch.Tensor.copy_

    def spy(dst, src, *args, **kw):
        if dst.untyped_storage().data_ptr() in storages:
            writes.append(dst.data_ptr())
        return copy(dst, src, *args, **kw)

    monkeypatch.setattr(torch.Tensor, "copy_", spy)
    tm.decode_step(cache, tt[:, t:t + 1], pos=t, compute_dtype=torch.float32)
    monkeypatch.undo()
    assert len(writes) == len(set(writes)) == n_mamba * tm.cfg.n_groups


def test_smoke_decode_matches_forward():
    """Three decode steps after a prefill track the full forward."""
    _, _, tm = _pair()
    t, steps = 24, 3
    _, tt = _tokens(tm.cfg, t + steps, seed=7)
    full = tm(tt, compute_dtype=torch.float32)
    _, cache = tm.prefill(tt[:, :t], cache_capacity=t + steps,
                          compute_dtype=torch.float32)
    for s in range(steps):
        dec = tm.decode_step(cache, tt[:, t + s:t + s + 1], pos=t + s,
                             compute_dtype=torch.float32)
        cache = dec.cache
        torch.testing.assert_close(dec.logits, full.logits[:, t + s],
                                   rtol=2e-3, atol=2e-3)


def _cut(cfg):
    """jamba's first five layers (positions 0-4 of its period)."""
    return dataclasses.replace(cfg, n_layers=5,
                               layer_pattern=cfg.layer_pattern[:5])


@pytest.mark.parametrize("cut", [False, True])
def test_full_width_param_count_is_the_references(cut):
    """The full config, and its five-layer cut served on the card, built on
    the ``meta`` device: exactly the parameters of the reference's
    ``init`` (its shapes, by ``jax.eval_shape``)."""
    tcfg, jcfg = get_config(ARCH), j_config(ARCH)
    if cut:
        tcfg, jcfg = _cut(tcfg), _cut(jcfg)
    tm = Model(tcfg, device="meta", seed=None)
    shapes = jax.eval_shape(JModel(jcfg).init, jax.random.key(0))
    assert tm.param_count() == sum(int(np.prod(a.shape))
                                   for a in jax.tree.leaves(shapes))
    if cut:
        assert tcfg.param_count() == 24_045_592_577
        assert [b.spec.mixer for b in tm.stack] == ["mamba"] * 4 + ["attn"]


def test_serve_launcher_runs_jamba_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--prompt-len", "16",
         "--decode-steps", "2"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr
    assert "prefill 4x16" in proc.stdout
    line = proc.stdout.strip().splitlines()[-1]
    scores = [float(x) for x in line.split("[")[1].rstrip("]").split()]
    assert len(scores) == 4 and all(0.0 <= s <= 1.0 for s in scores)
