"""The port's dense model zoo against the JAX package, on the CPU.

Each smoke config of the dense and encoder attention + MLP family is built
in the JAX package from ``jax.random.key(42)``, converted with
``convert.model_from_numpy`` (``jax.random`` and ``torch.Generator`` draw
different weights, so parity always goes through the converter), and both
run in float32 on the same numpy-seeded inputs.  Logits must agree within
rtol = atol = 1e-4 and risk scores within 1e-5.
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

from repro.configs import get_smoke_config as j_smoke
from repro.models.model import Model as JModel
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import model_from_numpy
from repro_torch.kernels import ops
from repro_torch.models.model import Model

ROOT = pathlib.Path(__file__).resolve().parents[1]
DENSE = ("qwen3-8b", "internlm2-1.8b", "llama3-405b", "deepseek-coder-33b",
         "hubert-xlarge", "qwen2-vl-7b")
LOGITS = dict(rtol=1e-4, atol=1e-4)
RISK = dict(rtol=1e-5, atol=1e-5)
B, T = 2, 24


def _pair(arch, *, window=0):
    jcfg, tcfg = j_smoke(arch), get_smoke_config(arch)
    if window:
        jcfg = dataclasses.replace(jcfg, sliding_window=window)
        tcfg = dataclasses.replace(tcfg, sliding_window=window)
    jm = JModel(jcfg)
    params = jm.init(jax.random.key(42))
    tm = model_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                          device="cpu", dtype=torch.float32)
    return jm, params, tm


def _inputs(cfg, seq, seed=0, batch=B):
    rng = np.random.default_rng(seed)
    if cfg.embeds_input:
        e = (0.05 * rng.standard_normal((batch, seq, cfg.d_model))
             ).astype(np.float32)
        return {"embeds": jnp.asarray(e)}, {"embeds": torch.tensor(e)}
    toks = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks)},
            {"tokens": torch.tensor(toks, dtype=torch.long)})


def _close(got, want, tol):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_reference(arch):
    jm, params, tm = _pair(arch)
    jin, tin = _inputs(tm.cfg, T)
    want = jm.forward(params, **jin, compute_dtype=jnp.float32)
    got = tm(**tin, compute_dtype=torch.float32)
    assert got.logits.shape == (B, T, tm.cfg.vocab_size)
    _close(got.logits, want.logits, LOGITS)
    _close(got.risk_score, want.risk_score, RISK)
    _close(got.hidden, want.hidden, LOGITS)
    assert float(got.moe_aux) == 0.0
    assert tm.param_count() == jm.param_count(params)


def test_kernel_branch_matches_reference_pallas_path():
    """qwen3 smoke at T=160 (past the 128-token threshold): the port's
    kernel branch (its plain version on the CPU) against the reference's
    ``attn_impl="pallas"`` in interpret mode."""
    jm, params, tm = _pair("qwen3-8b")
    jin, tin = _inputs(tm.cfg, 160, seed=3, batch=1)
    want = jm.forward(params, **jin, compute_dtype=jnp.float32,
                      attn_impl="pallas")
    before = dict(ops.LAUNCHES)
    got = tm(**tin, compute_dtype=torch.float32, attn_impl="kernel")
    assert ops.LAUNCHES == before  # CPU tensors: no kernel launch
    _close(got.logits, want.logits, LOGITS)
    _close(got.risk_score, want.risk_score, RISK)


@pytest.mark.parametrize("arch", [a for a in DENSE if a != "hubert-xlarge"])
def test_prefill_and_decode_match_reference(arch):
    jm, params, tm = _pair(arch)
    steps = 3
    jin, tin = _inputs(tm.cfg, T + steps, seed=7)
    jpre = {k: v[:, :T] for k, v in jin.items()}
    tpre = {k: v[:, :T] for k, v in tin.items()}
    kw = dict(cache_capacity=T + steps)
    jout, jcache = jm.prefill(params, **jpre, **kw, compute_dtype=jnp.float32,
                              cache_dtype=jnp.float32)
    tout, tcache = tm.prefill(**tpre, **kw, compute_dtype=torch.float32,
                              cache_dtype=torch.float32)
    _close(tout.logits, jout.logits, LOGITS)
    for jc, tc in zip(jcache, tcache):
        assert tuple(tc.k.shape) == jc.k.shape
        _close(tc.k, jc.k, LOGITS)
        _close(tc.v, jc.v, LOGITS)
    for s in range(steps):
        jstep = {k: v[:, T + s:T + s + 1] for k, v in jin.items()}
        tstep = {k: v[:, T + s:T + s + 1] for k, v in tin.items()}
        jdec = jm.decode_step(params, jcache, **jstep, pos=T + s,
                              compute_dtype=jnp.float32)
        tdec = tm.decode_step(tcache, **tstep, pos=T + s,
                              compute_dtype=torch.float32)
        jcache, tcache = jdec.cache, tdec.cache
        _close(tdec.logits, jdec.logits, LOGITS)
        _close(tdec.risk_score, jdec.risk_score, RISK)
        assert np.array_equal(torch.argmax(tdec.logits, -1).numpy(),
                              np.asarray(jnp.argmax(jdec.logits, -1)))


def test_sliding_window_decode_matches_reference_and_forward():
    """The ring-buffer decode (qwen3 smoke, window 8): prefill 20 tokens,
    decode the 21st, against the reference's decode and the port's own
    windowed forward."""
    jm, params, tm = _pair("qwen3-8b", window=8)
    total = 21
    jin, tin = _inputs(tm.cfg, total, seed=2)
    jtok, ttok = jin["tokens"], tin["tokens"]
    kw = dict(cache_capacity=total)
    _, jcache = jm.prefill(params, tokens=jtok[:, :-1], **kw,
                           compute_dtype=jnp.float32, cache_dtype=jnp.float32)
    _, tcache = tm.prefill(ttok[:, :-1], **kw, compute_dtype=torch.float32,
                           cache_dtype=torch.float32)
    assert tcache[0].k.shape[2] == 8
    _close(tcache[0].k, jcache[0].k, LOGITS)
    jdec = jm.decode_step(params, jcache, tokens=jtok[:, -1:], pos=total - 1,
                          compute_dtype=jnp.float32)
    tdec = tm.decode_step(tcache, ttok[:, -1:], pos=total - 1,
                          compute_dtype=torch.float32)
    _close(tdec.logits, jdec.logits, LOGITS)
    full = tm(ttok, compute_dtype=torch.float32)
    torch.testing.assert_close(tdec.logits, full.logits[:, -1], rtol=2e-3,
                               atol=2e-3)


def test_bfloat16_forward_tracks_reference():
    """bf16 compute over f32 weights: the weight cast per call and the cast
    before the embedding gather round where the reference rounds."""
    jm, params, tm = _pair("qwen3-8b")
    jin, tin = _inputs(tm.cfg, T, seed=5)
    want = jm.forward(params, **jin)
    got = tm(**tin)
    assert got.logits.dtype == torch.bfloat16
    _close(got.logits, want.logits, dict(rtol=5e-2, atol=5e-2))


@pytest.mark.parametrize("arch,item", [
    ("olmoe-1b-7b", "13b"), ("llama4-maverick-400b-a17b", "13b"),
    ("jamba-1.5-large-398b", "13c"), ("xlstm-1.3b", "13d")])
def test_unported_families_raise(arch, item):
    get_config(arch)  # the registry builds every config
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP Queue 1 item {item}"):
        Model(get_smoke_config(arch), device="cpu")


@pytest.mark.parametrize("option,item", [("remat", "13e"),
                                         ("act_pspec", "13f")])
def test_unported_options_raise(option, item):
    tm = Model(get_smoke_config("qwen3-8b"), device="cpu")
    tok = torch.zeros((1, 4), dtype=torch.long)
    kw = {"remat": True} if option == "remat" else {"act_pspec": object()}
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP Queue 1 item {item}"):
        tm(tok, **kw)


def test_unknown_attn_impl_raises():
    tm = Model(get_smoke_config("qwen3-8b"), device="cpu")
    with pytest.raises(ValueError, match="attn_impl"):
        tm(torch.zeros((1, 4), dtype=torch.long), attn_impl="pallas")


def test_serve_launcher_runs_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-8b", "--smoke", "--device", "cpu", "--prompt-len", "16",
         "--decode-steps", "2"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr
    assert "prefill 4x16" in proc.stdout
    line = proc.stdout.strip().splitlines()[-1]
    scores = [float(x) for x in line.split("[")[1].rstrip("]").split()]
    assert len(scores) == 4 and all(0.0 <= s <= 1.0 for s in scores)
