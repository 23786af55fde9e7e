"""The selective scan's gradient in the port, on the CPU.

* The plain backward (``kernels/ref.py::selective_scan_backward``) against
  torch autograd through the plain forward (``ref.selective_scan``, torch
  ops) in float64, within rtol = atol = 1e-10: T = 1, T past and not a
  multiple of the 64-step tile, C not a multiple of the 128-channel block,
  N = 8 and 16, h0 given or not, dh_T zero and nonzero.
* ``kernels.ops.selective_scan`` under grad runs ``SelectiveScanFn``: the
  forward bitwise the plain one, the gradients bitwise the plain backward.
* The channel sums of dBm and dCm bitwise in the kernel's order (quarters
  of 32 channels, then the quarters, then the blocks).
* The Mamba mixer's gradients against ``jax.grad`` of the reference's
  ``mamba_forward`` (XLA: chunks, an associative scan in each) on its own
  converted weights, float32: every parameter, the input and the initial
  SSM state within rtol 2e-4 and atol 2e-4 of the largest entry (the two
  sum the recurrence in different orders), with and without an initial
  state, h_T's cotangent zero and nonzero, T no multiple of the
  reference's chunk.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import mamba as j_m
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.models import mamba as t_m

ARCH = "jamba-1.5-large-398b"
D_MODEL = 64       # d_in 128, N 8, d_conv 4
F64 = dict(rtol=1e-10, atol=1e-10)

# (B, T, C, N, h0 given, dh_T nonzero)
CASES = [(2, 1, 16, 8, True, True), (2, 70, 40, 8, False, False),
         (1, 130, 200, 16, True, False), (3, 64, 130, 16, False, True)]


def _inputs(b, t, c, n, given, dh, dtype=torch.float64, seed=0):
    g = torch.Generator().manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=g, dtype=dtype)

    dt = 0.001 + 0.2 * torch.rand((b, t, c), generator=g, dtype=dtype)
    x, bm, cm = rand(b, t, c), rand(b, t, n), rand(b, t, n)
    a = -torch.arange(1, n + 1, dtype=dtype).repeat(c, 1) \
        * (1 + 0.1 * torch.rand((c, n), generator=g, dtype=dtype))
    h0 = rand(b, c, n) if given else None
    dy = rand(b, t, c)
    dh_t = rand(b, c, n) if dh else None
    return [dt, x, bm, cm, a, h0], dy, dh_t


def _leaves(args):
    return [v for v in args if v is not None]


@pytest.mark.parametrize("b,t,c,n,given,dh", CASES)
def test_plain_backward_matches_autograd(b, t, c, n, given, dh):
    args, dy, dh_t = _inputs(b, t, c, n, given, dh, seed=t)
    leaves = [v.requires_grad_() for v in _leaves(args)]
    y, h = ref.selective_scan(*args)
    loss = torch.sum(y * dy) + (torch.sum(h * dh_t) if dh else 0)
    want = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        _, _, chunks = ref.selective_scan(*args, chunk_states=True)
        got = ref.selective_scan_backward(*args[:5], chunks, dy, dh_t,
                                          want_dh0=given)
    got = [v for v in got if v is not None]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **F64)


@pytest.mark.parametrize("b,t,c,n,given,dh", CASES)
def test_scan_function_is_the_plain_pair(b, t, c, n, given, dh):
    """Through ``ops.selective_scan`` under grad: y and h_T bitwise the
    plain forward, the gradients bitwise the plain backward, float32."""
    args, dy, dh_t = _inputs(b, t, c, n, given, dh, dtype=torch.float32,
                             seed=t)
    want_y, want_h, chunks = ref.selective_scan(*args, chunk_states=True)
    assert chunks.shape == (b, -(-t // ref.SCAN_CHUNK), c, n)
    want = ref.selective_scan_backward(*args[:5], chunks, dy, dh_t,
                                       want_dh0=given)
    leaves = [v.requires_grad_() for v in _leaves(args)]
    before = dict(ops.LAUNCHES)
    y, h = ops.selective_scan(*args)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
    loss = torch.sum(y * dy) + (torch.sum(h * dh_t) if dh else 0)
    got = torch.autograd.grad(loss, leaves)
    assert ops.LAUNCHES == before          # the CPU launches nothing
    for g, w in zip(got, [v for v in want if v is not None]):
        assert torch.equal(g, w)


def test_scan_without_grad_saves_no_chunks_and_state_out_needs_no_grad():
    args, _, _ = _inputs(2, 5, 8, 4, True, False, dtype=torch.float32)
    y, h = ops.selective_scan(*args)
    assert y.grad_fn is None and h.grad_fn is None
    args[1].requires_grad_()
    with pytest.raises(RuntimeError, match="state_out"):
        ops.selective_scan(*args, state_out=args[5])
    with torch.no_grad():
        state = args[5].clone()
        y2, h2 = ops.selective_scan(*args[:5], state, state_out=state)
    assert h2 is state and torch.equal(h2, h) and torch.equal(y2, y)


def test_channel_sums_follow_the_kernel_order():
    v = torch.randn((2, 3, 300, 4), generator=torch.Generator().manual_seed(1))
    got = ref._sum_channels(v)
    want = torch.zeros((2, 3, 4))
    for blk in range(-(-300 // ref.SCAN_BLOCK)):
        block = None
        for q in range(ref.SCAN_BLOCK // ref.SCAN_QUARTER):
            lo = blk * ref.SCAN_BLOCK + q * ref.SCAN_QUARTER
            acc = None
            for c in range(lo, lo + ref.SCAN_QUARTER):
                term = v[:, :, c] if c < 300 else torch.zeros((2, 3, 4))
                acc = term if acc is None else acc + term
            block = acc if block is None else block + acc
        want = block if blk == 0 else want + block
    assert torch.equal(got, want)


def _mixer(seed=1):
    jmc = j_smoke(ARCH).mamba
    params = j_m.init_mamba(jax.random.key(seed), D_MODEL, jmc)
    mod = t_m.Mamba(D_MODEL, get_smoke_config(ARCH).mamba, device="cpu")
    convert._copy_module(mod, jax.tree.map(lambda a: np.asarray(a)[None],
                                           params), 0)
    return jmc, params, mod.requires_grad_(True)


def _ref_grad(jgrads, name):
    """The reference's gradient of the port's mixer parameter ``name``."""
    owner, _, attr = name.rpartition(".")
    if not owner:
        return np.asarray(jgrads[attr])
    return np.asarray(jgrads[owner]["w"]).T if attr == "weight" \
        else np.asarray(jgrads[owner]["b"])


def _close(got, want):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-4,
                               atol=2e-4 * np.abs(want).max())


@pytest.mark.parametrize("t,chunk,given,dh", [(21, 8, True, True),
                                              (21, 8, False, False),
                                              (70, 16, True, False),
                                              (16, 8, False, True)])
def test_mixer_gradients_match_jax(t, chunk, given, dh):
    jmc, params, mod = _mixer()
    rng = np.random.default_rng(t)
    d_in, n = 2 * D_MODEL, jmc.d_state
    x = rng.standard_normal((2, t, D_MODEL)).astype(np.float32)
    conv0 = rng.standard_normal((2, 3, d_in)).astype(np.float32)
    ssm0 = rng.standard_normal((2, d_in, n)).astype(np.float32)
    cot = rng.standard_normal((2, t, D_MODEL)).astype(np.float32)
    cot_h = rng.standard_normal((2, d_in, n)).astype(np.float32) * dh

    def jloss(p, xx, s0):
        init = j_m.MambaState(conv=jnp.asarray(conv0), ssm=s0) \
            if given else None
        out, st = j_m.mamba_forward(p, xx, jmc, chunk_size=chunk,
                                    initial_state=init, return_state=True)
        return jnp.sum(out * cot) + jnp.sum(st.ssm * cot_h)

    jg, jx, js = jax.grad(jloss, argnums=(0, 1, 2))(
        params, jnp.asarray(x), jnp.asarray(ssm0))
    tx = torch.tensor(x, requires_grad=True)
    ts0 = torch.tensor(ssm0, requires_grad=True)
    init = t_m.MambaState(conv=torch.tensor(conv0), ssm=ts0) \
        if given else None
    out, st = t_m.mamba_forward(mod, tx, get_smoke_config(ARCH).mamba,
                                initial_state=init, return_state=True)
    loss = torch.sum(out * torch.tensor(cot)) \
        + torch.sum(st.ssm * torch.tensor(cot_h))
    loss.backward()
    for name, p in mod.named_parameters():
        _close(p.grad, _ref_grad(jg, name))
    _close(tx.grad, jx)
    if given:
        _close(ts0.grad, js)
    else:
        assert ts0.grad is None
