"""The selective scan's gradient in the port, on the CPU.

* The plain backward (``kernels/ref.py::selective_scan_backward``) against
  torch autograd through the plain forward (``ref.selective_scan``, torch
  ops) in float64, within rtol = atol = 1e-10: T = 1, T past and not a
  multiple of the 16-step chunk or of 64, C not a multiple of the
  128-channel block nor of a warp's 8 channels, N = 1, 3, 5, 8 and 16
  (states a thread 1 to 4, the last ones masked), h0 given or not, dh_T
  zero and nonzero.
* ``kernels.ops.selective_scan`` under grad runs ``SelectiveScanFn``: the
  forward bitwise the plain one, the gradients bitwise the plain backward.
* The channel sums of dBm and dCm bitwise in the kernel's order (a halving
  tree over a warp's 8 channels, then the 16 warps, then the blocks), and
  du and the sum of q · A over n in its order (each thread's states in
  order, then the group's four partials pairwise).
* The scan kernels' bounds at jamba-1.5-large's shape: the forward by its
  exponentials, the backward by its float32 operations, one instruction
  each under ``-fmad=false``; the ptxas report the on-card checks read;
  ``benchmarks/bench_scan.py`` refusing to run without a card.
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
         (1, 130, 200, 16, True, False), (3, 64, 130, 16, False, True),
         (2, 37, 130, 1, True, True), (1, 19, 33, 3, False, True),
         (2, 45, 129, 5, True, False)]


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
    """Each warp's 8 channels as ((c0 + c4) + (c2 + c6)) + ((c1 + c5) +
    (c3 + c7)), the block's 16 warps in order, then the blocks in order;
    channels past C count as 0."""
    c = 300
    v = torch.randn((2, 3, c, 4), generator=torch.Generator().manual_seed(1))

    def ch(i):
        return v[:, :, i] if i < c else torch.zeros((2, 3, 4))

    want = None
    for blk in range(-(-c // ref.SCAN_BLOCK)):
        block = None
        for w in range(ref.SCAN_BLOCK // ref.SCAN_WARP):
            lo = blk * ref.SCAN_BLOCK + w * ref.SCAN_WARP
            warp = ((ch(lo) + ch(lo + 4)) + (ch(lo + 2) + ch(lo + 6))) \
                + ((ch(lo + 1) + ch(lo + 5)) + (ch(lo + 3) + ch(lo + 7)))
            block = warp if block is None else block + warp
        want = block if want is None else want + block
    assert torch.equal(ref._sum_channels(v), want)


@pytest.mark.parametrize("n", [1, 3, 5, 8, 16])
def test_state_sums_follow_the_kernel_order(n):
    """Σ over n as the backward kernel's group of four threads takes it:
    each thread its ceil(N / 4) states in order (masked states as 0), then
    (p0 + p1) + (p2 + p3)."""
    v = torch.randn((3, 7, n), generator=torch.Generator().manual_seed(n))
    per = -(-n // ref.SCAN_GROUP)
    parts = []
    for g in range(ref.SCAN_GROUP):
        acc = None
        for j in range(g * per, g * per + per):
            term = v[..., j] if j < n else torch.zeros((3, 7))
            acc = term if acc is None else acc + term
        parts.append(acc)
    want = (parts[0] + parts[1]) + (parts[2] + parts[3])
    assert torch.equal(ref._sum_states(v), want)


def test_scan_bounds_at_jambas_shape():
    """(4, 2,048, 16,384, 16): the forward's 2.15 G exponentials on the
    SFUs (0.5135 ms) above its 13.0 G operations (0.389 ms); the
    backward's 34.9 G operations at 128 float32 instructions a clock an
    SM (1.0431 ms) above its bytes (0.8026 ms) and exponentials."""
    from repro_torch.benchmarks import timing

    ms, by = timing.selective_scan_bound(4, 2048, 16384, 16)
    assert by == "operations" and ms == pytest.approx(0.51354, rel=1e-4)
    ms, by = timing.selective_scan_bwd_bound(4, 2048, 16384, 16)
    assert by == "operations" and ms == pytest.approx(1.04312, rel=1e-4)
    assert timing.SCALAR_F32_OPS == pytest.approx(33.45e12, rel=1e-3)


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


def test_ptxas_report_reads_registers_stack_and_spills(monkeypatch):
    """``_build.ptxas_report`` (what chip_smoke and the on-card tests hold
    the scan kernels to) reads each kernel's registers, stack frame and
    spill bytes from what nvcc printed."""
    from repro_torch.kernels import _build

    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z6kernelILi16EEvPf' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelILi16EEvPf
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 8576 bytes smem
ptxas info    : Compiling entry function '_Z6reduceEv' for 'sm_90a'
ptxas info    : Function properties for _Z6reduceEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers
"""
    monkeypatch.setattr(_build, "build_log", lambda name: (None, log))
    assert _build.ptxas_report("selective_scan_bwd") == {
        "_Z6kernelILi16EEvPf": {"stack_frame": 8, "spill_stores": 4,
                                "spill_loads": 12, "registers": 128},
        "_Z6reduceEv": {"stack_frame": 0, "spill_stores": 0,
                        "spill_loads": 0, "registers": 32}}


def test_bench_scan_needs_a_card():
    """``benchmarks/bench_scan.py`` times the CUDA kernels only: with no
    card, or asked for the CPU, it raises before anything runs."""
    from repro_torch.benchmarks import bench_scan

    for device in ("cpu", None):
        if device is None and torch.cuda.is_available():
            continue
        with pytest.raises(RuntimeError, match="needs a card"):
            bench_scan.run(quick=True, device=device)
    with pytest.raises(RuntimeError, match="needs a card"):
        bench_scan.main(["--quick", "--device", "cpu", "--against", "x"])
