"""The port's decode attention against the JAX package, on the CPU.

``repro_torch.kernels.ref.decode_attention`` (the plain version, which
``ops.decode_attention`` runs for CPU tensors) is held to the JAX oracle
``repro.kernels.ref.decode_attention`` on the same numpy inputs over the
reference's five cases (``tests/test_kernels.py``), and on two cases to the
Pallas kernel itself in interpret mode.  Tolerances are the reference's
``_tol``: 2e-5 in float32, 2e-2 in bfloat16.  The CUDA wrapper's argument
checks and its split plan run here too: they need no card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}

# (b, s, hq, hkv, d, valid lengths): the reference's four cases and its
# per-row lengths
CASES = [
    (2, 256, 8, 2, 64, (256, 256)),
    (1, 512, 4, 4, 32, (300,)),        # partially filled cache
    (4, 128, 16, 2, 64, (128,) * 4),
    (1, 100, 2, 1, 32, (77,)),         # non-divisible
    (3, 128, 4, 2, 32, (1, 64, 128)),  # per-row lengths
]


def _inputs(case, seed=0):
    b, s, hq, hkv, d = case[:5]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32),
            np.asarray(case[5], np.int32))


def _both(arrays, dtype):
    jd, td, _ = DTYPES[dtype]
    *qkv, vlen = arrays
    return ([jnp.asarray(a, jd) for a in qkv] + [jnp.asarray(vlen)],
            [torch.tensor(a).to(td) for a in qkv] + [torch.tensor(vlen)])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: "-".join(map(str, c[:5])))
def test_plain_version_matches_jax_oracle(case, dtype):
    jargs, targs = _both(_inputs(case), dtype)
    want = jref.decode_attention(*jargs)
    got = tref.decode_attention(*targs)
    assert got.dtype == DTYPES[dtype][1] and got.shape == targs[0].shape
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("case", [CASES[3], CASES[4]],
                         ids=["ragged", "per-row"])
def test_ops_matches_pallas_kernel_in_interpret_mode(case):
    jargs, targs = _both(_inputs(case, seed=1), "float32")
    want = jops.decode_attention(*jargs, block_s=32, interpret=True)
    got = tops.decode_attention(*targs)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5, atol=2e-5)


def test_valid_len_zero_and_past_the_cache():
    """A length past S attends to all S positions, as the kernel clamps it.
    A row of length 0 is where the plain version (the finite NEG_INF, as
    the JAX oracle) averages every value and the kernels give 0."""
    case = (3, 40, 4, 2, 16, (0, 99, 40))
    jargs, targs = _both(_inputs(case, seed=2), "float32")
    got = tref.decode_attention(*targs)
    np.testing.assert_allclose(_f32(got), _f32(jref.decode_attention(*jargs)),
                               rtol=2e-5, atol=2e-5)
    q, k, v, _ = targs
    clamped = tref.decode_attention(q, k, v, torch.tensor([0, 40, 40]))
    assert torch.equal(got[1], clamped[1])
    torch.testing.assert_close(got[0], v[0].mean(0).repeat_interleave(2, 0),
                               rtol=1e-5, atol=1e-5)
    kernel = _f32(jops.decode_attention(*jargs, block_s=16, interpret=True))
    assert not kernel[0].any()


def test_cpu_tensors_run_the_plain_version():
    _, targs = _both(_inputs(CASES[0]), "float32")
    before = dict(tops.LAUNCHES)
    got = tops.decode_attention(*targs)
    assert tops.LAUNCHES == before and "decode_attention" in tops.LAUNCHES
    assert torch.equal(got, tref.decode_attention(*targs))


@pytest.mark.parametrize("b,hkv,s", [(4, 2, 16_384), (4, 8, 2_064),
                                     (1, 1, 100), (3, 2, 777), (64, 8, 1),
                                     (1, 1, 1_000_000)])
def test_split_plan_covers_the_cache(b, hkv, s):
    splits, chunk = tda.plan_splits(b, hkv, s)
    assert chunk % tda.TILE == 0
    assert (splits - 1) * chunk < s <= splits * chunk
    tiles = -(-s // tda.TILE)
    if tiles >= tda.TARGET_BLOCKS // (b * hkv):
        assert b * hkv * splits >= tda.TARGET_BLOCKS // 2


def test_a_lost_split_fails_the_float32_check_at_the_bench_shape():
    """Why the card's check runs float32 at the benchmark's shape: there a
    typical |o| is below the bf16 tolerance, so dropping one of the kernel's
    splits stays inside rtol = atol = 2e-2 but moves o far past 2e-5."""
    b, s, hkv = 4, 16_384, 2
    q, k, v, _ = (torch.tensor(a) for a in _inputs((b, s, 8, hkv, 64, ())))
    splits, chunk = tda.plan_splits(b, hkv, s)
    assert splits > 1
    full = tref.decode_attention(q, k, v, torch.full((b,), s, dtype=torch.int32))
    keep = torch.ones(s, dtype=torch.bool)
    keep[chunk:2 * chunk] = False
    lost = tref.decode_attention(q, k[:, keep], v[:, keep],
                                 torch.full((b,), s - chunk, dtype=torch.int32))
    shift = (lost - full).abs()

    def excess(tol):
        return (shift - (tol + tol * full.abs())).max().item()
    assert excess(2e-5) > 100 * 2e-5
    assert excess(2e-2) < 0


@pytest.mark.parametrize("bad", ["cpu", "d24", "d144", "mixed", "int",
                                 "heads", "group", "vlen_dtype", "vlen_shape",
                                 "stride", "rank"])
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, k, v, vlen = (torch.tensor(a) for a in _inputs(
        (2, 16, 4, 2, 32, (16, 8))))
    if bad == "d24":
        q, k, v = q[..., :24], k[..., :24], v[..., :24]
    elif bad == "d144":
        q, k, v = (torch.cat([x] * 4 + [x[..., :16]], -1) for x in (q, k, v))
    elif bad == "mixed":
        k = k.to(torch.bfloat16)
    elif bad == "int":
        q, k, v = q.int(), k.int(), v.int()
    elif bad == "heads":
        q = q[:, :3]
    elif bad == "group":
        q = torch.zeros(2, 130, 32)
        k, v = k[:, :, :1], v[:, :, :1]
    elif bad == "vlen_dtype":
        vlen = vlen.long()
    elif bad == "vlen_shape":
        vlen = vlen[:1]
    elif bad == "stride":
        k = k.transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "rank":
        q = q[0]
    match = {"cpu": "CUDA tensors", "d24": "head dim", "d144": "head dim",
             "mixed": "is torch.bfloat16", "int": "dtype", "heads": "heads",
             "group": "at most 64", "vlen_dtype": "int32",
             "vlen_shape": "int32", "stride": "contiguous",
             "rank": "rank-3"}[bad]
    with pytest.raises(ValueError, match=match):
        tda.decode_attention(q, k, v, vlen)
