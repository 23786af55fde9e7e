"""The port's flash attention against the JAX package, on the CPU.

``repro_torch.kernels.ref.flash_attention`` (the plain version, which
``ops.flash_attention`` runs for CPU tensors) is held to the JAX oracle
``repro.kernels.ref.flash_attention`` on the same numpy inputs, and on two
small cases to the Pallas kernel itself in interpret mode (slow, so only
two).  Tolerances are the reference's ``_tol`` (``tests/test_kernels.py``):
2e-5 in float32, 2e-2 in bfloat16.  The CUDA wrapper's argument checks run
here too: they raise before any CUDA call.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.attention import _gqa_scores_chunked as j_chunked
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models.attention import _gqa_scores_chunked as t_chunked

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}

# (b, tq, tk, hq, hkv, d, causal, window): the reference's five cases
# (tests/test_kernels.py), then Tq < Tk and hubert's D = 80
CASES = [
    (2, 128, 128, 4, 2, 64, True, 0),      # GQA causal
    (1, 256, 256, 8, 8, 32, True, 0),      # MHA causal
    (2, 128, 128, 4, 1, 64, False, 0),     # bidirectional (encoder)
    (1, 256, 256, 4, 2, 64, True, 64),     # sliding window
    (1, 100, 100, 2, 2, 32, True, 0),      # non-divisible lengths
    (2, 96, 200, 4, 2, 64, True, 0),       # fewer queries than keys
    (2, 160, 160, 4, 4, 80, False, 0),     # D = 80 (hubert-xlarge)
]


def _qkv(case, seed=0):
    b, tq, tk, hq, hkv, d = case[:6]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, tq, hq, d)).astype(np.float32),
            rng.standard_normal((b, tk, hkv, d)).astype(np.float32),
            rng.standard_normal((b, tk, hkv, d)).astype(np.float32))


def _both(arrays, dtype):
    jd, td, _ = DTYPES[dtype]
    return ([jnp.asarray(a, jd) for a in arrays],
            [torch.tensor(a).to(td) for a in arrays])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_version_matches_jax_oracle(case, dtype):
    causal, win = case[6:]
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(case), dtype)
    want = jref.flash_attention(jq, jk, jv, causal=causal, sliding_window=win)
    got = tref.flash_attention(tq, tk, tv, causal=causal, sliding_window=win)
    assert got.dtype == DTYPES[dtype][1] and got.shape == tq.shape
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("case", [(1, 100, 100, 2, 2, 32, True, 0),
                                  (1, 128, 128, 2, 1, 16, True, 24)],
                         ids=["ragged-causal", "window"])
def test_ops_matches_pallas_kernel_in_interpret_mode(case):
    causal, win = case[6:]
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(case, seed=1), "float32")
    want = jops.flash_attention(jq, jk, jv, causal=causal, sliding_window=win,
                                block_q=64, block_k=64, interpret=True)
    got = tops.flash_attention(tq, tk, tv, causal=causal, sliding_window=win)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("q_offset,valid,window", [(0, None, 0), (0, None, 5),
                                                   (17, 18, 0)])
def test_chunked_reference_path_matches_jax(q_offset, valid, window):
    """The model's chunked attention (prefill reference path and decode
    path), with ragged chunks, a window, and a decode-shaped query."""
    tq = 1 if valid else 40
    case = (2, tq, 24, 4, 2, 16)
    (jq, jk, jv), (tq_, tk_, tv_) = _both(_qkv(case, seed=2), "float32")
    kw = dict(causal=valid is None, q_offset=q_offset, sliding_window=window,
              kv_valid_len=valid, chunk=16)
    want = j_chunked(jq, jk, jv, **kw)
    got = t_chunked(tq_, tk_, tv_, **kw)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5, atol=2e-5)


def test_cpu_tensors_run_the_plain_version():
    case = CASES[0]
    _, (q, k, v) = _both(_qkv(case), "float32")
    before = dict(tops.LAUNCHES)
    got = tops.flash_attention(q, k, v, causal=True)
    assert tops.LAUNCHES == before
    assert torch.equal(got, tref.flash_attention(q, k, v, causal=True))
    assert tops.LAUNCHES is tfa.LAUNCHES and "flash_attention" in tops.LAUNCHES


def test_fully_masked_rows_differ_only_there():
    """Rows that see no key (window ends before the keys do) are where the
    finite NEG_INF of the plain version gives a uniform average; every
    other row is a proper softmax."""
    q, k, v = (torch.tensor(a) for a in _qkv((1, 96, 32, 2, 1, 16)))
    out = tref.flash_attention(q, k, v, causal=True, sliding_window=8)
    masked = torch.arange(96) >= 32 + 8 - 1
    torch.testing.assert_close(out[0, masked], v.mean(1).expand(
        int(masked.sum()), 2, 16), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bad", ["cpu", "d24", "d144", "int", "mixed",
                                 "heads", "stride", "rank"])
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, k, v = (torch.tensor(a) for a in _qkv((1, 8, 8, 4, 2, 32)))
    if bad == "d24":
        q, k, v = q[..., :24], k[..., :24], v[..., :24]
    elif bad == "d144":
        q, k, v = (torch.cat([x] * 4 + [x[..., :16]], -1) for x in (q, k, v))
    elif bad == "int":
        q, k, v = q.int(), k.int(), v.int()
    elif bad == "mixed":
        q = q.to(torch.bfloat16)
    elif bad == "heads":
        q = q[:, :, :3]
    elif bad == "stride":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "rank":
        q = q[0]
    match = {"cpu": "CUDA tensors", "d24": "head dim", "d144": "head dim",
             "int": "dtype", "mixed": "is torch.bfloat16", "heads": "heads",
             "stride": "contiguous", "rank": "rank-4"}[bad]
    with pytest.raises(ValueError, match=match):
        tfa.flash_attention(q, k, v)
