"""The precision plan of the tensor-core flash-attention kernel, on the CPU.

``csrc/flash_attention_wgmma.cu`` takes bf16 q, k and v, forms S = Q K^T in
float32 (bf16 products are exact there), runs the online softmax in float32
over tiles of 128 keys, and feeds P to the bf16 tensor cores as two terms,
P_hi = bf16(P) and P_lo = bf16(P - P_hi), accumulating O in float32 and
rounding it to bf16 once.  The CUDA kernel runs only on the card; this file
emulates its arithmetic in PyTorch and holds it to the JAX oracle
``repro.kernels.ref.flash_attention`` on the same (bf16-valued) inputs in
float32, by the measure the model's on-card check uses: the error as a
share of the bf16 rounding bound 2^-8 |o| + 1e-5 (at most 1 when only the
output's rounding separates them).  With one bf16 term the share is far
above 1: that is why the kernel issues the second term.

The wrapper's choice between the two CUDA kernels is a pure function of
dtype, head dim and alignment; it is tested here on CPU tensors.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as tfa

BLOCK_K = 128   # the kernel's key tile


def _inputs(b, t, hq, hkv, d, logit_scale, seed):
    """bf16-valued float32 q, k, v; q scaled so logits spread further."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, hq, d)) * logit_scale
    k = rng.standard_normal((b, t, hkv, d))
    v = rng.standard_normal((b, t, hkv, d))
    return [torch.tensor(x, dtype=torch.float32).to(torch.bfloat16).float()
            for x in (q, k, v)]


def _emulate(q, k, v, *, causal, window, terms):
    """The kernel's arithmetic: float32 S and softmax over 128-key tiles
    with the guarded running max, P as ``terms`` bf16 terms against bf16 V,
    float32 accumulation, l over float32 P, bf16 output."""
    b, tq, hq, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    qh = q.reshape(b, tq, hkv, hq // hkv, d)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(d)))
    m = torch.full((b, hkv, hq // hkv, tq), -torch.inf)
    l = torch.zeros_like(m)
    o = torch.zeros((b, hkv, hq // hkv, tq, d))
    qpos = torch.arange(tq)[:, None]
    for k0 in range(0, tk, BLOCK_K):
        kt, vt = k[:, k0:k0 + BLOCK_K], v[:, k0:k0 + BLOCK_K]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qh, kt) * scale
        kpos = k0 + torch.arange(kt.shape[1])[None, :]
        mask = torch.ones(tq, kt.shape[1], dtype=torch.bool)
        if causal:
            mask &= qpos >= kpos
        if window > 0:
            mask &= kpos > qpos - window
        s = s.masked_fill(~mask, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        alpha = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
        p = torch.exp(s - m_safe[..., None])
        l = alpha * l + p.sum(-1)
        o = alpha[..., None] * o
        rest = p
        for _ in range(terms):
            term = rest.to(torch.bfloat16).float()
            o = o + torch.einsum("bhgqk,bkhd->bhgqd", term, vt)
            rest = rest - term
        m = m_new
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, tq, hq, d).to(torch.bfloat16)


def _share(got, want):
    """max |got - want| / (2^-8 |want| + 1e-5): the model check's measure."""
    want = torch.tensor(np.asarray(want, np.float32))
    bound = 2.0 ** -8 * want.abs() + 1e-5
    return float(((got.float() - want).abs() / bound).max())


def _oracle(q, k, v, *, causal, window):
    return jref.flash_attention(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                                causal=causal, sliding_window=window)


# (b, t, hq, hkv, d, causal, window); logit scales 1 and 4 as the
# emulation that chose the design
PLAN_CASES = [
    (1, 384, 4, 2, 64, True, 0),
    (1, 300, 4, 1, 128, True, 0),
    (2, 256, 2, 2, 64, False, 0),
    (1, 384, 4, 2, 128, True, 100),
]


@pytest.mark.parametrize("logit_scale", [1.0, 4.0])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", PLAN_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_two_bf16_terms_stay_within_bf16_rounding_of_float32(case, seed,
                                                             logit_scale):
    b, t, hq, hkv, d, causal, window = case
    q, k, v = _inputs(b, t, hq, hkv, d, logit_scale, seed)
    got = _emulate(q, k, v, causal=causal, window=window, terms=2)
    want = _oracle(q, k, v, causal=causal, window=window)
    assert _share(got, want) <= 1.0


@pytest.mark.parametrize("logit_scale", [1.0, 4.0])
def test_one_bf16_term_leaves_the_bound(logit_scale):
    """P rounded to bf16 alone: the error the kernel's second term
    removes."""
    q, k, v = _inputs(1, 384, 4, 2, 128, logit_scale, seed=0)
    got = _emulate(q, k, v, causal=True, window=0, terms=1)
    want = _oracle(q, k, v, causal=True, window=0)
    assert _share(got, want) > 2.0


def _qkv(d, dtype, *, hq=4, hkv=2, t=32):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(1, t, h, d, generator=g).to(dtype)
            for h in (hq, hkv, hkv)]


@pytest.mark.parametrize("dtype,d,form", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 80, "simt"), (torch.bfloat16, 32, "simt"),
    (torch.float32, 64, "simt"), (torch.float32, 128, "simt")])
def test_form_is_chosen_by_dtype_and_head_dim(dtype, d, form):
    assert tfa.kernel_form(*_qkv(d, dtype)) == form


def test_packed_views_take_the_wgmma_form():
    """q, k, v as views of one packed (B, T, Hq + 2 Hkv, D) projection:
    16-byte-aligned pointers and strides."""
    qkv = torch.zeros(2, 130, 8, 128, dtype=torch.bfloat16)
    assert tfa.kernel_form(qkv[:, :, :4], qkv[:, :, 4:6],
                           qkv[:, :, 6:]) == "wgmma"
    # a dim of length 1 has no stride to align
    one = torch.zeros(1, 8, 1, 64, dtype=torch.bfloat16).as_strided(
        (1, 8, 1, 64), (3, 64, 5, 1))
    assert tfa.kernel_form(one, one, one) == "wgmma"


@pytest.mark.parametrize("bad", ["pointer", "head_stride", "row_stride"])
def test_misaligned_bf16_views_raise(bad):
    q, k, v = _qkv(128, torch.bfloat16)
    if bad == "pointer":
        q = torch.zeros(1, 32, 4, 130, dtype=torch.bfloat16)[..., 1:129]
    elif bad == "head_stride":
        k = torch.zeros(1, 32, 2, 132, dtype=torch.bfloat16)[..., :128]
    else:
        v = torch.zeros(32 * 260, dtype=torch.bfloat16).as_strided(
            (1, 32, 2, 128), (32 * 260, 260, 128, 1))
    with pytest.raises(ValueError, match="16-byte"):
        tfa.kernel_form(q, k, v)
