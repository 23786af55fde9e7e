"""The precision plan of the float32 tensor-core flash kernel, on the CPU.

``csrc/flash_attention_tf32.cu`` takes float32 q, k and v.  The tensor
cores read float32 only as TF32 (10 mantissa bits), so the kernel splits
every operand as x_hi = tf32(x), x_lo = tf32(x - x_hi) (``cvt.rna``: round
to nearest, ties away from zero) and forms each product in three terms,
a_lo b_hi + a_hi b_lo + a_hi b_hi, accumulated in float32: S = Q K^T over
the head dim, then O += P V over each 32-key tile with P split from its
float32 value.  The online softmax runs in float32 with the reference's
guarded running max; l sums float32 P; the output is float32.

The CUDA kernel runs only on the card.  This file emulates its arithmetic
in PyTorch, tile by tile, and holds it to the JAX oracle
``repro.kernels.ref.flash_attention`` in float32 at the float32 tolerance
the on-card checks use (rtol = atol = 5e-5).  One TF32 term a product, or
three terms on only one of the two products, leave that tolerance: that is
why the kernel issues three terms on both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref

BLOCK_K = 32    # the kernel's key tile
TOL = 5e-5      # rtol = atol, as on the card


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` does: to the
    nearest value with 10 mantissa bits, ties away from zero, the low 13
    bits cleared; infinities and NaN kept."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    sign, mag = bits & 0x80000000, bits & 0x7FFFFFFF
    mag = torch.where(mag >= 0x7F800000, mag, (mag + 0x1000) & 0x7FFFE000)
    out = sign | mag
    out = torch.where(out >= 2 ** 31, out - 2 ** 32, out)
    return out.to(torch.int32).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32(x)
    return hi, tf32(x - hi)


def _product(a, b, spec, terms):
    """The einsum ``spec`` of float32 ``a`` and ``b`` as the kernel issues
    it: three TF32 terms (small ones first) or one, summed in float32."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    pairs = ([(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)] if terms == 3
             else [(a_hi, b_hi)])
    out = torch.einsum(spec, *pairs[0])
    for x, y in pairs[1:]:
        out = out + torch.einsum(spec, x, y)
    return out


def _emulate(q, k, v, *, causal, window, s_terms=3, pv_terms=3):
    """The kernel's arithmetic over its 32-key tiles."""
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
        s = _product(qh, kt, "bqhgd,bkhd->bhgqk", s_terms) * scale
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
        o = alpha[..., None] * o + _product(p, vt, "bhgqk,bkhd->bhgqd",
                                            pv_terms)
        m = m_new
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, tq, hq, d)


def _inputs(case, logit_scale, seed):
    """float32 q, k, v from numpy; q scaled so logits spread further."""
    b, tq, tk, hq, hkv, d = case[:6]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, tq, hq, d)) * logit_scale
    k = rng.standard_normal((b, tk, hkv, d))
    v = rng.standard_normal((b, tk, hkv, d))
    return [torch.tensor(x, dtype=torch.float32) for x in (q, k, v)]


def _excess(got, q, k, v, *, causal, window):
    """max of |got - want| - (TOL + TOL |want|) against the JAX oracle:
    at most 0 when ``got`` is within the tolerance."""
    want = torch.tensor(np.asarray(jref.flash_attention(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)), causal=causal,
        sliding_window=window), np.float32))
    return float(((got - want).abs() - (TOL + TOL * want.abs())).max())


# (b, tq, tk, hq, hkv, causal, window) at every head dim of the kernel;
# no row is fully masked (the oracle's finite NEG_INF averages such a row)
KINDS = {
    "causal": (1, 160, 160, 4, 2, True, 0),
    "bidirectional": (1, 128, 128, 2, 1, False, 0),
    "window": (1, 200, 200, 2, 2, True, 50),     # across 32-key tile edges
    "ragged": (1, 100, 100, 4, 1, True, 0),      # T no multiple of 32
    "tq_lt_tk": (1, 70, 150, 2, 2, False, 0),    # Tq < Tk, bidirectional
    "tq_lt_tk_causal": (1, 96, 200, 2, 1, True, 0),
}


def _case(kind, d):
    b, tq, tk, hq, hkv, causal, window = KINDS[kind]
    return (b, tq, tk, hq, hkv, d, causal, window)


@pytest.mark.parametrize("logit_scale", [1.0, 4.0])
@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_three_tf32_terms_stay_within_the_float32_tolerance(kind, d,
                                                           logit_scale):
    case = _case(kind, d)
    causal, window = case[6:]
    q, k, v = _inputs(case, logit_scale, seed=d)
    got = _emulate(q, k, v, causal=causal, window=window)
    assert _excess(got, q, k, v, causal=causal, window=window) <= 0


@pytest.mark.parametrize("logit_scale", [1.0, 4.0])
@pytest.mark.parametrize("s_terms,pv_terms", [(1, 1), (3, 1), (1, 3)],
                         ids=["one_term", "three_on_s_only",
                              "three_on_pv_only"])
def test_fewer_terms_leave_the_tolerance(s_terms, pv_terms, logit_scale):
    """One TF32 term a product, or three terms on only one of the two
    products: the error the kernel's three terms on both remove."""
    case = _case("causal", 128)
    q, k, v = _inputs(case, logit_scale, seed=0)
    got = _emulate(q, k, v, causal=True, window=0, s_terms=s_terms,
                   pv_terms=pv_terms)
    assert _excess(got, q, k, v, causal=True, window=0) > 0


def test_tf32_rounds_to_nearest_ties_away_from_zero():
    one = 1.0
    values = torch.tensor([
        one + 2.0 ** -11,          # a tie: away from zero
        -(one + 2.0 ** -11),
        one + 2.0 ** -11 - 2.0 ** -23,   # below the tie: down
        one + 3 * 2.0 ** -10,      # already TF32
        3 * 2.0 ** 126 + 2.0 ** 116,     # a tie near the top of the range
        np.inf, -np.inf, np.nan], dtype=torch.float32)
    got = tf32(values)
    want = torch.tensor([one + 2.0 ** -10, -(one + 2.0 ** -10), one,
                         one + 3 * 2.0 ** -10, 3 * 2.0 ** 126 + 2.0 ** 117],
                        dtype=torch.float32)
    assert torch.equal(got[:5], want)
    assert got[5] == np.inf and got[6] == -np.inf and torch.isnan(got[7])


def test_split_keeps_22_bits():
    """x - x_hi - x_lo is at most 2^-22 |x|: hi and lo carry what three
    terms need."""
    x = torch.tensor(np.random.default_rng(0).standard_normal(10_000),
                     dtype=torch.float32)
    hi, lo = split(x)
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)
    rest = (x.double() - hi.double() - lo.double()).abs()
    assert bool((rest <= 2.0 ** -22 * x.double().abs()).all())


def test_source_edits_apply_once_or_raise():
    """The benchmarks build copies of a kernel's source by text edits
    (``source_versions.edited``): each edit applies where its text occurs
    once, in turn; text that occurs twice or not at all raises before
    anything is built."""
    import re

    from repro_torch.benchmarks.source_versions import edited

    src = "constexpr int kStages = 2;\nfor (e = 0; e < n; e += 128)\n"
    assert edited(src, []) == src
    assert edited(src, [(re.compile(r"kStages = \d+;"), "kStages = 3;"),
                        ("e < n;", "e < 0;")]) == (
        "constexpr int kStages = 3;\nfor (e = 0; e < 0; e += 128)\n")
    # the edits apply in turn: the second sees the first's text
    assert edited(src, [("= 2;", "= 4;"), ("= 4;", "= 5;")]) == (
        src.replace("= 2;", "= 5;"))
    # a replacement is taken as it is, not as a pattern's template
    assert edited(src, [(re.compile("kStages"), r"k\1")]).startswith(
        "constexpr int k\\1 = 2;")
    for missing in ("e < m;", "e", re.compile(r"\d+")):
        with pytest.raises(ValueError, match="not once"):
            edited(src, [(missing, "")])


def test_ptxas_by_dim_reads_each_instantiation():
    """The benchmarks and the script on the card read ptxas's report of
    each head-dim instantiation from what nvcc printed, and nothing of
    another kernel."""
    from repro_torch.benchmarks.source_versions import ptxas_by_dim

    def entry(kernel, regs, frame, stores, loads):
        name = f"_ZN12_GLOBAL__N_1{len(kernel)}{kernel}EEv6Params"
        return (f"ptxas info    : Compiling entry function '{name}' for "
                f"'sm_90a'\nptxas info    : Function properties for {name}\n"
                f"    {frame} bytes stack frame, {stores} bytes spill "
                f"stores, {loads} bytes spill loads\nptxas info    : Used "
                f"{regs} registers, used 1 barriers\n")

    log = (entry("flash_attention_tf32_kernelILi64", 168, 0, 0, 0)
           + entry("flash_attention_wgmma_kernelILi64", 100, 0, 0, 0)
           + entry("flash_attention_tf32_kernelILi128", 255, 16, 8, 4))
    assert ptxas_by_dim(log, "flash_attention_tf32_kernel") == {
        64: {"registers": 168, "stack_frame_bytes": 0, "spill_bytes": 0},
        128: {"registers": 255, "stack_frame_bytes": 16, "spill_bytes": 12}}
    assert ptxas_by_dim(log, "decode_attention_kernel") == {}


def test_bench_flash_tf32_needs_a_card():
    """The benchmark times the CUDA kernel only: asked for the CPU, or with
    no card, it raises before anything is built."""
    from repro_torch.benchmarks import bench_flash_tf32 as bench

    for device in ("cpu", None):
        if device is None and torch.cuda.is_available():
            continue
        with pytest.raises(RuntimeError, match="needs a card"):
            bench.run(quick=True, device=device)
