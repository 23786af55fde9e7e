"""The port's hand-written CUDA kernels against their plain versions, on the
card.  Needs an NVIDIA card and nvcc; skips without them.  This file imports
neither JAX nor the reference package, so it runs where only PyTorch is
installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import score_pipeline as sp

pytestmark = pytest.mark.cuda
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bank(rng, t, k, n, dev):
    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    return (f32(rng.uniform(0.05, 1, (t, k))), f32(rng.uniform(0.1, 2, (t, k))),
            f32(np.sort(rng.uniform(0, 1, (t, n)), -1)),
            f32(np.sort(rng.uniform(0, 1, (t, n)), -1)))


@pytest.mark.parametrize("t,k,n,m", [(1, 1, 2, 1), (3, 3, 32, 97),
                                     (64, 3, 256, 1024), (512, 8, 256, 5000)])
def test_kernel_matches_plain_version(dev, t, k, n, m):
    rng = np.random.default_rng(m)
    bank = _bank(rng, t, k, n, dev)
    y = torch.tensor(rng.uniform(0, 1, (m, k)).astype(np.float32), device=dev)
    y[::9, 0] = float("nan")
    tid = torch.tensor(rng.integers(0, t, m).astype(np.int32), device=dev)
    before = ops.LAUNCHES["score_pipeline_banked"]
    got = ops.score_pipeline_banked(y, tid, *bank)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["score_pipeline_banked"] == before + 1
    want = ref.score_pipeline_banked(y, tid, *bank)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    torch.testing.assert_close(got[ok], want[ok], **TOL)


def test_out_of_range_ids_score_nan(dev):
    rng = np.random.default_rng(1)
    bank = _bank(rng, 4, 2, 16, dev)
    y = torch.rand(6, 2, device=dev)
    tid = torch.tensor([0, -1, 4, 3, 1 << 30, 2], dtype=torch.int32,
                       device=dev)
    got = sp.score_pipeline_banked(y, tid, *bank).cpu()
    assert torch.isnan(got[[1, 2, 4]]).all()
    assert torch.isfinite(got[[0, 3, 5]]).all()


@pytest.mark.parametrize("bad", ["dtype", "contiguity", "empty", "knots"])
def test_wrapper_rejects_what_the_kernel_does_not_take(dev, bad):
    rng = np.random.default_rng(2)
    betas, weights, src, refq = _bank(rng, 4, 2, 16, dev)
    y = torch.rand(8, 2, device=dev)
    tid = torch.zeros(8, dtype=torch.int32, device=dev)
    if bad == "dtype":
        y = y.double()
    elif bad == "contiguity":
        y = torch.rand(2, 8, device=dev).t()
    elif bad == "empty":
        y, tid = y[:0], tid[:0]
    else:
        src, refq = src[:, :1].contiguous(), refq[:, :1].contiguous()
    with pytest.raises(ValueError):
        sp.score_pipeline_banked(y, tid, betas, weights, src, refq)


# (b, tq, tk, hq, hkv, d, causal, window)
FLASH_CASES = [
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 256, 256, 8, 8, 32, True, 0),
    (2, 128, 128, 4, 1, 64, False, 0),
    (1, 256, 256, 4, 2, 64, True, 64),
    (1, 100, 100, 2, 2, 32, True, 0),
    (2, 96, 200, 4, 2, 64, True, 0),       # Tq < Tk
    (1, 300, 300, 4, 2, 128, True, 50),    # window across tile edges
    (2, 192, 192, 4, 4, 80, False, 0),     # D = 80
    (1, 70, 70, 3, 1, 16, False, 0),       # D = 16, odd head group
]
FLASH_TOL = {torch.float32: 5e-5, torch.bfloat16: 2e-2}


def _qkv(case, dtype, dev, seed=0):
    b, tq, tk, hq, hkv, d = case[:6]
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev).to(dtype)
            for shape in ((b, tq, hq, d), (b, tk, hkv, d), (b, tk, hkv, d))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_kernel_matches_plain_version(dev, case, dtype):
    causal, win = case[6:]
    q, k, v = _qkv(case, dtype, dev)
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal, sliding_window=win)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = ref.flash_attention(q, k, v, causal=causal, sliding_window=win)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_flash_kernel_reads_strided_inputs(dev):
    """q, k and v as views of one packed (B, T, Hq + 2 Hkv, D) projection,
    read in place by their strides."""
    qkv = torch.randn(2, 130, 8, 64, device=dev)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    got = fa.flash_attention(q, k, v, causal=True)
    want = ref.flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(got, want, rtol=5e-5, atol=5e-5)


def test_flash_kernel_fully_masked_rows_are_zero(dev):
    q, k, v = _qkv((1, 256, 64, 4, 2, 64), torch.float32, dev)
    got = fa.flash_attention(q, k, v, causal=True, sliding_window=16)
    masked = torch.arange(256, device=dev) >= 64 + 16 - 1
    assert torch.equal(got[0, masked], torch.zeros_like(got[0, masked]))
    want = ref.flash_attention(q, k, v, causal=True, sliding_window=16)
    torch.testing.assert_close(got[0, ~masked], want[0, ~masked],
                               rtol=5e-5, atol=5e-5)


def test_model_forward_through_the_kernel(dev):
    """qwen3 smoke at T=160: the kernel branch against the reference path,
    both on the card, one launch per attention layer."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model

    cfg = get_smoke_config("qwen3-8b")
    model = Model(cfg, device=dev, seed=0)
    tok = torch.randint(0, cfg.vocab_size, (2, 160), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    before = ops.LAUNCHES["flash_attention"]
    got = model(tok, compute_dtype=torch.float32, attn_impl="kernel")
    assert ops.LAUNCHES["flash_attention"] == before + cfg.n_layers
    want = model(tok, compute_dtype=torch.float32, attn_impl="reference")
    torch.testing.assert_close(got.logits, want.logits, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got.risk_score, want.risk_score, rtol=1e-5,
                               atol=1e-5)
