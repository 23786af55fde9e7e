"""The port's hand-written CUDA kernels against their plain versions, on the
card.  Needs an NVIDIA card and nvcc; skips without them.  This file imports
neither JAX nor the reference package, so it runs where only PyTorch is
installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import quantile_map as qm
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


# the tensor-core form (csrc/flash_attention_wgmma.cu): bf16, D in (64, 128)
# (b, tq, tk, hq, hkv, d, causal, window)
WGMMA_CASES = [
    (1, 1, 1, 4, 1, 64, True, 0),           # T = 1
    (2, 127, 127, 8, 2, 128, True, 0),      # T = 127, 4 q heads per KV head
    (1, 128, 128, 8, 1, 64, True, 0),       # T = 128, 8 per KV head
    (2, 129, 129, 4, 4, 128, True, 0),      # T = 129, MHA
    (1, 1000, 1000, 8, 2, 128, True, 0),
    (1, 2049, 2049, 4, 1, 64, True, 0),
    (2, 96, 300, 8, 1, 128, True, 0),       # Tq < Tk
    (1, 300, 300, 4, 2, 128, True, 50),     # windows across tile edges
    (1, 700, 700, 4, 4, 64, True, 200),
    (1, 500, 500, 4, 1, 128, False, 130),
    (2, 200, 333, 8, 2, 64, False, 0),      # non-causal, Tq < Tk
    (1, 1, 257, 2, 2, 128, False, 0),
]


@pytest.mark.parametrize("case", WGMMA_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_wgmma_form_matches_plain_version(dev, case):
    causal, win = case[6:]
    q, k, v = _qkv(case, torch.bfloat16, dev, seed=1)
    before = dict(ops.LAUNCHES)
    got = ops.flash_attention(q, k, v, causal=causal, sliding_window=win)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention_wgmma"] == \
        before["flash_attention_wgmma"] + 1
    assert ops.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    want = ref.flash_attention(q, k, v, causal=causal, sliding_window=win)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


def test_wgmma_form_reads_packed_strided_views(dev):
    qkv = torch.randn(2, 300, 12, 128, device=dev).to(torch.bfloat16)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    assert fa.kernel_form(q, k, v) == "wgmma"
    got = fa.flash_attention(q, k, v, causal=True)
    want = ref.flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


def test_wgmma_form_fully_masked_rows_are_zero(dev):
    q, k, v = _qkv((1, 256, 64, 4, 2, 64), torch.bfloat16, dev)
    before = ops.LAUNCHES["flash_attention_wgmma"]
    got = fa.flash_attention(q, k, v, causal=True, sliding_window=16)
    assert ops.LAUNCHES["flash_attention_wgmma"] == before + 1
    masked = torch.arange(256, device=dev) >= 64 + 16 - 1
    assert torch.equal(got[0, masked], torch.zeros_like(got[0, masked]))
    want = ref.flash_attention(q, k, v, causal=True, sliding_window=16)
    torch.testing.assert_close(got[0, ~masked].float(),
                               want[0, ~masked].float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 64),
                                     (torch.float32, 128),
                                     (torch.bfloat16, 80)])
def test_other_inputs_take_the_simt_form(dev, dtype, d):
    q, k, v = _qkv((1, 130, 130, 4, 2, d), dtype, dev)
    before = dict(ops.LAUNCHES)
    got = ops.flash_attention(q, k, v, causal=True)
    assert ops.LAUNCHES["flash_attention_wgmma"] == \
        before["flash_attention_wgmma"]
    assert ops.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    want = ref.flash_attention(q, k, v, causal=True)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_misaligned_bf16_view_raises(dev):
    base = torch.randn(1, 64, 4, 136, device=dev).to(torch.bfloat16)
    q = base[..., 1:129]              # data pointer 2 bytes off
    k = v = base[:, :, :2, :128]
    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(q, k, v)
    assert ops.LAUNCHES == before


def test_wgmma_kernel_uses_tensor_cores_and_tma_without_spills(dev):
    """SASS of both instantiations holds HGMMA and UTMALDG; ptxas reports
    no spills."""
    import shutil
    import subprocess
    from pathlib import Path

    from repro_torch.kernels import _build

    lib, log = _build.build_log("flash_attention_wgmma")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        pytest.skip("needs cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    kernels = [f for f in sass.split("Function : ")[1:]
               if "flash_attention_wgmma_kernel" in f.splitlines()[0]]
    assert len(kernels) == 2   # D = 64 and D = 128
    for f in kernels:
        assert "HGMMA" in f and "UTMALDG" in f
    spills = [ln for ln in log.splitlines() if "spill" in ln]
    assert spills and all("0 bytes spill stores, 0 bytes spill loads" in ln
                          for ln in spills), log
    assert "setmaxnreg ignored" not in log, log


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


# quantile_map and score_pipeline: the reference's tolerances per dtype
SCORE_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SCORE_DTYPES = pytest.mark.parametrize(
    "dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])


def _tables(rng, n, dev):
    src = np.sort(rng.uniform(0, 1, n)).astype(np.float32)
    refq = np.sort(rng.uniform(0, 1, n)).astype(np.float32)
    src[0], src[-1] = 0.0, 1.0
    return torch.tensor(src, device=dev), torch.tensor(refq, device=dev)


def _close_with_nan(got, want, tol):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    torch.testing.assert_close(got[ok].float(), want[ok].float(), rtol=tol,
                               atol=tol)


@SCORE_DTYPES
@pytest.mark.parametrize("shape,n", [((16,), 8), ((1000,), 64),
                                     ((4096,), 256), ((333,), 33), ((1,), 2),
                                     ((4, 7, 9), 32)])
def test_quantile_map_kernel_matches_plain_version(dev, shape, n, dtype):
    rng = np.random.default_rng(n)
    src, refq = _tables(rng, n, dev)
    x = torch.tensor(rng.uniform(-0.1, 1.1, shape).astype(np.float32),
                     device=dev).to(dtype)
    x.view(-1)[::5] = float("nan")
    before = ops.LAUNCHES["quantile_map"]
    got = ops.quantile_map(x, src, refq)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["quantile_map"] == before + 1
    _close_with_nan(got, ref.quantile_map(x, src, refq), SCORE_TOL[dtype])


@SCORE_DTYPES
def test_scores_on_knots_map_bitwise(dev, dtype):
    """Every knot but the last, flat run included: s - qs[j] = 0, so both
    orders of operation give qr[j]."""
    rng = np.random.default_rng(5)
    src, refq = _tables(rng, 256, dev)
    src[100:120] = src[100]
    knots = src.to(dtype).float()
    on = knots[:-1].to(dtype)
    got = qm.quantile_map(on, knots, refq)
    assert torch.equal(got, ref.quantile_map(on, knots, refq))
    one = torch.ones(1, device=dev)
    got = sp.score_pipeline(on[:, None], one, one, knots, refq)
    assert torch.equal(got, ref.score_pipeline(on[:, None], one, one, knots,
                                               refq))


@SCORE_DTYPES
@pytest.mark.parametrize("shape,n", [((64, 3), 32), ((1000, 8), 256),
                                     ((7, 1), 8), ((4, 7, 9, 3), 32),
                                     ((1, 8), 2)])
def test_score_pipeline_kernel_matches_plain_version(dev, shape, n, dtype):
    rng = np.random.default_rng(n + len(shape))
    k = shape[-1]
    src, refq = _tables(rng, n, dev)
    betas = torch.tensor(rng.uniform(0.02, 1, k).astype(np.float32),
                         device=dev)
    weights = torch.tensor(rng.uniform(0.5, 2, k).astype(np.float32),
                           device=dev)
    y = torch.tensor(rng.uniform(0, 1, shape).astype(np.float32),
                     device=dev).to(dtype)
    y.view(-1, k)[::6, 0] = float("nan")
    before = ops.LAUNCHES["score_pipeline"]
    got = ops.score_pipeline(y, betas, weights, src, refq)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["score_pipeline"] == before + 1
    assert got.shape == shape[:-1]
    _close_with_nan(got, ref.score_pipeline(y, betas, weights, src, refq),
                    SCORE_TOL[dtype])


@pytest.mark.parametrize("table", ["flat", "unsorted"])
def test_score_kernels_on_odd_tables(dev, table):
    rng = np.random.default_rng(7)
    src, refq = _tables(rng, 64, dev)
    if table == "flat":
        src[10:30] = src[10]
    else:
        src = torch.tensor(rng.uniform(0, 1, 64).astype(np.float32),
                           device=dev)
    x = torch.rand(3000, device=dev)
    _close_with_nan(qm.quantile_map(x, src, refq),
                    ref.quantile_map(x, src, refq), 2e-5)
    y, b, w = torch.rand(3000, 4, device=dev), torch.rand(4, device=dev), \
        torch.rand(4, device=dev) + 0.1
    _close_with_nan(sp.score_pipeline(y, b, w, src, refq),
                    ref.score_pipeline(y, b, w, src, refq), 2e-5)


@pytest.mark.parametrize("bad", ["int", "knots", "table_dtype", "k"])
def test_score_wrappers_reject_what_the_kernels_do_not_take(dev, bad):
    src, refq = _tables(np.random.default_rng(0), 16, dev)
    x, b, w = torch.rand(8, 3, device=dev), torch.rand(3, device=dev), \
        torch.ones(3, device=dev)
    if bad == "int":
        x = (x * 10).int()
    elif bad == "knots":
        src, refq = src[:1], refq[:1]
    elif bad == "table_dtype":
        src = src.double()
    else:
        b = b[:2]
    with pytest.raises(ValueError):
        sp.score_pipeline(x, b, w, src, refq)
    if bad != "k":
        with pytest.raises(ValueError):
            qm.quantile_map(x[:, 0], src, refq)


# decode attention: (b, s, hq, hkv, d, valid lengths)
DECODE_CASES = [
    (2, 256, 8, 2, 64, (256, 256)),
    (1, 512, 4, 4, 32, (300,)),
    (4, 128, 16, 2, 64, (128,) * 4),
    (1, 100, 2, 1, 32, (77,)),
    (3, 128, 4, 2, 32, (1, 64, 128)),
    (3, 200, 4, 2, 64, (0, 500, 130)),     # valid_len 0 and past S
    (2, 777, 8, 2, 80, (777, 400)),         # S not a multiple of 64, D = 80
    (1, 70, 8, 8, 128, (70,)),              # D = 128, one head per group
    (1, 90, 64, 1, 16, (33,)),              # 64 query heads on one KV head
    (1, 500, 64, 1, 128, (500,)),           # 64 heads at D = 128: 8 passes
    (2, 3000, 4, 2, 80, (3000, 1777)),      # D = 80 over many splits
    (2, 1000, 12, 2, 48, (1000, 999)),      # 6 heads a pass of 8, D = 48
]
DECODE_TOL = 2e-5   # float32; bf16 runs da.bf16_excess


def _decode_inputs(case, dtype, dev, seed=0):
    b, s, hq, hkv, d = case[:5]
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev).to(dtype)
            for shape in ((b, hq, d), (b, s, hkv, d), (b, s, hkv, d))]


def _decode_close(got, q, k, v, vlen):
    """float32 within 2e-5 of the plain version; bf16 within bf16's
    rounding of the plain version run in float32 on the same inputs."""
    assert got.dtype == q.dtype and got.shape == q.shape
    if q.dtype == torch.float32:
        torch.testing.assert_close(got, ref.decode_attention(q, k, v, vlen),
                                   rtol=DECODE_TOL, atol=DECODE_TOL)
        return
    want = ref.decode_attention(q.float(), k.float(), v.float(), vlen)
    assert da.bf16_excess(got, want) <= 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=lambda c: "-".join(map(str, c[:5])))
def test_decode_kernel_matches_plain_version(dev, case, dtype):
    q, k, v = _decode_inputs(case, dtype, dev)
    vlen = torch.tensor(case[5], dtype=torch.int32, device=dev)
    before = ops.LAUNCHES["decode_attention"]
    got = ops.decode_attention(q, k, v, vlen)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_attention"] == before + 1
    empty = vlen == 0
    assert torch.equal(got[empty], torch.zeros_like(got[empty]))
    _decode_close(got[~empty], q[~empty], k[~empty], v[~empty], vlen[~empty])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_decode_lengths_at_split_boundaries(dev, dtype):
    """Lengths one short of, at and one past the ends of the plan's
    first, second and last splits, one per batch row."""
    b, s, hkv, d = 9, 2000, 2, 64
    splits, chunk = da.plan_splits(b, hkv, s, d, dtype)
    assert splits > 2
    lens = [j * chunk + e for j in (1, 2, splits - 1) for e in (-1, 0, 1)]
    q, k, v = _decode_inputs((b, s, 8, hkv, d), dtype, dev, seed=3)
    vlen = torch.tensor(lens, dtype=torch.int32, device=dev)
    _decode_close(da.decode_attention(q, k, v, vlen), q, k, v, vlen)


def test_decode_kernel_reads_strided_caches(dev):
    """k and v as views of one packed (B, S, 2 Hkv, D) cache, q as a slice
    of a wider projection, read in place by their strides."""
    kv = torch.randn(2, 300, 4, 64, device=dev)
    k, v = kv[:, :, :2], kv[:, :, 2:]
    q = torch.randn(2, 12, 64, device=dev)[:, 2:10]
    vlen = torch.tensor([300, 123], dtype=torch.int32, device=dev)
    torch.testing.assert_close(da.decode_attention(q, k, v, vlen),
                               ref.decode_attention(q, k, v, vlen),
                               rtol=2e-5, atol=2e-5)


def test_decode_kernel_reads_packed_bf16_cache_views(dev):
    """qwen3-8b's widths: k and v as views of one packed (B, S, 16, 128)
    bf16 cache, q a slice of a wider projection."""
    kv = torch.randn(2, 300, 16, 128, device=dev).to(torch.bfloat16)
    k, v = kv[:, :, :8], kv[:, :, 8:]
    q = torch.randn(2, 40, 128, device=dev).to(torch.bfloat16)[:, 4:36]
    vlen = torch.tensor([300, 211], dtype=torch.int32, device=dev)
    _decode_close(da.decode_attention(q, k, v, vlen), q, k, v, vlen)


@pytest.mark.parametrize("view", ["pointer", "stride"])
def test_decode_misaligned_view_raises(dev, view):
    """A cache whose rows start 8 bytes off a 16-byte boundary, by its
    pointer or by its row stride."""
    q, k, v = _decode_inputs((1, 64, 4, 2, 128), torch.bfloat16, dev)
    if view == "pointer":
        k = torch.zeros(1, 64, 2, 136, device=dev,
                        dtype=torch.bfloat16)[..., 4:132]
    else:
        k = torch.zeros(1, 64, 2, 132, device=dev,
                        dtype=torch.bfloat16)[..., :128]
    vlen = torch.full((1,), 64, dtype=torch.int32, device=dev)
    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        ops.decode_attention(q, k, v, vlen)
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("shape,launches", [((4, 16_384, 8, 2, 64), 2),
                                            ((64, 64, 8, 8, 64), 1)],
                         ids=["split", "one_split"])
def test_decode_call_is_at_most_two_launches(dev, shape, launches):
    """The profiler sees the split pass and the combine, or the split pass
    alone where one split covers the cache, and nothing else."""
    from torch.profiler import ProfilerActivity, profile

    q, k, v = _decode_inputs(shape, torch.bfloat16, dev)
    vlen = torch.full((shape[0],), shape[1], dtype=torch.int32, device=dev)
    da.decode_attention(q, k, v, vlen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        da.decode_attention(q, k, v, vlen)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == launches, names
    assert "decode_split_mma_kernel" in names[0]
    assert all("decode_" in n for n in names)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_decode_waits_for_the_kernel_before_it(dev, dtype):
    """Both kernels are launched with programmatic dependent launch: a
    call right after kernels that rewrite q, the caches and the lengths in
    the same stream reads what they wrote, and the next writes wait for
    its combine to have read the workspace."""
    case = (4, 4096, 8, 2, 64)
    q, k, v = _decode_inputs(case, dtype, dev, seed=5)
    vlen = torch.full((4,), 4096, dtype=torch.int32, device=dev)
    da.decode_attention(q, k, v, vlen)
    q2, k2, v2 = _decode_inputs(case, dtype, dev, seed=6)
    torch.cuda.synchronize()
    outs = []
    for _ in range(3):
        q.copy_(q2)
        k.copy_(k2)
        v.copy_(v2)
        vlen.sub_(7)
        outs.append(da.decode_attention(q, k, v, vlen))
        vlen.add_(7)
    torch.cuda.synchronize()
    for got in outs:
        _decode_close(got, q2, k2, v2, vlen - 7)


def test_decode_kernel_builds_without_spills(dev):
    """ptxas compiled every instantiation without spills: the CUDA-core
    split pass (float32 with 4 lane counts, bf16 with 3, each with 4 head
    counts), the tensor-core split pass (D = 32, 64, 96, 128) and the
    combine (2 dtypes)."""
    from repro_torch.kernels import _build

    _, log = _build.build_log("decode_attention")
    entries = [ln for ln in log.splitlines()
               if "Compiling entry function" in ln]
    assert sum("decode_split_simt_kernel" in ln for ln in entries) == 28, log
    assert sum("decode_split_mma_kernel" in ln for ln in entries) == 4, log
    assert sum("decode_combine_kernel" in ln for ln in entries) == 2, log
    spills = [ln for ln in log.splitlines() if "spill" in ln]
    assert len(spills) >= 34 and all(
        "0 bytes spill stores, 0 bytes spill loads" in ln
        for ln in spills), log


@pytest.mark.parametrize("bad", ["vlen_dtype", "vlen_cpu", "d24", "mixed",
                                 "group"])
def test_decode_wrapper_rejects_what_the_kernel_does_not_take(dev, bad):
    q, k, v = _decode_inputs((2, 64, 4, 2, 32), torch.float32, dev)
    vlen = torch.full((2,), 64, dtype=torch.int32, device=dev)
    if bad == "vlen_dtype":
        vlen = vlen.long()
    elif bad == "vlen_cpu":
        vlen = vlen.cpu()
    elif bad == "d24":
        q, k, v = q[..., :24], k[..., :24], v[..., :24]
    elif bad == "mixed":
        k = k.to(torch.bfloat16)
    else:
        q = torch.randn(2, 130, 32, device=dev)
        k, v = k[:, :, :1], v[:, :, :1]
    with pytest.raises(ValueError):
        da.decode_attention(q, k, v, vlen)
