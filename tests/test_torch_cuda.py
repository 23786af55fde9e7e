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
    got = sp.score_pipeline_banked(y, tid, *bank)
    assert torch.isnan(got[[1, 2, 4]]).all()
    assert torch.isfinite(got[[0, 3, 5]]).all()
    want = ref.score_pipeline_banked(y, tid, *bank)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(got[[0, 3, 5]], want[[0, 3, 5]])


def _limit_t(dev, n):
    """The largest T whose bank of N-knot tables the shared-bank kernel
    takes."""
    return sp.card(dev)[0] // sp.banked_shared_bytes(1, n)


# (T, rows, path): 65,536 rows on T = 64 and on the largest T that fits
# stage the bank in shared memory; a 1,024-row window on T = 64 and 65,536
# rows on the first T past the limit and on T = 4,096 read it through L1/L2
BANKS = {"t64": (lambda dev: 64, 65_536, "shared"),
         "t64_window": (lambda dev: 64, 1_024, "global"),
         "at_limit": (lambda dev: _limit_t(dev, 256), 65_536, "shared"),
         "past_limit": (lambda dev: _limit_t(dev, 256) + 1, 65_536,
                        "global"),
         "t4096": (lambda dev: 4096, 65_536, "global")}


def _layout(name, rng, t, m):
    if name == "sorted":
        return np.repeat(np.arange(t), -(-m // t))[:m]
    if name == "interleaved":
        return np.arange(m) % t
    return rng.integers(0, t, m)


def _banked_case(dev, bank, k, seed):
    rng = np.random.default_rng(seed)
    t_of, m, path = BANKS[bank]
    t = t_of(dev)
    assert sp.banked_path(t, 256, m, *sp.card(dev)) == path
    return rng, t, _bank(rng, t, k, 256, dev), torch.tensor(
        rng.uniform(0, 1, (m, k)).astype(np.float32), device=dev)


def _ids(a, dev):
    return torch.tensor(np.asarray(a, np.int32), device=dev)


def _same_or_close(got, want):
    """NaN in the same rows and within 2e-5 elsewhere."""
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    torch.testing.assert_close(got[ok], want[ok], **TOL)


@pytest.mark.parametrize("layout", ["sorted", "interleaved", "random"])
@pytest.mark.parametrize("k", [1, 3, 5, 8])
@pytest.mark.parametrize("bank", sorted(BANKS))
def test_banked_paths_match_plain_version(dev, bank, k, layout):
    rng, t, params, y = _banked_case(dev, bank, k, seed=k)
    tid = _ids(_layout(layout, rng, t, y.shape[0]), dev)
    before = ops.LAUNCHES["score_pipeline_banked"]
    got = ops.score_pipeline_banked(y, tid, *params)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["score_pipeline_banked"] == before + 1
    _same_or_close(got, ref.score_pipeline_banked(y, tid, *params))


@pytest.mark.parametrize("bank", sorted(BANKS))
def test_banked_paths_on_odd_tables(dev, bank):
    """Unsorted tables, NaN knots and flat runs in some tenants' rows, NaN
    scores in some rows: the count is the reference's on every table."""
    rng, t, (b, w, src, refq), y = _banked_case(dev, bank, 3, seed=11)
    src = src.clone()
    src[1::5] = torch.rand(src[1::5].shape, device=dev)   # unsorted
    src[2::5, 7] = float("nan")                           # a NaN knot
    src[3::5, 20:90] = src[3::5, 20:21]                   # a flat run
    y[::17, 1] = float("nan")
    tid = _ids(rng.integers(0, t, y.shape[0]), dev)
    _same_or_close(sp.score_pipeline_banked(y, tid, b, w, src, refq),
                   ref.score_pipeline_banked(y, tid, b, w, src, refq))


@pytest.mark.parametrize("bank", sorted(BANKS))
def test_banked_paths_map_scores_on_knots_bitwise(dev, bank):
    """Identity T^C and A (K = 1, beta = w = 1): a score on knot j of its
    tenant's table, flat run included, maps to qr[j] bitwise."""
    rng, t, (_, _, src, refq), y = _banked_case(dev, bank, 1, seed=12)
    m = y.shape[0]
    src = src.clone()
    src[:, 100:120] = src[:, 100:101]
    tid = _ids(rng.integers(0, t, m), dev)
    j = torch.tensor(rng.integers(0, 255, m), device=dev)
    y = src[tid.long(), j][:, None].contiguous()
    ones = torch.ones(t, 1, device=dev)
    got = sp.score_pipeline_banked(y, tid, ones, ones, src, refq)
    assert torch.equal(got, ref.score_pipeline_banked(y, tid, ones, ones,
                                                      src, refq))


@pytest.mark.parametrize("bank", sorted(BANKS))
def test_banked_paths_out_of_range_ids_on_every_row(dev, bank):
    rng, t, params, y = _banked_case(dev, bank, 8, seed=13)
    ids = rng.integers(0, t, y.shape[0])
    ids[::11] = t + 3
    ids[5::17] = -1
    ids[7::29] = -t
    tid = _ids(ids, dev)
    got = ops.score_pipeline_banked(y, tid, *params)
    want = ref.score_pipeline_banked(y, tid, *params)
    out = (tid < 0) | (tid >= t)
    assert torch.isnan(got[out]).all()
    _same_or_close(got, want)


def _four_bytes_off(x):
    """``x`` copied into a contiguous tensor that starts 4 bytes past a
    16-byte boundary."""
    out = torch.empty(x.numel() + 1, device=x.device,
                      dtype=x.dtype)[1:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.parametrize("n,misaligned", [(33, False), (2, False),
                                          (256, True)],
                         ids=["n33", "n2", "misaligned"])
def test_banked_shared_path_copies_odd_tables(dev, n, misaligned):
    """Tables whose rows are not whole 16-byte quads, or that start off a
    16-byte boundary, reach shared memory by cp.async instead of TMA bulk
    copies; the kernel still agrees with the plain version."""
    rng = np.random.default_rng(n)
    t, m = 64, 32_768
    betas, weights, src, refq = _bank(rng, t, 3, n, dev)
    if misaligned:
        src, refq = _four_bytes_off(src), _four_bytes_off(refq)
        assert src.data_ptr() % 16 == 4
    assert sp.banked_path(t, n, m, *sp.card(dev)) == "shared"
    y = torch.tensor(rng.uniform(0, 1, (m, 3)).astype(np.float32),
                     device=dev)
    tid = _ids(rng.integers(0, t, m), dev)
    _same_or_close(sp.score_pipeline_banked(y, tid, betas, weights, src,
                                            refq),
                   ref.score_pipeline_banked(y, tid, betas, weights, src,
                                             refq))


@pytest.mark.parametrize("k", [3, 8])
@pytest.mark.parametrize("n,misaligned", [(33, False), (256, True)],
                         ids=["n33", "misaligned"])
@pytest.mark.parametrize("bank", ["t64_window", "past_limit"])
def test_banked_global_path_reads_odd_tables(dev, bank, n, misaligned, k):
    """On the L1/L2 path, tables whose rows are not whole 16-byte quads, or
    that start off a 16-byte boundary, are read a float at a time (at K = 8
    with 16-byte score reads, at K = 3 without); the kernel still agrees
    with the plain version on every row."""
    rng = np.random.default_rng(100 * n + k)
    m = BANKS[bank][1]
    t = 64 if bank == "t64_window" else _limit_t(dev, n) + 1
    betas, weights, src, refq = _bank(rng, t, k, n, dev)
    if misaligned:
        src, refq = _four_bytes_off(src), _four_bytes_off(refq)
        assert src.data_ptr() % 16 == 4
    assert sp.banked_path(t, n, m, *sp.card(dev)) == "global"
    y = torch.tensor(rng.uniform(0, 1, (m, k)).astype(np.float32),
                     device=dev)
    tid = _ids(rng.integers(0, t, m), dev)
    _same_or_close(sp.score_pipeline_banked(y, tid, betas, weights, src,
                                            refq),
                   ref.score_pipeline_banked(y, tid, betas, weights, src,
                                             refq))


def test_banked_shared_bytes_match_the_kernel(dev):
    lib = sp._library()
    for t, n in [(64, 256), (1, 2), (7, 33), (300, 130), (5, 28)]:
        assert lib.score_pipeline_banked_shared_bytes(t, n) == \
            sp.banked_shared_bytes(t, n)


# One profiled call of each redesigned kernel on each of its paths, in a
# process of its own: a CUDA-only profiler session here would leave later
# ones in this process (the decode launch test's) with no device events.
_LAUNCH_PROBE = r"""
import json
import torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels import quantile_map as qm
from repro_torch.kernels import score_pipeline as sp

dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(0)


def bank(t, k, n=256):
    src, ref = (torch.sort(torch.rand(t, n, device=dev, generator=g), -1)[0]
                for _ in range(2))
    return (torch.rand(t, k, device=dev, generator=g),
            torch.rand(t, k, device=dev, generator=g) + 0.1, src, ref)


def kernels(fn):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


out = {}
y = torch.rand(65_536, 8, device=dev, generator=g)
for name, t, m in (("t64", 64, 65_536), ("t64_window", 64, 1_024),
                   ("t4096", 4096, 65_536)):
    b = bank(t, 8)
    tid = torch.randint(0, t, (m,), device=dev, generator=g,
                        dtype=torch.int32)
    out[name] = kernels(lambda: sp.score_pipeline_banked(y[:m], tid, *b))
src, ref = (torch.sort(torch.rand(256, device=dev, generator=g))[0]
            for _ in range(2))
w = torch.ones(8, device=dev)
for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
    x = y.to(dtype)
    out[name] = kernels(lambda: sp.score_pipeline(x, y[0], w, src, ref))
    # T^Q on a size that is no multiple of the block, and on a view off a
    # 16-byte boundary
    flat = x.reshape(-1)
    out[f"qm_{name}"] = kernels(lambda: qm.quantile_map(flat[:200_003], src,
                                                        ref))
    out[f"qm_{name}_off"] = kernels(lambda: qm.quantile_map(flat[1:1_001],
                                                            src, ref))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def kernels_a_call():
    """The CUDA kernels one call runs, by case, from a fresh process."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src"
    env = {**os.environ, "PYTHONPATH": str(src)}
    run = subprocess.run([sys.executable, "-c", _LAUNCH_PROBE], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr
    return json.loads(run.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("bank", ["t64", "t64_window", "t4096"])
def test_banked_call_is_one_launch(kernels_a_call, bank):
    names = kernels_a_call[bank]
    assert len(names) == 1, names
    assert f"banked_{BANKS[bank][2]}_kernel" in names[0]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_score_pipeline_call_is_one_launch(kernels_a_call, dtype):
    names = kernels_a_call[dtype]
    assert len(names) == 1 and "score_pipeline_kernel" in names[0], names


@pytest.mark.parametrize("case", ["qm_f32", "qm_f32_off", "qm_bf16",
                                  "qm_bf16_off"])
def test_quantile_map_call_is_one_launch(kernels_a_call, case):
    names = kernels_a_call[case]
    assert len(names) == 1 and "quantile_map_kernel" in names[0], names


@pytest.mark.parametrize("bank", ["t64", "t64_window", "t4096"])
def test_banked_waits_for_the_kernel_before_it(dev, bank):
    """Programmatic dependent launch: a call right after kernels that
    rewrite the scores, ids and bank in the same stream reads what they
    wrote."""
    rng, t, params, y = _banked_case(dev, bank, 8, seed=15)
    tid = _ids(rng.integers(0, t, y.shape[0]), dev)
    _, t2, params2, y2 = _banked_case(dev, bank, 8, seed=16)
    tid2 = _ids(rng.integers(0, t, y.shape[0]), dev)
    sp.score_pipeline_banked(y, tid, *params)
    torch.cuda.synchronize()
    outs = []
    for _ in range(3):
        y.copy_(y2)
        tid.copy_(tid2)
        for p, p2 in zip(params, params2):
            p.copy_(p2)
        outs.append(sp.score_pipeline_banked(y, tid, *params))
        y.add_(1.0)      # the next writes wait for the call's reads
        tid.add_(1)
        for p in params:
            p.mul_(0.5)
    torch.cuda.synchronize()
    want = ref.score_pipeline_banked(y2, tid2, *params2)
    for got in outs:
        _same_or_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_score_pipeline_waits_for_the_kernel_before_it(dev, dtype):
    rng = np.random.default_rng(17)
    src, refq = _tables(rng, 256, dev)
    src2, refq2 = _tables(rng, 256, dev)
    y = torch.rand(65_536, 8, device=dev).to(dtype)
    y2 = torch.rand(65_536, 8, device=dev).to(dtype)
    b, w = torch.rand(8, device=dev), torch.rand(8, device=dev) + 0.1
    b2, w2 = torch.rand(8, device=dev), torch.rand(8, device=dev) + 0.1
    sp.score_pipeline(y, b, w, src, refq)
    torch.cuda.synchronize()
    outs = []
    for _ in range(3):
        for x, x2 in ((y, y2), (b, b2), (w, w2), (src, src2),
                      (refq, refq2)):
            x.copy_(x2)
        outs.append(sp.score_pipeline(y, b, w, src, refq))
        for x in (y, b, w, src, refq):
            x.mul_(0.5)
    torch.cuda.synchronize()
    want = ref.score_pipeline(y2, b2, w2, src2, refq2)
    for got in outs:
        _close_with_nan(got, want, SCORE_TOL[dtype])


@pytest.mark.parametrize("name,kernels", [
    ("score_pipeline_banked", {"banked_shared_kernel": 2,
                               "banked_global_kernel": 4}),
    ("score_pipeline", {"score_pipeline_kernel": 3}),
    ("quantile_map", {"quantile_map_kernel": 2})])
def test_score_kernels_build_without_spills(dev, name, kernels):
    """ptxas compiled every instantiation without spills."""
    from repro_torch.kernels import _build

    _, log = _build.build_log(name)
    entries = [ln for ln in log.splitlines()
               if "Compiling entry function" in ln]
    for kernel, count in kernels.items():
        assert sum(kernel in ln for ln in entries) == count, log
    spills = [ln for ln in log.splitlines() if "spill" in ln]
    assert len(spills) >= sum(kernels.values()) and all(
        "0 bytes spill stores, 0 bytes spill loads" in ln
        for ln in spills), log


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


def _qm_scores(rng, m, dtype, dev, offset=0):
    """``m`` scores over and past [0, 1], every fifth NaN, in a view that
    starts ``offset`` elements past a 16-byte boundary."""
    x = torch.tensor(rng.uniform(-0.1, 1.1, m + offset).astype(np.float32),
                     device=dev).to(dtype)[offset:]
    x[::5] = float("nan")
    return x


@SCORE_DTYPES
@pytest.mark.parametrize("m,offset", [
    (1, 0), (3, 0), (255, 0), (257, 0), (20_003, 0), (65_536, 0),
    (2_000_003, 0), (3_001, 1), (3_001, 3), (65_535, 7)])
def test_quantile_map_ragged_sizes_and_offsets(dev, dtype, m, offset):
    """Sizes that are no multiple of the block, a grid that loops (past the
    blocks the card keeps resident) and views off a 16-byte boundary; the
    launch is counted once a call, and ops gives the same bits."""
    rng = np.random.default_rng(40 + offset)
    src, refq = _tables(rng, 256, dev)
    x = _qm_scores(rng, m, dtype, dev, offset)
    before = ops.LAUNCHES["quantile_map"]
    got = qm.quantile_map(x, src, refq)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["quantile_map"] == before + 1
    _close_with_nan(got, ref.quantile_map(x, src, refq), SCORE_TOL[dtype])
    same = ops.quantile_map(x, src, refq)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(got.view(bits), same.view(bits))


@SCORE_DTYPES
@pytest.mark.parametrize("table", ["sorted", "unsorted", "nan_knot", "flat",
                                   "all_flat", "descending"])
@pytest.mark.parametrize("n", [2, 5, 256, 4095, 4096])
def test_quantile_map_on_each_bucket_form(dev, table, n, dtype):
    """A sorted, flat or all-flat table takes the block's search, any
    other the exact count, at the smallest and largest N and at N that is
    not a multiple of 4; both agree with the plain version."""
    rng = np.random.default_rng(n)
    src, refq = _tables(rng, n, dev)
    if table == "unsorted":
        src = torch.tensor(rng.uniform(0, 1, n).astype(np.float32),
                           device=dev)
    elif table == "nan_knot":
        src[n // 2] = float("nan")
    elif table == "flat":
        src[n // 4:n // 2 + 1] = src[n // 4]
    elif table == "all_flat":
        src[:] = 0.5
    elif table == "descending":
        src = src.flip(0).contiguous()
    for m, offset in ((20_003, 0), (999, 1)):
        x = _qm_scores(rng, m, dtype, dev, offset)
        _close_with_nan(qm.quantile_map(x, src, refq),
                        ref.quantile_map(x, src, refq), SCORE_TOL[dtype])


@SCORE_DTYPES
def test_quantile_map_tables_off_16_bytes(dev, dtype):
    """Tables that start 4 bytes past a 16-byte boundary reach shared
    memory by 4-byte copies; the scores on knots still map bitwise."""
    rng = np.random.default_rng(9)
    src, refq = _tables(rng, 256, dev)
    src_off, refq_off = _four_bytes_off(src), _four_bytes_off(refq)
    x = _qm_scores(rng, 10_000, dtype, dev)
    knots = src.to(dtype).float()
    on = knots[:-1].to(dtype)
    _close_with_nan(qm.quantile_map(x, src_off, refq_off),
                    ref.quantile_map(x, src, refq), SCORE_TOL[dtype])
    assert torch.equal(qm.quantile_map(on, _four_bytes_off(knots), refq_off),
                       ref.quantile_map(on, knots, refq))


@SCORE_DTYPES
def test_quantile_map_waits_for_the_kernel_before_it(dev, dtype):
    """Programmatic dependent launch: a call right after kernels that
    rewrite the scores and both tables reads what they wrote."""
    rng = np.random.default_rng(18)
    src, refq = _tables(rng, 256, dev)
    src2, refq2 = _tables(rng, 256, dev)
    x = torch.rand(65_536, device=dev).to(dtype)
    x2 = torch.rand(65_536, device=dev).to(dtype)
    qm.quantile_map(x, src, refq)
    torch.cuda.synchronize()
    outs = []
    for _ in range(3):
        for a, b in ((x, x2), (src, src2), (refq, refq2)):
            a.copy_(b)
        outs.append(qm.quantile_map(x, src, refq))
        for a in (x, src, refq):
            a.mul_(0.5)
    torch.cuda.synchronize()
    want = ref.quantile_map(x2, src2, refq2)
    for got in outs:
        _close_with_nan(got, want, SCORE_TOL[dtype])


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


@SCORE_DTYPES
@pytest.mark.parametrize("k", [3, 8])
@pytest.mark.parametrize("table", ["sorted", "unsorted", "nan_knot", "flat",
                                   "all_flat"])
def test_score_pipeline_on_each_bucket_form(dev, table, k, dtype):
    """A sorted, flat or all-flat table takes the block's binary search,
    an unsorted or NaN-knot table the exact count; both agree with the
    plain version, in float32 and bf16, with 16-byte and scalar loads."""
    rng = np.random.default_rng(k)
    src, refq = _tables(rng, 256, dev)
    if table == "unsorted":
        src = torch.tensor(rng.uniform(0, 1, 256).astype(np.float32),
                           device=dev)
    elif table == "nan_knot":
        src[77] = float("nan")
    elif table == "flat":
        src[40:90] = src[40]
    elif table == "all_flat":
        src[:] = 0.5
    y = torch.tensor(rng.uniform(-0.1, 1.1, (5000, k)).astype(np.float32),
                     device=dev).to(dtype)
    y[::13, 0] = float("nan")
    b = torch.tensor(rng.uniform(0.02, 1, k).astype(np.float32), device=dev)
    w = torch.tensor(rng.uniform(0.5, 2, k).astype(np.float32), device=dev)
    _close_with_nan(sp.score_pipeline(y, b, w, src, refq),
                    ref.score_pipeline(y, b, w, src, refq), SCORE_TOL[dtype])


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


# fused device tracking: the staging tensor and the fused aggregate on the
# card, against the port's eager tracking on the card
TRACK_DIM, TRACK_TENANTS = 8, 4


def _tracking_server(dev, track_device, staging=4096, track=True):
    from repro_torch.core.predictor import PredictorSpec
    from repro_torch.core.routing import Condition, RoutingTable, ScoringRule
    from repro_torch.core.transforms import QuantileMap
    from repro_torch.serving.server import MuseServer, ServerConfig

    def linear(seed):
        w = np.random.default_rng(seed).normal(0, 1, TRACK_DIM).astype(
            np.float32)
        return lambda x: 1.0 / (1.0 + np.exp(-(np.asarray(x, np.float32)
                                                @ w)))

    factories = {f"m{i}": (lambda i=i: linear(i)) for i in (1, 2)}
    rules = tuple(ScoringRule(Condition(tenants=(f"t{i}",)), f"p{i}")
                  for i in range(TRACK_TENANTS)) + \
        (ScoringRule(Condition(), "p0"),)
    server = MuseServer(
        RoutingTable(rules, (), version="v1"),
        ServerConfig(track_quantiles=track, track_device=track_device,
                     track_staging=staging, quantile_capacity=256,
                     recent_capacity=32),
        device=dev)
    for i in range(TRACK_TENANTS):
        server.deploy(PredictorSpec(f"p{i}", ("m1", "m2"), (0.2, 0.4),
                                    (1.0, 1.0), QuantileMap.identity(64)),
                      factories)
    return server


def _tracking_windows():
    from repro_torch.core.routing import Intent
    from repro_torch.serving.types import ScoringRequest

    def req(tenant, seed):
        x = np.random.default_rng(seed).normal(0, 1, TRACK_DIM)
        return ScoringRequest(Intent(tenant=tenant), x.astype(np.float32))

    rng = np.random.default_rng(7)
    out, k = [], 0
    for _ in range(18):
        out.append([req(f"t{rng.integers(0, TRACK_TENANTS)}", k := k + 1)
                    for _ in range(48)])
    out.append([req("t0", k := k + 1) for _ in range(101)])
    return out


@pytest.mark.parametrize("staging", [4096, 64, 8])
def test_fused_tracking_equals_eager_tracking(dev, staging):
    """Staging 4096 (nothing drained before the snapshot), 64 (spills) and
    8 (host fallbacks): responses bitwise equal, and after the sync the
    estimator snapshots bitwise equal (meta, live prefixes)."""
    host = _tracking_server(dev, False)
    fused = _tracking_server(dev, True, staging)
    off = _tracking_server(dev, False, track=False)
    windows = _tracking_windows()
    for win in windows:
        a, b, c = (s.score_batch(win) for s in (host, fused, off))
        assert [r.score for r in a] == [r.score for r in b] == \
            [r.score for r in c]
    tracker = fused._tracker
    assert tracker._staging.device.type == torch.device(dev).type
    if staging == 4096:
        assert tracker.pending_total() > 0 and tracker.spills == 0
    elif staging == 64:
        assert tracker.spills > 0
    else:
        assert tracker.host_fallbacks > 0
    want = host.snapshot_estimator_checkpoints()
    got = fused.snapshot_estimator_checkpoints()
    assert tracker.pending_total() == 0
    assert want.keys() == got.keys() and want
    for key, (arrays, meta) in want.items():
        assert got[key][1] == meta, key
        for name, live in (("buf", meta["filled"]),
                           ("recent", meta["recent_filled"])):
            assert np.array_equal(got[key][0][name][:live],
                                  arrays[name][:live]), (key, name)


# ------------------------------------------------- audit replay on the card
def _padded_lifecycle_bank(dev, t=33, short=128):
    """T - 1 rows of 256-knot tables and one of ``short`` knots, as a fleet
    serves a cold-start tenant beside refitted ones: the bank edge-pads
    the short row to 256, the audit ledger keeps it unpadded."""
    from repro_torch.core.transforms import TransformBank

    rng = np.random.default_rng(t)
    rows = []
    for i in range(t):
        n = short if i == t - 1 else 256
        rows.append(tuple(torch.tensor(a.astype(np.float32)) for a in (
            rng.uniform(0.05, 1, 3), rng.uniform(0.5, 2, 3),
            np.sort(rng.beta(2, 5, n)), np.sort(rng.uniform(0, 1, n)))))
    return rows, TransformBank.from_params(rows, device=dev)


@pytest.mark.parametrize("m,path", [(1_024, "global"), (32_768, "shared")])
def test_one_row_replay_equals_rows_served_on_either_path(dev, m, path):
    """A row scored inside an M-row mixed window equals the same row
    replayed alone through a one-row bank of its own unpadded tables, bit
    for bit, on both banked paths; the padded tenant's rows included."""
    from repro_torch.serving.audit import GenerationLedger

    rows, bank = _padded_lifecycle_bank(dev)
    t = bank.num_rows
    if sp.banked_path(t, 256, m, *sp.card(dev)) != path:
        pytest.skip(f"{m} rows take the other path on this card")
    rng = np.random.default_rng(m)
    y = torch.tensor(rng.uniform(0, 1, (m, 3)).astype(np.float32),
                     device=dev)
    tid = torch.tensor(rng.integers(0, t, m).astype(np.int32), device=dev)
    served = ops.score_pipeline_banked(y, tid, bank.betas, bank.weights,
                                       bank.src_quantiles,
                                       bank.ref_quantiles).cpu()
    ledger = GenerationLedger(device=dev)
    for i, row in enumerate(rows):
        ledger.record(0, f"p{i}", *row)
    ids = tid.cpu().numpy()
    picks = np.concatenate([np.flatnonzero(ids == t - 1)[:256],
                            rng.choice(m, 256, replace=False)])
    raws = y.cpu().numpy()
    for j in picks:
        got = ledger.replay_score({"bank_generation": 0,
                                   "predictor": f"p{ids[j]}",
                                   "raw_scores": raws[j].tolist()})
        assert got == float(served[j]), (j, ids[j])


def test_ledger_replay_launches_the_kernel_only(dev, monkeypatch):
    """``replay_score(fused=True)`` on a CUDA ledger is one launch of the
    hand-written kernel a replay, and never the plain version."""
    from repro_torch.serving import audit

    rows, _ = _padded_lifecycle_bank(dev, t=2)
    ledger = audit.GenerationLedger(device="cuda")
    ledger.record(3, "p", *rows[1])

    def plain(*args):
        raise AssertionError("the plain version ran")

    monkeypatch.setattr(ref, "score_pipeline_banked", plain)
    monkeypatch.setattr(audit, "banked_score_pipeline", plain)
    before = ops.LAUNCHES["score_pipeline_banked"]
    fields = {"bank_generation": 3, "predictor": "p",
              "raw_scores": [0.1, 0.5, 0.9]}
    scores = [ledger.replay_score(fields) for _ in range(3)]
    assert ops.LAUNCHES["score_pipeline_banked"] == before + 3
    assert len(set(scores)) == 1 and np.isfinite(scores[0])
    with pytest.raises(AssertionError, match="plain version"):
        ledger.replay_score(fields, fused=False)


# ------------------------------------------- the last knot, padded or not
def _last_knot_tables(dev, tables=2000, n=128, n_bank=256):
    """2,000 random 128-knot tables (references of a fraud score's shape:
    mass near 0, last knot 1) alone and edge-padded to 256 knots, and three
    scores a table: on its last knot and one ulp on either side."""
    rng = np.random.default_rng(19)
    src = np.sort(rng.uniform(0, 1, (tables, n)), -1).astype(np.float32)
    refq = np.concatenate([np.sort(rng.beta(0.3, 5, (tables, n - 1)), -1),
                           np.ones((tables, 1))], -1).astype(np.float32)
    pad = ((0, 0), (0, n_bank - n))
    last = src[:, -1]
    x = np.stack([last, np.nextafter(last, np.float32(np.inf)),
                  np.nextafter(last, np.float32(-np.inf))], -1)

    def f32(a):
        return torch.tensor(np.ascontiguousarray(a, np.float32), device=dev)

    return ((f32(src), f32(refq)),
            (f32(np.pad(src, pad, "edge")), f32(np.pad(refq, pad, "edge"))),
            f32(x), f32(refq[:, -1]))


@pytest.mark.parametrize("kind", ["quantile_map", "score_pipeline"])
def test_last_knot_is_bitwise_padded_or_not(dev, kind):
    """A score on or past a table's last knot maps to exactly its last
    reference knot, so edge padding changes no bit there (as at every
    other knot), through the T^Q kernel and the shared-parameter one."""
    unpadded, padded, x, last = _last_knot_tables(dev)
    one = torch.ones(1, device=dev)
    got = {}
    for name, (qs, qr) in (("unpadded", unpadded), ("padded", padded)):
        rows = []
        for i in range(0, x.shape[0], 7):
            if kind == "quantile_map":
                rows.append(qm.quantile_map(x[i], qs[i], qr[i]))
            else:
                rows.append(sp.score_pipeline(x[i][:, None], one, one,
                                              qs[i], qr[i]))
        got[name] = torch.stack(rows)
    assert torch.equal(got["padded"], got["unpadded"])
    assert torch.equal(got["unpadded"][:, :2],
                       last[::7, None].expand(-1, 2))


@pytest.mark.parametrize("path", ["shared", "global"])
def test_last_knot_is_bitwise_on_both_banked_paths(dev, path):
    """The banked kernel on each path: a bank of 100 padded tables scores
    the same bits as the bank of the same tables unpadded, and the plain
    version agrees with both bit for bit."""
    unpadded, padded, x, last = _last_knot_tables(dev, tables=100)
    # 30,000 rows take the shared path, 300 the L1/L2 one
    reps = 100 if path == "shared" else 1
    tid = torch.arange(100, dtype=torch.int32,
                       device=dev).repeat_interleave(3).repeat(reps)
    y = x.reshape(-1, 1).repeat(reps, 1)
    ones = torch.ones(100, 1, device=dev)
    out = {}
    for name, (qs, qr) in (("unpadded", unpadded), ("padded", padded)):
        bank = (ones, ones, qs, qr)
        n = qs.shape[1]
        if sp.banked_path(100, n, y.shape[0], *sp.card(dev)) != path:
            pytest.skip(f"{y.shape[0]} rows take the other path here")
        out[name] = sp.score_pipeline_banked(y, tid, *bank)
        assert torch.equal(out[name], ref.score_pipeline_banked(y, tid,
                                                                *bank))
    assert torch.equal(out["padded"], out["unpadded"])
    assert torch.equal(out["unpadded"][:300].view(100, 3)[:, :2],
                       last[:, None].expand(-1, 2))


# ----------------------------------------------- the tiered store, on card
def _tier_rows(rng, t, k=4, n=256):
    inc = rng.uniform(1e-3, 1, (2, t, n)).astype(np.float32)
    q = np.cumsum(inc, -1, dtype=np.float32)
    q /= q[..., -1:]
    return (rng.uniform(0.05, 1, (t, k)).astype(np.float32),
            rng.uniform(0.1, 2, (t, k)).astype(np.float32), q[0], q[1])


def _tier_store(dev, rows, **config):
    from repro_torch.serving.tiering import (HostBankStore, TieredBankStore,
                                             TieringConfig)

    return TieredBankStore(HostBankStore(*rows), TieringConfig(**{
        "hot_capacity": 8, "victim_capacity": 4, **config}), device=dev)


def _dense_on(dev, rows, raws, tid):
    return ops.score_pipeline_banked(
        torch.tensor(raws, device=dev),
        torch.tensor(np.asarray(tid, np.int32), device=dev),
        *(torch.tensor(r, device=dev) for r in rows)).cpu().numpy()


@pytest.mark.parametrize("overlap", [True, False])
def test_tiered_dispatch_equals_dense_bank(dev, overlap):
    """Tiered scores on the card equal the dense bank's bit for bit: cold
    (staging passes through the victim cache), after a promotion, after a
    prefetch and after a publish; every dispatch launches the kernel."""
    from repro_torch.core.transforms import QuantileMap

    rng = np.random.default_rng(21)
    rows = _tier_rows(rng, 64)
    store = _tier_store(dev, rows, overlap_staging=overlap)
    assert store._view.betas.device.type == torch.device(dev).type
    raws = rng.uniform(0, 1, (1000, 4)).astype(np.float32)
    tid = rng.integers(0, 64, 1000)
    before = ops.LAUNCHES["score_pipeline_banked"]
    got, _ = store.dispatch(raws, tid)
    assert store.metrics["extra_passes"] > 0
    assert ops.LAUNCHES["score_pipeline_banked"] == \
        before + store.metrics["extra_passes"] + 1
    assert np.array_equal(got, _dense_on(dev, rows, raws, tid))
    store.rebalance()
    resident = set(store.resident_rows().tolist())
    cold = [r for r in range(64) if r not in resident][:4]
    assert store.prefetch(np.asarray(cold)) == 4
    got, _ = store.dispatch(raws, tid)
    assert np.array_equal(got, _dense_on(dev, rows, raws, tid))
    src = np.sort(rng.uniform(0, 1, 256)).astype(np.float32)
    hot = int(store.hot_rows()[0])
    store.apply_updates({
        hot: QuantileMap(torch.tensor(src), torch.tensor(src ** 2)),
        cold[0]: QuantileMap(torch.tensor(src), torch.tensor(src ** 3))})
    host = store.host
    got, gen = store.dispatch(raws, tid)
    assert gen == 1
    assert np.array_equal(got, _dense_on(
        dev, (host.betas, host.weights, host.src_quantiles,
              host.ref_quantiles), raws, tid))


def test_tiered_prefetch_under_concurrent_dispatch(dev):
    """Prefetches built on the side stream (through the one pinned buffer)
    while another thread dispatches: every dispatch bitwise the dense
    bank, and a view once captured never written in place."""
    import threading

    rng = np.random.default_rng(22)
    rows = _tier_rows(rng, 2000)
    store = _tier_store(dev, rows, hot_capacity=64, victim_capacity=32)
    store.tracker.record(np.arange(64))
    store.rebalance()
    first = store._view
    snapshot = [x.clone() for x in (first.betas, first.src_quantiles)]
    churn = [rng.integers(0, 2000, 16) for _ in range(64)]
    stop = threading.Event()

    def churner():
        i = 0
        while not stop.is_set():
            store.prefetch(churn[i % len(churn)])
            i += 1

    th = threading.Thread(target=churner, daemon=True)
    th.start()
    try:
        for w in range(40):
            mix = np.where(rng.random(512) < 0.9, rng.integers(0, 64, 512),
                           rng.integers(0, 2000, 512))
            raws = rng.uniform(0, 1, (512, 4)).astype(np.float32)
            got, _ = store.dispatch(raws, mix)
            assert np.array_equal(got, _dense_on(dev, rows, raws, mix)), w
    finally:
        stop.set()
        th.join()
    assert store.metrics["prefetched_rows"] > 0
    assert torch.equal(first.betas, snapshot[0])
    assert torch.equal(first.src_quantiles, snapshot[1])


def test_tiered_server_and_engine_equal_the_dense_server(dev):
    """A tiered server through the async engine on the card: every
    response bitwise the dense server's, prefetches landing before the
    transform stage, and fused device tracking counting every event."""
    from repro_torch.core.predictor import PredictorSpec
    from repro_torch.core.routing import (Condition, Intent, RoutingTable,
                                          ScoringRule)
    from repro_torch.core.transforms import QuantileMap
    from repro_torch.serving import (AsyncDispatchEngine, MuseServer,
                                     ServerConfig, TieringConfig)
    from repro_torch.serving.types import ScoringRequest

    rng = np.random.default_rng(23)
    w = rng.normal(0, 1, (3, 8)).astype(np.float32)
    # row by row on the host (a row's score whatever the window's size)
    factories = {f"m{i}": (lambda i=i: lambda x: 1.0 / (1.0 + np.exp(
        -(np.asarray(x, np.float32) * w[i]).sum(axis=1)))) for i in range(3)}
    n_t = 24
    rules = tuple(ScoringRule(Condition(tenants=(f"t{i}",)), f"p{i}")
                  for i in range(n_t))
    tables = [np.sort(rng.uniform(0, 1, 128)).astype(np.float32)
              for _ in range(n_t)]

    def server(**config):
        s = MuseServer(RoutingTable(rules, version="v1"),
                       ServerConfig(**config), device=dev)
        for i in range(n_t):
            s.deploy(PredictorSpec(f"p{i}", ("m0", "m1", "m2"),
                                   (0.2, 0.3, 0.1), (1.0, 1.0, 1.0),
                                   QuantileMap(torch.tensor(tables[i]),
                                               torch.linspace(0, 1, 128))),
                     factories)
        return s

    reqs = [ScoringRequest(Intent(tenant=f"t{rng.integers(0, n_t)}"),
                           rng.normal(0, 1, 8).astype(np.float32),
                           request_id=i) for i in range(2048)]
    dense = server()
    want = {r.request_id: r.score for r in dense.score_batch(reqs)}
    tiered = server(track_device=True, tiering=TieringConfig(
        hot_capacity=6, victim_capacity=5))
    engine = AsyncDispatchEngine(tiered, max_batch=256, max_wait_ms=1e9)
    engine.submit_many(reqs[:256])
    engine.drain(timeout=60)
    tiered.rebalance_tiers()
    engine.submit_many(reqs[256:])
    out = engine.drain(timeout=60)
    engine.close()
    assert not engine.errors and not engine.prefetch_errors
    assert len(out) == 2048 - 256
    for r in out:
        assert r.score == want[r.request_id], r.request_id
    assert tiered.tier_metrics()["prefetched_rows"] > 0
    tracked = sum(e.count for e in tiered.estimator_streams().values())
    assert tracked == 2048


# ------------------------------------- sharded and tiered-over-sharded, card
def _sharded_stores(dev, rows, s, **config):
    """(pure-sharded bank + dispatcher, composed store) over ``rows``."""
    from repro_torch.core.transforms import ShardedTransformBank, TransformBank
    from repro_torch.launch.mesh import make_tenant_mesh
    from repro_torch.serving import ShardedBankDispatcher
    from repro_torch.serving.tiering import (HostBankStore,
                                             ShardedTieredBankStore,
                                             TieringConfig)

    bank = TransformBank(*(torch.tensor(r, device=dev) for r in rows))
    disp = ShardedBankDispatcher(make_tenant_mesh(s, dev))
    composed = ShardedTieredBankStore(
        HostBankStore(*rows), s, TieringConfig(**{
            "hot_capacity": 6, "victim_capacity": 4, **config}),
        dispatcher=disp)
    return ShardedTransformBank.from_dense(bank, s), disp, composed


@pytest.mark.parametrize("s", [1, 2, 4, 8])
def test_dense_sharded_and_composed_are_bitwise_equal(dev, s):
    """Dense == sharded == tiered-over-sharded on the card, bit for bit,
    cold (multi-pass), after a rebalance and after a publish, over an
    assignment with an empty shard too; one banked launch a pass."""
    from repro_torch.core.transforms import QuantileMap, ShardedTransformBank

    rng = np.random.default_rng(30 + s)
    t = 300
    rows = _tier_rows(rng, t)
    sbank, disp, composed = _sharded_stores(dev, rows, s)
    raws = rng.uniform(0, 1, (2048, 4)).astype(np.float32)
    tid = rng.integers(0, t, 2048)
    want = _dense_on(dev, rows, raws, tid)
    before = ops.LAUNCHES["score_pipeline_banked"]
    assert np.array_equal(disp(raws, tid, sbank), want)
    assert ops.LAUNCHES["score_pipeline_banked"] == before + 1
    if s > 1:
        empty = ShardedTransformBank.from_dense(
            sbank.to_dense(), s, shard_of=rng.integers(0, s - 1, t))
        assert empty.row_counts[-1] == 0
        assert np.array_equal(disp(raws, tid, empty), want)
    before = ops.LAUNCHES["score_pipeline_banked"]
    got, _ = composed.dispatch(raws, tid)
    m = composed.metrics
    assert ops.LAUNCHES["score_pipeline_banked"] == \
        before + m["dispatches"] + m["extra_passes"]
    assert m["extra_passes"] > 0 and np.array_equal(got, want)
    composed.rebalance()
    assert np.array_equal(composed.dispatch(raws, tid)[0], want)
    src = np.sort(rng.uniform(0, 1, 256)).astype(np.float32)
    qm = QuantileMap(torch.tensor(src), torch.tensor(src ** 2))
    updates = {int(r): qm for r in rng.choice(t, 5, replace=False)}
    assert composed.apply_updates(updates) == 1
    sbank = sbank.with_rows(updates)
    host = composed.dense_bank(1, dev)
    want = ops.score_pipeline_banked(
        torch.tensor(raws, device=dev),
        torch.tensor(tid.astype(np.int32), device=dev), host.betas,
        host.weights, host.src_quantiles, host.ref_quantiles).cpu().numpy()
    got, gen = composed.dispatch(raws, tid)
    assert gen == 1 and np.array_equal(got, want)
    assert np.array_equal(disp(raws, tid, sbank), want)


@pytest.mark.parametrize("overlap", [True, False])
def test_composed_store_under_concurrent_prefetch(dev, overlap):
    """The composed store on the card while a thread prefetches per shard
    (side-stream views behind their events): every dispatch bitwise the
    dense bank, no deadlock between per-shard and all-shard locks."""
    import threading

    rng = np.random.default_rng(40)
    t = 4000
    rows = _tier_rows(rng, t)
    _, _, store = _sharded_stores(dev, rows, 4, hot_capacity=32,
                                  victim_capacity=16, overlap_staging=overlap)
    for st in store.shards:
        st.tracker.record(np.arange(32))
    store.rebalance()
    churn = [rng.integers(0, t, 32) for _ in range(64)]
    stop = threading.Event()

    def churner():
        i = 0
        while not stop.is_set():
            store.prefetch(churn[i % len(churn)])
            i += 1

    th = threading.Thread(target=churner, daemon=True)
    th.start()
    try:
        for w in range(40):
            hot = store.hot_rows()
            mix = np.where(rng.random(512) < 0.9, rng.choice(hot, 512),
                           rng.integers(0, t, 512))
            raws = rng.uniform(0, 1, (512, 4)).astype(np.float32)
            got, _ = store.dispatch(raws, mix)
            assert np.array_equal(got, _dense_on(dev, rows, raws, mix)), w
    finally:
        stop.set()
        th.join(timeout=60)
    assert not th.is_alive()
    assert store.metrics["prefetched_rows"] > 0
