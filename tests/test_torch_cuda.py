"""The port's hand-written CUDA kernels against their plain versions, on the
card.  Needs an NVIDIA card and nvcc; skips without them.  This file imports
neither JAX nor the reference package, so it runs where only PyTorch is
installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

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
