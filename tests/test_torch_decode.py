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


PLAN_INPUTS = [(64, torch.bfloat16), (128, torch.bfloat16),
               (16, torch.bfloat16), (64, torch.float32),
               (128, torch.float32), (80, torch.float32)]


@pytest.mark.parametrize("b,hkv,s", [(4, 2, 16_384), (4, 8, 2_064),
                                     (1, 1, 100), (3, 2, 777), (64, 8, 1),
                                     (1, 1, 1_000_000)])
def test_split_plan_covers_the_cache(b, hkv, s):
    """Every split starts inside the cache and together they cover it,
    about one wave of resident blocks."""
    for d, dtype in PLAN_INPUTS:
        splits, chunk = tda.plan_splits(b, hkv, s, d, dtype)
        resident = tda.resident_blocks(d, dtype)
        assert chunk % tda.CHUNK_STEP == 0
        assert (splits - 1) * chunk < s <= splits * chunk
        if b * hkv >= resident:
            assert splits == 1
        else:
            assert b * hkv * splits <= resident
            if s >= resident * tda.CHUNK_STEP:
                assert b * hkv * splits > resident * 3 // 4


# the two shapes the card times: bench_kernels' and qwen3-8b's decode
# (prompt 2,048 + 16 steps), every position valid
TIMED_SHAPES = {"bench": (4, 16_384, 8, 2, 64),
                "qwen3_8b": (4, 2_064, 32, 8, 128)}


def _timed(label, dtype, seed=0):
    """Inputs of a timed shape in ``dtype``, as float32 tensors holding
    those values, and the plan's (splits, chunk)."""
    b, s, hq, hkv, d = TIMED_SHAPES[label]
    q, k, v, _ = (torch.tensor(a).to(dtype).float()
                  for a in _inputs((b, s, hq, hkv, d, ()), seed))
    return q, k, v, tda.plan_splits(b, hkv, s, d, dtype)


def _without(q, k, v, drop):
    """The plain version in float32 with the positions ``drop`` left out
    of every row's cache."""
    keep = torch.ones(k.shape[1], dtype=torch.bool)
    keep[drop] = False
    n = int(keep.sum())
    return tref.decode_attention(q, k[:, keep], v[:, keep],
                                 torch.full((q.shape[0],), n,
                                            dtype=torch.int32))


def _full(q, k, v):
    return tref.decode_attention(q, k, v, torch.full(
        (q.shape[0],), k.shape[1], dtype=torch.int32))


def _excess(got, want, tol):
    return ((got - want).abs() - (tol + tol * want.abs())).max().item()


def _lost_split_float32(label):
    q, k, v, (splits, chunk) = _timed(label, torch.float32)
    assert splits > 1
    full = _full(q, k, v)
    lost = _without(q, k, v, slice(chunk, 2 * chunk))
    assert _excess(lost, full, 2e-5) > 100 * 2e-5
    return _excess(lost, full, 2e-2)


def test_a_lost_split_fails_the_float32_check_at_the_bench_shape():
    """Why the card's check runs float32 at the benchmark's shape: there a
    typical |o| is below the bf16 tolerance, so dropping one of the kernel's
    splits stays inside rtol = atol = 2e-2 but moves o far past 2e-5."""
    assert _lost_split_float32("bench") < 0


def test_a_lost_split_fails_the_float32_check_at_qwen3_decode():
    _lost_split_float32("qwen3_8b")


@pytest.mark.parametrize("label", sorted(TIMED_SHAPES))
def test_bf16_check_passes_rounding_and_fails_a_lost_split_or_group(label):
    """The bf16 kernel's check (``tda.bf16_excess``): its output against
    the plain version run in float32 on the same bf16 inputs, within bf16's
    rounding of o.  The plain version rounded to bf16 passes; dropping one
    split, or one lane group's keys of one split, fails."""
    b, s, hq, hkv, d = TIMED_SHAPES[label]
    q, k, v, (splits, chunk) = _timed(label, torch.bfloat16)
    want = _full(q, k, v)
    assert tda.bf16_excess(want.to(torch.bfloat16), want) <= 0
    lost = _without(q, k, v, slice(chunk, 2 * chunk)).to(torch.bfloat16)
    assert tda.bf16_excess(lost, want) > 0
    # group 0 of the block of split 1: its keys in every round
    groups, _ = _key_groups(d, torch.bfloat16, hq // hkv)
    drop = torch.arange(chunk, 2 * chunk, groups)
    lost = _without(q, k, v, drop).to(torch.bfloat16)
    assert tda.bf16_excess(lost, want) > 0


LOG2E = np.float32(1.4426950408889634)


# The split pass's partition, as csrc/decode_attention.cu lays it out.
def _lanes_per_key(d, itemsize):
    """CUDA cores: lanes that share one key row, its D * itemsize bytes in
    16-byte pieces rounded up to a power of two."""
    lanes = itemsize
    while lanes * 16 < d * itemsize:
        lanes *= 2
    return lanes


def _warps(d, dtype):
    return 8 if tda.uses_tensor_cores(d, dtype) else 4


def _key_groups(d, dtype, qpk):
    """(groups, keys) of a split-pass block: key u of group g of a round
    at base + u * groups + g.  Tensor cores: a warp, 16 keys a round; CUDA
    cores: a lane group, 4 keys a round (2 with 8 heads a pass)."""
    if tda.uses_tensor_cores(d, dtype):
        return _warps(d, dtype), 16
    keys = 4 if min(qpk, 8) <= 4 else 2
    return _warps(d, dtype) * 32 // _lanes_per_key(d, dtype.itemsize), keys


def _merge(m1, l1, a1, m2, l2, a2):
    """Two online-softmax states (base-2 logits) merged as the kernel
    merges them: the guarded max, then each state's weight."""
    m = torch.maximum(m1, m2)
    safe = torch.where(m == -np.inf, 0.0, m)
    x, y = torch.exp2(m1 - safe), torch.exp2(m2 - safe)
    return m, x * l1 + y * l2, x[..., None] * a1 + y[..., None] * a2


def _emulate_kernel(q, k, v, vlen):
    """The CUDA kernel's partition in float32 on the CPU: the plan's
    splits; in each, one online-softmax state per key group (a group of
    lanes on the CUDA cores, a warp on the tensor cores) over the keys the
    group takes, updated once a round of ``unroll`` keys with the TPU
    kernel's guards; the groups of a warp merged in butterfly order, the
    warps by their max, the splits by theirs.  Logits are in base 2, as
    the kernel's."""
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    qpk = hq // hkv
    splits, chunk = tda.plan_splits(b, hkv, s, d, q.dtype)
    n_groups, unroll = _key_groups(d, q.dtype, qpk)
    warps = _warps(d, q.dtype)
    per_warp = n_groups // warps
    step = n_groups * unroll
    rounds = -(-chunk // step)
    scale = np.float32(1 / np.sqrt(np.float32(d))) * LOG2E
    qf = q.float().reshape(b, hkv, qpk, d) * scale
    # position of group g's u-th key in round r of split sp: (sp, r, u, g)
    pos = (torch.arange(splits)[:, None, None, None] * chunk
           + torch.arange(rounds)[:, None, None] * step
           + torch.arange(unroll)[:, None] * n_groups
           + torch.arange(n_groups))
    length = vlen.long().clamp(0, s)
    stop = torch.minimum((torch.arange(splits) + 1) * chunk, length[:, None])
    valid = pos[None] < stop[:, :, None, None, None]
    idx = pos.clamp(max=s - 1)
    kk, vv = k.float()[:, idx], v.float()[:, idx]   # (b, sp, r, u, g, h, d)
    logits = torch.einsum("bhjd,bsrughd->bhjsrug", qf, kk)
    logits = logits.masked_fill(~valid[:, None, None], -np.inf)
    shape = (b, hkv, qpk, splits, n_groups)
    m = torch.full(shape, -np.inf)
    l = torch.zeros(shape)
    acc = torch.zeros(shape + (d,))
    for r in range(rounds):
        sr = logits[:, :, :, :, r]                       # (b, h, j, sp, u, g)
        m_new = torch.maximum(m, sr.amax(-2))
        safe = torch.where(m_new == -np.inf, 0.0, m_new)
        alpha = torch.where(m == -np.inf, 0.0, torch.exp2(m - safe))
        p = torch.exp2(sr - safe[:, :, :, :, None])
        l = alpha * l + p.sum(-2)
        acc = alpha[..., None] * acc + torch.einsum(
            "bhjsug,bsughd->bhjsgd", p, vv[:, :, r])
        m = m_new
    # the groups of a warp: butterfly over lanes L, 2L, ... apart
    m, l, acc = (x.unflatten(4, (warps, per_warp)) for x in (m, l, acc))
    bit = 1
    while bit < per_warp:
        other = torch.arange(per_warp) ^ bit
        m, l, acc = _merge(m, l, acc, m[..., other], l[..., other],
                           acc[..., other, :])
        bit *= 2
    m, l, acc = m[..., 0], l[..., 0], acc[..., 0, :]    # (b, h, j, sp, w)
    # the warps, through shared memory: their max, then weighted sums
    m_max = m.amax(-1)
    w = torch.exp2(m - torch.where(m_max == -np.inf, 0.0, m_max)[..., None])
    m, l, acc = m_max, (w * l).sum(-1), (w[..., None] * acc).sum(-2)
    # the combine (or, with one split, the block itself): M = max m, then
    # each split weighted by 2^(m - M)
    m_max = m.amax(-1)
    w = torch.exp2(m - torch.where(m_max == -np.inf, 0.0, m_max)[..., None])
    l, acc = (w * l).sum(-1), (w[..., None] * acc).sum(-2)
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, hq, d)


# (b, s, hq, hkv, d, valid lengths): the reference's cases, lengths of 0
# and past S, lengths ending inside a round's keys, and the partitions of
# more heads, other D and float32 widths
EMULATED = CASES + [
    (3, 40, 4, 2, 16, (0, 99, 40)),
    (1, 1000, 4, 2, 64, (333,)),         # ends at group 13 of a round
    (2, 900, 8, 2, 64, (900, 517)),      # several splits, one ragged
    (2, 300, 8, 8, 128, (300, 1)),
    (1, 500, 64, 1, 32, (471,)),         # 64 query heads: 8 (16) a pass
    (2, 333, 6, 2, 80, (333, 200)),      # D = 80: idle lanes
]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", EMULATED,
                         ids=lambda c: "-".join(map(str, c[:5])))
def test_kernel_partition_matches_jax_oracle(case, dtype):
    """The emulated partition (with the plan, lane groups and unroll of
    ``dtype``) on inputs of that dtype, in float32, against the JAX oracle
    in float32 on the same values within 2e-5; a row of length 0 is
    exactly 0."""
    q, k, v, vlen = _inputs(case, seed=3)
    td = DTYPES[dtype][1]
    q, k, v = (torch.tensor(a).to(td) for a in (q, k, v))
    got = _emulate_kernel(q, k, v, torch.tensor(vlen))
    want = _f32(jref.decode_attention(
        *(jnp.asarray(x.float().numpy()) for x in (q, k, v)),
        jnp.asarray(vlen)))
    empty = vlen == 0
    assert not got[torch.tensor(empty)].any()
    np.testing.assert_allclose(got.numpy()[~empty], want[~empty],
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("label", sorted(TIMED_SHAPES))
def test_kernel_partition_at_the_timed_shapes(label):
    """The emulated partition in float32 at a timed shape, every position
    valid, against the plain version within 2e-5."""
    q, k, v, _ = _timed(label, torch.float32, seed=4)
    vlen = torch.full((q.shape[0],), k.shape[1], dtype=torch.int32)
    torch.testing.assert_close(_emulate_kernel(q, k, v, vlen),
                               _full(q, k, v), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("bad", ["cpu", "d24", "d144", "mixed", "int",
                                 "heads", "group", "vlen_dtype", "vlen_shape",
                                 "stride", "rank", "misaligned"])
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
    elif bad == "misaligned":   # rows 8 bytes off a 16-byte boundary
        k = torch.cat([k[..., :2], k], -1)[..., 2:]
    match = {"cpu": "CUDA tensors", "d24": "head dim", "d144": "head dim",
             "mixed": "is torch.bfloat16", "int": "dtype", "heads": "heads",
             "group": "at most 64", "vlen_dtype": "int32",
             "vlen_shape": "int32", "stride": "contiguous",
             "rank": "rank-3", "misaligned": "16-byte"}[bad]
    with pytest.raises(ValueError, match=match):
        tda.decode_attention(q, k, v, vlen)
