"""The decode of a sharded model (``models/attention.py::_decode``:
flash-decoding over the cache's sequence on "model") on four gloo ranks
against the reference's ``Model.prefill`` and ``decode_step`` on one
device, for the qwen3, deepseek-coder and qwen2-vl smoke configs
(``tests/torch_ranks.py``) on the meshes (1, 4), (2, 2), (4, 1) and
("pod", "data", "model") = (2, 1, 2).

Each case prefills the 4 x 8 prompt into a cache of its capacity, then
decodes steps at positions 8, 9, ... that cross the boundaries of the
ranks' blocks of the cache:

* capacity 12: the sequence on "model" at every mesh (3, 6 or 12 slots a
  rank);
* capacity 10 (qwen3): it does not divide over 4 ranks, so the cache
  stays whole on each (``cache_pspec``'s fallback) and each rank attends
  over its share of the slots;
* sliding windows of 8 and 6 (qwen3, capacity 16): the ring, with steps
  past the window (the window of 6 is whole on each of 4 ranks).

Every step's logits (a rank's rows, its block of the vocabulary) and risk
within rtol = atol = 2e-5 of the reference's; each rank's block of the
final cache equal, within the same tolerance, to its slice of the
reference's cache; and each step's tally equal to the hand count: the
embedding's all-reduce, and a layer's gather of the token's q, k and v
columns, the combine's two all-reduces (the largest logit, then the
weighted values beside the sum of exponentials) and the row-parallel wo
and down projections' all-reduces.
"""
import dataclasses

import numpy as np
import pytest
import torch

import torch_ranks as tr
from repro_torch.configs import get_smoke_config
from repro_torch.launch import collectives as coll
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.dryrun import _logits_pspec
from repro_torch.launch.shardings import (batch_pspec, cache_pspecs,
                                          local_shard)
from repro_torch.models import Model, parallel
from repro_torch.models.attention import KVCache

TOL = dict(rtol=2e-5, atol=2e-5)       # the reference's f32 kernel rule
ARCHS = ("qwen3-8b", "deepseek-coder-33b", "qwen2-vl-7b")

# name -> (arch, sliding window, cache capacity, decode steps)
CASES = {"qwen3-8b": ("qwen3-8b", 0, 12, 4),
         "deepseek-coder-33b": ("deepseek-coder-33b", 0, 12, 4),
         "qwen2-vl-7b": ("qwen2-vl-7b", 0, 12, 4),
         "qwen3-8b/cap10": ("qwen3-8b", 0, 10, 2),
         "qwen3-8b/window8": ("qwen3-8b", 8, 16, 6),
         "qwen3-8b/window6": ("qwen3-8b", 6, 16, 5)}

REFERENCE = r"""
import dataclasses
CASES, T = %(CASES)r, %(T)d
for name, (arch, window, cap, steps) in CASES.items():
    cfg = get_smoke_config(arch)
    if window:
        cfg = dataclasses.replace(cfg, sliding_window=window)
    model = Model(cfg)
    params = jax.tree.map(jnp.asarray, trees[arch])
    key = "embeds" if cfg.embeds_input else "tokens"
    _, cache = jax.jit(lambda p, x: model.prefill(
        p, **{key: x}, cache_capacity=cap, compute_dtype=jnp.float32))(
            params, jnp.asarray(inp[key]))
    step = jax.jit(lambda p, c, x, pos: model.decode_step(
        p, c, **{key: x}, pos=pos, compute_dtype=jnp.float32))
    for s in range(steps):
        xs = jnp.asarray(inp["decode_" + key][:, s:s + 1])
        o = step(params, cache, xs, T + s)
        cache = o.cache
        out[f"{name}/{s}/logits"], out[f"{name}/{s}/risk"] = o.logits, \
            o.risk_score
    for i, c in enumerate(cache):
        out[f"{name}/cache/{i}/k"], out[f"{name}/cache/{i}/v"] = c.k, c.v
""" % dict(CASES=CASES, T=tr.T)

PORT = r"""
import dataclasses
CASES, T = %(CASES)r, %(T)d
for mname, (axes, shape) in meshes.items():
    mesh = mesh_lib.init_mesh(mesh_lib.Mesh(tuple(axes), tuple(shape)),
                              device="cpu")
    for name, (arch, window, cap, steps) in CASES.items():
        cfg = get_smoke_config(arch)
        if window:
            cfg = dataclasses.replace(cfg, sliding_window=window)
        model = convert.model_from_numpy(cfg, trees[arch], device="cpu",
                                         mesh=mesh)
        key = "embeds" if cfg.embeds_input else "tokens"
        tag = f"{mname}/{name}"
        _, cache = model.prefill(**{key: rows(inp[key], mesh)},
                                 cache_capacity=cap,
                                 compute_dtype=torch.float32)
        xs = rows(inp["decode_" + key], mesh)
        for s in range(steps):
            with coll.tally() as t:
                o = model.decode_step(cache, **{key: xs[:, s:s + 1]},
                                      pos=T + s, cache_capacity=cap,
                                      compute_dtype=torch.float32)
            out[f"{tag}/{s}/logits"] = o.logits.numpy()
            out[f"{tag}/{s}/risk"] = o.risk_score.numpy()
            out[f"{tag}/{s}/tally"] = tally_blob(t)
        for i, c in enumerate(cache):
            out[f"{tag}/cache/{i}/k"] = c.k.numpy()
            out[f"{tag}/cache/{i}/v"] = c.v.numpy()
""" % dict(CASES=CASES, T=tr.T)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return tr.run(tmp_path_factory.mktemp("decode"), REFERENCE, PORT,
                  archs=ARCHS)


CELLS = [(mesh, case) for mesh in tr.MESHES for case in CASES]


def _cfg(case: str):
    arch, window, _, _ = CASES[case]
    cfg = get_smoke_config(arch)
    return dataclasses.replace(cfg, sliding_window=window) if window \
        else cfg


def _block(ref, spec, mesh, rank):
    return local_shard(torch.tensor(ref), spec, tr.shape_mesh(mesh),
                       tr.coords(mesh, rank)).numpy()


@pytest.mark.parametrize("mesh,case", CELLS)
def test_decode_steps_match_reference(runs, mesh, case):
    cfg, steps = _cfg(case), CASES[case][3]
    ref = runs["ref"]
    m = tr.shape_mesh(mesh)
    for rank, port in enumerate(runs["port"]):
        for s in range(steps):
            got = port[f"{mesh}/{case}/{s}/logits"]
            want = _block(ref[f"{case}/{s}/logits"],
                          _logits_pspec(m, tr.B, cfg.vocab_size, 2), mesh,
                          rank)
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, **TOL)
            np.testing.assert_allclose(
                port[f"{mesh}/{case}/{s}/risk"],
                _block(ref[f"{case}/{s}/risk"], batch_pspec(tr.B, m, 0),
                       mesh, rank), **TOL)


@pytest.mark.parametrize("mesh,case", CELLS)
def test_rank_cache_is_its_slice_of_the_reference(runs, mesh, case):
    """After the last step each rank's block of every layer's cache is
    its slice of the reference's cache under ``cache_pspec``: the token
    of each step was written by the rank that holds its slot (every rank
    where the cache is whole), the ring's slots modulo the window."""
    cfg = _cfg(case)
    ref = runs["ref"]
    m = tr.shape_mesh(mesh)
    whole = [KVCache(*(torch.tensor(ref[f"{case}/cache/{i}/{f}"])
                       for f in "kv"))
             for i in range(len(cfg.layer_pattern))]
    specs = cache_pspecs(whole, tr.B, m)
    for rank, port in enumerate(runs["port"]):
        for i, (c, s) in enumerate(zip(whole, specs)):
            for f, leaf, spec in zip("kv", c, s):
                got = port[f"{mesh}/{case}/cache/{i}/{f}"]
                want = _block(leaf.numpy(), spec, mesh, rank)
                assert got.shape == want.shape, (f, got.shape, want.shape)
                np.testing.assert_allclose(got, want, **TOL)
    cap = whole[0].k.shape[2]
    assert specs[0].k[2] == ("model" if cap % m.shape["model"] == 0
                             else None)


def schedule(case: str, mesh: str) -> tuple[dict, dict]:
    """(bytes, counts) by kind of one rank's float32 decode step, from the
    config alone."""
    cfg = _cfg(case)
    axes, shape = tr.MESHES[mesh]
    m = dict(zip(axes, shape))["model"]
    bl = tr.B // (int(np.prod(shape)) // m)
    d, hd, hq, hkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    layers = cfg.n_layers
    embed = 0 if cfg.embeds_input else 1
    combine = bl * hq * 4 + bl * hq * (hd + 1) * 4
    return ({"all-reduce": embed * bl * d * 4
             + layers * (2 * bl * d * 4 + combine),
             "all-gather": layers * bl * (hq + 2 * hkv) * hd * 4},
            {"all-reduce": embed + 4 * layers, "all-gather": layers})


@pytest.mark.parametrize("mesh,case", CELLS)
def test_decode_tally_is_the_schedule(runs, mesh, case):
    want = schedule(case, mesh)
    for port in runs["port"]:
        for s in range(CASES[case][3]):
            got = tr.tally(port[f"{mesh}/{case}/{s}/tally"])
            assert got[0] == want[0] and got[1] == want[1], (s, got, want)


# ---------------------------------------------------------------------------
# in process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity,m", [(12, 4), (10, 4), (8, 2), (7, 3),
                                        (5, 1), (3, 4)])
def test_cache_plan_attends_every_slot_once(capacity, m):
    """Over the ranks of "model" the attended slots tile the capacity
    once, each inside the slots the rank holds; the held slots are the
    rank's block where the capacity divides, else the whole cache (a
    rank may attend over none, and contributes nothing)."""
    seen = []
    for r in range(m):
        plan = parallel.cache_plan(capacity, m, r)
        (h_lo, h_n), (a_lo, a_n) = plan.held, plan.attended
        assert h_lo <= a_lo and a_lo + a_n <= h_lo + h_n
        assert (h_lo, h_n) == ((r * capacity // m, capacity // m)
                               if capacity % m == 0 else (0, capacity))
        seen += range(a_lo, a_lo + a_n)
    assert seen == list(range(capacity))


@pytest.fixture
def world_of_one(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield mesh_lib.init_mesh(mesh_lib.make_host_mesh(), device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("window", [0, 6])
def test_one_rank_decode_is_the_plain_decode(world_of_one, window):
    """At one rank the placed decode is the whole model's to the last
    bit (one flash-decoding for both: every collective over the rank of
    one is a copy), logits, risk and every cache leaf, while every
    collective is issued."""
    cfg = get_smoke_config("qwen3-8b")
    cfg = dataclasses.replace(cfg, sliding_window=window)
    whole = Model(cfg, device="cpu", seed=5)
    rank = parallel.parallelize(Model(cfg, device="cpu", seed=5),
                                world_of_one)
    g = torch.Generator().manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (2, 8), generator=g)
    (_, wc), (_, rc) = (mm.prefill(prompt, cache_capacity=12,
                                   compute_dtype=torch.float32)
                        for mm in (whole, rank))
    for pos in range(8, 12):
        tok = torch.randint(0, cfg.vocab_size, (2, 1), generator=g)
        want = whole.decode_step(wc, tok, pos=pos,
                                 compute_dtype=torch.float32)
        with coll.tally() as t:
            got = rank.decode_step(rc, tok, pos=pos,
                                   compute_dtype=torch.float32)
        assert torch.equal(got.logits, want.logits)
        assert torch.equal(got.risk_score, want.risk_score)
        assert t.count_by_kind == {"all-reduce": 1 + 4 * cfg.n_layers,
                                   "all-gather": cfg.n_layers}
    assert all(torch.equal(x, y) for a, b in zip(rc, wc)
               for x, y in zip(a, b))


def test_several_ranks_need_the_capacity():
    """Over several ranks of "model" the rank's block does not say the
    cache's capacity (3 slots may be a quarter of 12, or a whole cache of
    3): the decode refuses to guess."""
    cfg = get_smoke_config("qwen3-8b")
    mesh = mesh_lib.Mesh(("data", "model"), (1, 4))
    model = parallel.parallelize(Model(cfg, device="meta", seed=None), mesh)
    shape = (cfg.n_groups, tr.B, 3, cfg.n_kv_heads, cfg.head_dim)
    cache = [KVCache(torch.empty(shape, device="meta"),
                     torch.empty(shape, device="meta"))]
    tokens = torch.zeros((tr.B, 1), dtype=torch.long, device="meta")
    with pytest.raises(ValueError, match="capacity"):
        model.decode_step(cache, tokens, pos=2, compute_dtype=torch.float32)
    out = model.decode_step(cache, tokens, pos=2, cache_capacity=12,
                            compute_dtype=torch.float32)
    assert out.logits.shape == (tr.B, cfg.vocab_size // 4)
