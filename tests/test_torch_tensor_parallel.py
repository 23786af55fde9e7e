"""The tensor-parallel dense model (``models/parallel.py`` and the column /
row layers, the head-aligned attention, the vocab-parallel embedding and
lm head) on four gloo ranks against the reference's ``Model.forward`` and
``prefill`` on one device, for the qwen3, deepseek-coder, hubert and
qwen2-vl smoke configs (``tests/torch_ranks.py``) on the meshes (1, 4),
(2, 2), (4, 1) and ("pod", "data", "model") = (2, 1, 2).

* Each rank's logits (its rows, its block of the vocabulary), risk score
  and block of the prefill cache (``cache_pspec``'s layout: the sequence
  on "model") within rtol = atol = 2e-5 of the reference's, and the cache
  gathered whole.
* The tally of each rank's forward and prefill equals the count the
  Megatron schedule implies, worked out here: one all-reduce of the
  embedding, two a layer (wo, down), the gathers of q and of k / v over
  "model" where a rank's columns are not the whole heads it attends with,
  and in the prefill the all-to-all of k / v to the sequence layout where
  they are.  The reference's HLO tally of the same forward compiled under
  GSPMD on each mesh is recorded beside it (``record_property``), not
  asserted: its schedule is GSPMD's (ROADMAP Queue 3).
* In process: the head plans of the full configs at 16 ranks, and at one
  gloo rank a sharded model's forward, prefill and train step bitwise the
  unsharded model's.
"""
import json

import numpy as np
import pytest
import torch

import torch_ranks as tr
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import collectives as coll
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.dryrun import _logits_pspec
from repro_torch.launch.shardings import (batch_pspec, cache_pspecs,
                                          local_shard)
from repro_torch.models import Model, parallel

TOL = dict(rtol=2e-5, atol=2e-5)       # the reference's f32 kernel rule

REFERENCE = r"""
CAP = %(CAP)d
for arch, tree in trees.items():
    cfg = get_smoke_config(arch)
    model = Model(cfg)
    params = jax.tree.map(jnp.asarray, tree)
    key = "embeds" if cfg.embeds_input else "tokens"
    x = jnp.asarray(inp[key])
    o = model.forward(params, **{key: x}, compute_dtype=jnp.float32)
    out[f"{arch}/fwd/logits"], out[f"{arch}/fwd/risk"] = o.logits, \
        o.risk_score
    if cfg.has_decode:
        o, cache = model.prefill(params, **{key: x}, cache_capacity=CAP,
                                 compute_dtype=jnp.float32)
        out[f"{arch}/prefill/logits"] = o.logits
        out[f"{arch}/prefill/risk"] = o.risk_score
        for i, c in enumerate(cache):
            out[f"{arch}/prefill/cache/{i}/k"] = c.k
            out[f"{arch}/prefill/cache/{i}/v"] = c.v
    for name, (axes, shape) in meshes.items():
        mesh = jax_compat.make_mesh(tuple(shape), tuple(axes))
        with mesh, jax_compat.set_mesh(mesh):
            psh = shardings.params_shardings(params, mesh)
            xsh = NamedSharding(mesh, shardings.batch_pspec(
                x.shape[0], mesh, x.ndim - 1))
            compiled = jax.jit(
                lambda p, xx: model.forward(
                    p, **{key: xx}, compute_dtype=jnp.float32).logits,
                in_shardings=(psh, xsh)).lower(params, x).compile()
        out[f"{arch}/{name}/hlo"] = tally_blob(compiled)
""" % dict(CAP=tr.CAP)

PORT = r"""
CAP = %(CAP)d
for name, (axes, shape) in meshes.items():
    mesh = mesh_lib.init_mesh(mesh_lib.Mesh(tuple(axes), tuple(shape)),
                              device="cpu")
    for arch, tree in trees.items():
        cfg = get_smoke_config(arch)
        model = convert.model_from_numpy(cfg, tree, device="cpu", mesh=mesh)
        key = "embeds" if cfg.embeds_input else "tokens"
        x = rows(inp[key], mesh)
        tag = f"{name}/{arch}"
        with torch.no_grad(), coll.tally() as t:
            o = model(**{key: x}, compute_dtype=torch.float32)
        out[f"{tag}/fwd/logits"] = o.logits.numpy()
        out[f"{tag}/fwd/risk"] = o.risk_score.numpy()
        out[f"{tag}/fwd/tally"] = tally_blob(t)
        out[f"{tag}/param_bytes"] = np.array(sum(
            p.numel() * p.element_size() for p in model.parameters()))
        if cfg.has_decode:
            with coll.tally() as t:
                o, cache = model.prefill(**{key: x}, cache_capacity=CAP,
                                         compute_dtype=torch.float32)
            out[f"{tag}/prefill/logits"] = o.logits.numpy()
            out[f"{tag}/prefill/risk"] = o.risk_score.numpy()
            out[f"{tag}/prefill/tally"] = tally_blob(t)
            from repro_torch.launch.shardings import cache_pspecs
            whole = [type(c)(*(torch.empty(
                (a.shape[0], inp[key].shape[0]) + (CAP,) + a.shape[3:])
                for a in c)) for c in cache]
            specs = cache_pspecs(whole, inp[key].shape[0], mesh)
            for i, (c, s) in enumerate(zip(cache, specs)):
                for f in ("k", "v"):
                    block = getattr(c, f)
                    out[f"{tag}/prefill/cache/{i}/{f}"] = block.numpy()
                    out[f"{tag}/prefill/gathered/{i}/{f}"] = \
                        parallel.gather_full(block, getattr(s, f),
                                             mesh).numpy()
""" % dict(CAP=tr.CAP)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return tr.run(tmp_path_factory.mktemp("tp"), REFERENCE, PORT)


CELLS = [(mesh, arch) for mesh in tr.MESHES for arch in tr.ARCHS]


def _block(ref, spec, mesh, rank):
    return local_shard(torch.tensor(ref), spec, tr.shape_mesh(mesh),
                       tr.coords(mesh, rank)).numpy()


@pytest.mark.parametrize("mesh,arch", CELLS)
def test_forward_matches_reference(runs, mesh, arch):
    cfg = get_smoke_config(arch)
    ref = runs["ref"]
    m = tr.shape_mesh(mesh)
    for rank, port in enumerate(runs["port"]):
        got = port[f"{mesh}/{arch}/fwd/logits"]
        want = _block(ref[f"{arch}/fwd/logits"],
                      _logits_pspec(m, tr.B, cfg.vocab_size, 3), mesh, rank)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(
            port[f"{mesh}/{arch}/fwd/risk"],
            _block(ref[f"{arch}/fwd/risk"], batch_pspec(tr.B, m, 0), mesh,
                   rank), **TOL)


PREFILL = [(mesh, arch) for mesh, arch in CELLS
           if get_smoke_config(arch).has_decode]


@pytest.mark.parametrize("mesh,arch", PREFILL)
def test_prefill_and_its_cache_match_reference(runs, mesh, arch):
    cfg = get_smoke_config(arch)
    ref = runs["ref"]
    m = tr.shape_mesh(mesh)
    whole = [tuple(ref[f"{arch}/prefill/cache/{i}/{f}"] for f in "kv")
             for i in range(len(cfg.layer_pattern))]
    from repro_torch.models.attention import KVCache
    specs = cache_pspecs([KVCache(*(torch.empty(a.shape) for a in c))
                          for c in whole], tr.B, m)
    for rank, port in enumerate(runs["port"]):
        np.testing.assert_allclose(
            port[f"{mesh}/{arch}/prefill/logits"],
            _block(ref[f"{arch}/prefill/logits"],
                   _logits_pspec(m, tr.B, cfg.vocab_size, 3), mesh, rank),
            **TOL)
        np.testing.assert_allclose(
            port[f"{mesh}/{arch}/prefill/risk"],
            _block(ref[f"{arch}/prefill/risk"], batch_pspec(tr.B, m, 0),
                   mesh, rank), **TOL)
        for i, (c, s) in enumerate(zip(whole, specs)):
            for f, leaf, spec in zip("kv", c, s):
                got = port[f"{mesh}/{arch}/prefill/cache/{i}/{f}"]
                want = _block(leaf, spec, mesh, rank)
                assert got.shape == want.shape, (f, got.shape, want.shape)
                np.testing.assert_allclose(got, want, **TOL)
                np.testing.assert_allclose(
                    port[f"{mesh}/{arch}/prefill/gathered/{i}/{f}"], leaf,
                    **TOL)
        # the sequence is on "model" wherever the capacity divides
        assert s.k[2] == ("model" if tr.CAP % m.shape["model"] == 0
                          else None)


# (gather q, gather k / v) of each smoke config at 2 and 4 ranks of
# "model": qwen3's and qwen2-vl's keys are half a head a rank at 4 (2 kv
# heads of 64 over 4), deepseek's 7 q heads of 32 are 3.5 and 1.75 heads
# a rank and its one kv head 16 and 8 columns; hubert is aligned
GATHERS = {("qwen3-8b", 4): (False, True), ("qwen3-8b", 2): (False, False),
           ("qwen2-vl-7b", 4): (False, True),
           ("qwen2-vl-7b", 2): (False, False),
           ("deepseek-coder-33b", 4): (True, True),
           ("deepseek-coder-33b", 2): (True, True),
           ("hubert-xlarge", 4): (False, False),
           ("hubert-xlarge", 2): (False, False)}


def schedule(arch: str, mesh: str, prefill: bool) -> tuple[dict, dict]:
    """(bytes, counts) by kind of one rank's float32 forward (or
    prefill) under the Megatron schedule, from the config alone."""
    cfg = get_smoke_config(arch)
    axes, shape = tr.MESHES[mesh]
    m = dict(zip(axes, shape))["model"]
    n_data = int(np.prod(shape)) // m
    bl = tr.B // n_data
    d, hd, t = cfg.d_model, cfg.head_dim, tr.T
    gq, gkv = GATHERS.get((arch, m), (False, False))
    act = bl * t * d * 4
    nbytes, counts = {}, {}

    def add(kind, n, each):
        if n:
            nbytes[kind] = nbytes.get(kind, 0) + n * each
            counts[kind] = counts.get(kind, 0) + n

    layers = cfg.n_layers
    add("all-reduce", (0 if cfg.embeds_input else 1) + 2 * layers, act)
    add("all-gather", layers * gq, bl * t * cfg.n_heads * hd * 4)
    add("all-gather", 2 * layers * gkv, bl * t * cfg.n_kv_heads * hd * 4)
    if prefill and not gkv and m > 1:
        # k and v from the rank's whole heads to its block of the sequence
        add("all-to-all", 2 * layers,
            bl * tr.CAP * cfg.n_kv_heads * hd * 4 // m)
    return nbytes, counts


@pytest.mark.parametrize("mesh,arch", CELLS)
def test_tally_is_the_schedule(runs, mesh, arch, record_property):
    for what in ("fwd", "prefill"):
        if what == "prefill" and not get_smoke_config(arch).has_decode:
            continue
        want = schedule(arch, mesh, what == "prefill")
        for port in runs["port"]:
            got = tr.tally(port[f"{mesh}/{arch}/{what}/tally"])
            assert got[0] == want[0] and got[1] == want[1], (what, got, want)
    hlo_bytes, hlo_counts = tr.tally(runs["ref"][f"{arch}/{mesh}/hlo"])
    record_property("reference_hlo_collectives",
                    json.dumps({"bytes": hlo_bytes, "counts": hlo_counts}))
    assert all(v >= 0 for v in hlo_bytes.values())


@pytest.mark.parametrize("mesh,arch", CELLS)
def test_rank_holds_its_shard_of_the_parameters(runs, mesh, arch):
    """Each rank's parameter bytes are the rules' per-device bytes of the
    whole model (no FSDP), and the ranks of "model" hold less than the
    whole model as soon as there are several."""
    from repro_torch.launch.shardings import param_pspecs, per_device_bytes

    cfg = get_smoke_config(arch)
    whole = Model(cfg, device="meta", seed=None)
    params = dict(whole.named_parameters())
    m = tr.shape_mesh(mesh)
    want = per_device_bytes(params, param_pspecs(cfg, whole, m), m)
    total = sum(p.numel() * 4 for p in params.values())
    for port in runs["port"]:
        assert int(port[f"{mesh}/{arch}/param_bytes"]) == want
    assert (want < total) == (m.shape["model"] > 1)


# ---------------------------------------------------------------------------
# in process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,m", [
    ("qwen3-8b", 16), ("llama3-405b", 16), ("deepseek-coder-33b", 16),
    ("internlm2-1.8b", 16), ("qwen2-vl-7b", 16), ("hubert-xlarge", 16),
    ("deepseek-coder-33b", 4), ("qwen3-8b", 1)])
def test_head_plans_cover_every_column_with_whole_heads(arch, m):
    """Every rank's q columns lie in the whole heads it attends with, the
    ranks' columns tile the heads, and each q head attends with its own
    kv head (GQA) on every rank."""
    cfg = get_config(arch)
    hd, qpk = cfg.head_dim, cfg.n_heads // cfg.n_kv_heads
    seen = []
    for r in range(m):
        plan = parallel.head_plan(cfg, m, r)
        (start, cols), (q_lo, nq) = plan.q_cols, plan.q_heads
        kv_lo, nk = plan.kv_heads
        assert q_lo * hd <= start and start + cols <= (q_lo + nq) * hd
        seen.append((start, cols))
        assert [kv_lo + i // (nq // nk) for i in range(nq)] == [
            (q_lo + i) // qpk for i in range(nq)]
        assert plan.gather_q == (cfg.n_heads % m != 0)
    assert [s for s, _ in seen] == [r * seen[0][1] for r in range(m)]
    assert sum(c for _, c in seen) == cfg.n_heads * hd


def test_head_plan_refuses_q_heads_split_unevenly_over_kv_heads():
    """9 q heads over 3 kv heads at 2 ranks: rank 0's 4.5 heads are 0-4,
    three of kv head 0 and two of kv head 1, which grouped attention
    cannot take; no shipped config has such a layout."""
    import dataclasses

    cfg = dataclasses.replace(get_smoke_config("deepseek-coder-33b"),
                              n_heads=9, n_kv_heads=3)
    with pytest.raises(ValueError, match="unevenly"):
        parallel.head_plan(cfg, 2, 0)
    for arch in tr.ARCHS:
        for m in (2, 4, 8, 16):
            full = get_config(arch)
            if full.n_kv_heads * full.head_dim % m == 0:
                for r in range(m):
                    parallel.head_plan(full, m, r)


@pytest.fixture
def world_of_one(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield mesh_lib.init_mesh(mesh_lib.make_host_mesh(), device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["qwen3-8b", "hubert-xlarge"])
def test_one_rank_is_bitwise_the_whole_model(world_of_one, arch):
    """At one rank every shard is the whole tensor (a view: no copy) and
    the sharded model's forward, prefill and train step are the unsharded
    model's to the last bit, as the card's tensor_parallel phase holds
    them over NCCL."""
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train import TrainState, make_train_step

    cfg = get_smoke_config(arch)
    whole = Model(cfg, device="cpu", seed=5)
    rank = Model(cfg, device="cpu", seed=5)
    before = {k: p.data_ptr() for k, p in rank.named_parameters()}
    parallel.parallelize(rank, world_of_one)
    assert {k: p.data_ptr() for k, p in rank.named_parameters()} == before
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 8), generator=g)
    key = tr.model_input(cfg)
    x = torch.randn(2, 8, cfg.d_model, generator=g) if key == "embeds" \
        else tokens
    with torch.no_grad(), coll.tally() as t:
        got = rank(**{key: x}, compute_dtype=torch.float32)
    want = whole(**{key: x}, compute_dtype=torch.float32)
    assert torch.equal(got.logits, want.logits)
    assert torch.equal(got.risk_score, want.risk_score)
    assert t.count_by_kind["all-reduce"] == 2 * cfg.n_layers + (
        key == "tokens")
    if cfg.has_decode:
        (go, gc), (wo, wc) = (m.prefill(**{key: x}, cache_capacity=8,
                                        compute_dtype=torch.float32)
                              for m in (rank, whole))
        assert torch.equal(go.logits, wo.logits)
        assert all(torch.equal(a, b) for c, d in zip(gc, wc)
                   for a, b in zip(c, d))
    opt = AdamW(learning_rate=1e-3)
    metrics = []
    for model in (rank, whole):
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        step = make_train_step(model, opt, compute_dtype=torch.float32)
        with mesh_lib.set_mesh(world_of_one):
            state, got = step(TrainState(params, opt.init(params)), tokens,
                              tokens.roll(1, 1))
        metrics.append([float(v) for v in got])
    assert metrics[0] == metrics[1]
    for (k, a), b in zip(rank.named_parameters(), whole.parameters()):
        assert torch.equal(a, b), k
