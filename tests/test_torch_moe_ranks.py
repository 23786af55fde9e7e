"""The einsum MoE under the production rules (``models/moe.py`` on a model
sharded by ``models/parallel.py``) on four gloo ranks against the
reference's ``Model`` on one device: the olmoe and llama4-maverick smoke
configs (``tests/torch_ranks.py``) on the meshes (1, 4), (2, 2), (4, 1)
and ("pod", "data", "model") = (2, 1, 2).

Cases: each config drop-free (its capacity factor E / k), each with a
test-local capacity factor of 0.5 that drops pairs, and olmoe with 6
experts, which do not divide over 4 ranks of "model" (the col / row
fallback: every expert on the rank's block of ``d_ff_expert``; at 2
ranks, 3 whole experts a rank).  The smoke batch (4 x 8 = 32 tokens, one
dispatch chunk) spans every data rank's rows, so a rank takes the global
chunk's capacity and offsets its slot counts by the data ranks before it.

* Forward, prefill and two decode steps: logits (a rank's rows, its block
  of the vocabulary), risk and aux within rtol = atol = 2e-5 of the
  reference's; the prefill's cache blocks too.
* One train step (remat, float32, AdamW): loss, ce, aux and grad norm
  within rtol 1e-5; the first moments (the gradients) within 2e-5 of
  each leaf's largest entry, the parameters too where |g| is clear of 0
  (``test_torch_train_ranks.py``'s rule).  The aux loss is the product
  of the global means (f and p all-reduced over the data axes), and p's
  gradient comes through that all-reduce and the data-parallel loss
  scale.
* A decode batch at the layer: 4 tokens, one chunk across every data
  rank, each rank's pairs' slots (and which drop) equal to the
  reference's own ``pos_in_expert`` (read by spying on its second
  ``jax.nn.one_hot``), its output rows within 2e-5.
* The tally of the forward, prefill, decode and train step equals the
  hand count.
* ``ep_sharding_constraint`` True is False's to the last bit in the port
  (the buffers live on their experts' ranks already) and within 2e-5 in
  the reference, compiled under GSPMD on the (2, 2) mesh.
"""
import dataclasses
import pickle

import numpy as np
import pytest
import torch

import torch_ranks as tr
from repro_torch.configs import get_smoke_config
from repro_torch.launch.dryrun import _logits_pspec
from repro_torch.launch.mesh import DATA_AXES
from repro_torch.launch.shardings import (batch_pspec, cache_pspecs,
                                          local_shard)
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import KVCache

TOL = dict(rtol=2e-5, atol=2e-5)
METRIC_RTOL = 1e-5
LEAF_TOL = 2e-5
LR = 1e-3
DECODE_STEPS = 2
OLMOE, LLAMA4 = tr.MOE_ARCHS
E6 = OLMOE + "/e6"

# name -> (weights, arch, MoE config changes)
CASES = {OLMOE: (OLMOE, OLMOE, {}),
         OLMOE + "/drops": (OLMOE, OLMOE, {"capacity_factor": 0.5}),
         LLAMA4: (LLAMA4, LLAMA4, {}),
         LLAMA4 + "/drops": (LLAMA4, LLAMA4, {"capacity_factor": 0.5}),
         E6: (E6, OLMOE, {"num_experts": 6, "capacity_factor": 1.0})}
EP_CASES = (OLMOE, OLMOE + "/drops")
WHOLE = OLMOE + "/drops"    # also given the whole batch on every rank
MOE_LAYER = {OLMOE: 0, LLAMA4: 1}       # the first MoE block of the stack

CASE_CFG = r"""
import dataclasses
CASES, T, CAP, STEPS, LR = %(CASES)r, %(T)d, %(CAP)d, %(STEPS)d, %(LR)r
MOE_LAYER = %(MOE_LAYER)r

def case_cfg(name):
    _, arch, change = CASES[name]
    cfg = get_smoke_config(arch)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            **change))
""" % dict(CASES=CASES, T=tr.T, CAP=tr.CAP, STEPS=DECODE_STEPS, LR=LR,
           MOE_LAYER=MOE_LAYER)

REFERENCE = CASE_CFG + r"""
from repro.models import moe as jmoe
from repro.training.optimizer import AdamW
from repro.training.train import TrainState, make_loss_fn, make_train_step
tokens, labels = jnp.asarray(inp["tokens"]), jnp.asarray(inp["labels"])
for name, (weights, arch, _) in CASES.items():
    cfg = case_cfg(name)
    model = Model(cfg)
    params = jax.tree.map(jnp.asarray, trees[weights])
    o = jax.jit(lambda p, x: model.forward(
        p, tokens=x, compute_dtype=jnp.float32))(params, tokens)
    out[f"{name}/fwd/logits"], out[f"{name}/fwd/risk"] = o.logits, \
        o.risk_score
    out[f"{name}/fwd/aux"] = o.moe_aux
    o, cache = jax.jit(lambda p, x: model.prefill(
        p, tokens=x, cache_capacity=CAP, compute_dtype=jnp.float32))(
            params, tokens)
    out[f"{name}/prefill/logits"] = o.logits
    out[f"{name}/prefill/aux"] = o.moe_aux
    for i, c in enumerate(cache):
        out[f"{name}/prefill/cache/{i}/k"] = c.k
        out[f"{name}/prefill/cache/{i}/v"] = c.v
    step = jax.jit(lambda p, c, x, pos: model.decode_step(
        p, c, tokens=x, pos=pos, compute_dtype=jnp.float32))
    for s in range(STEPS):
        o = step(params, cache,
                 jnp.asarray(inp["decode_tokens"][:, s:s + 1]), T + s)
        cache = o.cache
        out[f"{name}/{s}/logits"], out[f"{name}/{s}/risk"] = o.logits, \
            o.risk_score
    # the layer on a decode batch, eager, its slots read from its one_hot
    layer = jax.tree.map(lambda a: a[0],
                         params["stack"][MOE_LAYER[arch]]["ffn"])
    h = jnp.asarray(inp["decode_embeds"][:, :1, :cfg.d_model])
    calls, one_hot = [], jax.nn.one_hot

    def spy(x, *a, **k):
        calls.append(np.asarray(x))
        return one_hot(x, *a, **k)

    jax.nn.one_hot = spy
    try:
        y, _ = jmoe.moe_forward(layer, h, cfg.moe)
    finally:
        jax.nn.one_hot = one_hot
    idx, pos = calls[0], calls[1]
    out[f"{name}/layer/y"], out[f"{name}/layer/idx"] = y, idx
    out[f"{name}/layer/slot"] = np.take_along_axis(pos, idx[..., None],
                                                   -1)[..., 0]
    opt = AdamW(learning_rate=LR)
    loss_fn = make_loss_fn(model, remat=False, compute_dtype=jnp.float32)
    grads = jax.jit(jax.grad(lambda p: loss_fn(p, tokens, labels)[0]))(
        params)
    train = make_train_step(model, opt, remat=True,
                            compute_dtype=jnp.float32)
    new, metrics = jax.jit(train)(TrainState(params, opt.init(params)),
                                  tokens, labels)
    out[f"{name}/metrics"] = np.array([float(v) for v in metrics])
    for what, t in (("params", new.params), ("mu", new.opt.mu),
                    ("grads", grads)):
        for i, leaf in enumerate(jax.tree.leaves(t)):
            out[f"{name}/{what}/{i}"] = leaf
    if name in %(EP)r:
        axes, shape = meshes["2x2"]
        mesh = jax_compat.make_mesh(tuple(shape), tuple(axes))
        for flag in (False, True):
            m2 = Model(dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, ep_sharding_constraint=flag)))
            with mesh, jax_compat.set_mesh(mesh):
                psh = shardings.params_shardings(params, mesh)
                xsh = NamedSharding(mesh, shardings.batch_pspec(
                    tokens.shape[0], mesh, 1))
                o = jax.jit(lambda p, x: m2.forward(
                    p, tokens=x, compute_dtype=jnp.float32).logits,
                    in_shardings=(psh, xsh))(params, tokens)
            out[f"{name}/ep{int(flag)}/logits"] = o
""" % dict(EP=EP_CASES)

PORT = CASE_CFG + r"""
from repro_torch.models import moe as moe_mod
from repro_torch.training.optimizer import AdamW
from repro_torch.training.train import TrainState, make_train_step
positions = moe_mod.positions
for mname, (axes, shape) in meshes.items():
    mesh = mesh_lib.init_mesh(mesh_lib.Mesh(tuple(axes), tuple(shape)),
                              device="cpu")
    toks, labs = rows(inp["tokens"], mesh), rows(inp["labels"], mesh)
    for name, (weights, arch, _) in CASES.items():
        cfg = case_cfg(name)
        tag = f"{mname}/{name}"
        model = convert.model_from_numpy(cfg, trees[weights], device="cpu",
                                         mesh=mesh)
        with torch.no_grad(), coll.tally() as t:
            o = model(toks, compute_dtype=torch.float32)
        out[f"{tag}/fwd/logits"] = o.logits.numpy()
        out[f"{tag}/fwd/risk"] = o.risk_score.numpy()
        out[f"{tag}/fwd/aux"] = o.moe_aux.numpy()
        out[f"{tag}/fwd/tally"] = tally_blob(t)
        with coll.tally() as t:
            o, cache = model.prefill(toks, cache_capacity=CAP,
                                     compute_dtype=torch.float32)
        out[f"{tag}/prefill/logits"] = o.logits.numpy()
        out[f"{tag}/prefill/aux"] = o.moe_aux.numpy()
        out[f"{tag}/prefill/tally"] = tally_blob(t)
        for i, c in enumerate(cache):
            # copies: the decode steps below write into the cache
            out[f"{tag}/prefill/cache/{i}/k"] = c.k.numpy().copy()
            out[f"{tag}/prefill/cache/{i}/v"] = c.v.numpy().copy()
        xs = rows(inp["decode_tokens"], mesh)
        for s in range(STEPS):
            with coll.tally() as t:
                o = model.decode_step(cache, xs[:, s:s + 1], pos=T + s,
                                      cache_capacity=CAP,
                                      compute_dtype=torch.float32)
            out[f"{tag}/{s}/logits"] = o.logits.numpy()
            out[f"{tag}/{s}/risk"] = o.risk_score.numpy()
            out[f"{tag}/{s}/tally"] = tally_blob(t)
        seen = []

        def spy(*a, **k):
            seen.append(positions(*a, **k))
            return seen[-1]

        moe_mod.positions = spy
        try:
            with torch.no_grad():
                y, _ = moe_mod.moe_forward(
                    model.stack[MOE_LAYER[arch]].ffn,
                    rows(inp["decode_embeds"][:, :1, :cfg.d_model], mesh),
                    cfg.moe, with_aux=False)
        finally:
            moe_mod.positions = positions
        out[f"{tag}/layer/y"], out[f"{tag}/layer/pos"] = y.numpy(), \
            seen[0].numpy()
        if name == %(WHOLE)r:
            whole = parallel.parallelize(convert.model_from_numpy(
                cfg, trees[weights], device="cpu"), mesh)
            with torch.no_grad():
                out[f"{tag}/whole/logits"] = whole(
                    torch.tensor(inp["tokens"]),
                    compute_dtype=torch.float32,
                    global_batch=len(inp["tokens"])).logits.numpy()
        if name in %(EP)r:
            ep = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, ep_sharding_constraint=True))
            other = convert.model_from_numpy(ep, trees[weights],
                                             device="cpu", mesh=mesh)
            with torch.no_grad():
                out[f"{tag}/ep1/logits"] = other(
                    toks, compute_dtype=torch.float32).logits.numpy()
        model.requires_grad_(True)
        opt = AdamW(learning_rate=LR)
        params = dict(model.named_parameters())
        step = make_train_step(model, opt, remat=True,
                               compute_dtype=torch.float32)
        with mesh_lib.set_mesh(mesh), coll.tally() as t:
            state, metrics = step(TrainState(params, opt.init(params)),
                                  toks, labs)
        out[f"{tag}/metrics"] = np.array([float(v) for v in metrics])
        out[f"{tag}/train/tally"] = tally_blob(t)
        for what, values in (("params", None), ("mu", state.opt.mu)):
            tree_ = convert.model_to_numpy(cfg, model, values)
            if rank == 0:
                for i, leaf in enumerate(leaves(tree_)):
                    out[f"{tag}/{what}/{i}"] = leaf
""" % dict(EP=EP_CASES, WHOLE=WHOLE)


def _cfg(name: str):
    _, arch, change = CASES[name]
    cfg = get_smoke_config(arch)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            **change))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe")
    tr.write_inputs(tmp, tr.MOE_ARCHS)
    with open(tmp / "params.pkl", "rb") as f:
        trees = pickle.load(f)
    trees[E6] = tr.seeded_tree(_cfg(E6), 22)
    with open(tmp / "params.pkl", "wb") as f:
        pickle.dump(trees, f)
    return tr.run(tmp, REFERENCE, PORT)


CELLS = [(mesh, case) for mesh in tr.MESHES for case in CASES]


def _block(ref, spec, mesh, rank):
    return local_shard(torch.tensor(ref), spec, tr.shape_mesh(mesh),
                       tr.coords(mesh, rank)).numpy()


def _rows(ref, mesh, rank):
    return _block(ref, batch_pspec(ref.shape[0], tr.shape_mesh(mesh),
                                   ref.ndim - 1), mesh, rank)


@pytest.mark.parametrize("mesh,case", CELLS)
def test_forward_and_prefill_match_reference(runs, mesh, case):
    cfg = _cfg(case)
    ref = runs["ref"]
    m = tr.shape_mesh(mesh)
    logits = _logits_pspec(m, tr.B, cfg.vocab_size, 3)
    whole = [KVCache(*(torch.tensor(ref[f"{case}/prefill/cache/{i}/{f}"])
                       for f in "kv"))
             for i in range(len(cfg.layer_pattern))]
    specs = cache_pspecs(whole, tr.B, m)
    for rank, port in enumerate(runs["port"]):
        for what in ("fwd", "prefill"):
            np.testing.assert_allclose(
                port[f"{mesh}/{case}/{what}/logits"],
                _block(ref[f"{case}/{what}/logits"], logits, mesh, rank),
                **TOL)
            np.testing.assert_allclose(port[f"{mesh}/{case}/{what}/aux"],
                                       ref[f"{case}/{what}/aux"], **TOL)
        np.testing.assert_allclose(
            port[f"{mesh}/{case}/fwd/risk"],
            _rows(ref[f"{case}/fwd/risk"], mesh, rank), **TOL)
        for i, (c, s) in enumerate(zip(whole, specs)):
            for f, leaf, spec in zip("kv", c, s):
                got = port[f"{mesh}/{case}/prefill/cache/{i}/{f}"]
                want = _block(leaf.numpy(), spec, mesh, rank)
                assert got.shape == want.shape
                np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("mesh", list(tr.MESHES))
def test_whole_batch_on_every_rank_matches_reference(runs, mesh):
    """A placed model given the whole batch on every rank (a batch that
    does not divide over the data axes), with ``global_batch`` its rows,
    takes it whole: its capacity and slots are the batch's own, no counts
    are exchanged, and every rank's logits (every row, its block of the
    vocabulary) are the reference's, with drops."""
    cfg = _cfg(WHOLE)
    m = tr.shape_mesh(mesh)
    spec = _logits_pspec(m, tr.B, cfg.vocab_size, 3)
    spec = type(spec)(None, *spec[1:])
    for rank, port in enumerate(runs["port"]):
        np.testing.assert_allclose(
            port[f"{mesh}/{WHOLE}/whole/logits"],
            _block(runs["ref"][f"{WHOLE}/fwd/logits"], spec, mesh, rank),
            **TOL)


def test_rows_neither_the_batch_nor_its_block_raise():
    """``global_batch`` says which batch a placed MoE's rows belong to:
    their block over the data axes where it is their number times the
    data ranks (the default), the whole batch where it is their number;
    any other raises, in the layer as in ``parallel.data_rows``."""
    from repro_torch.models import Model, parallel

    m = tr.shape_mesh("2x1x2")
    pl = parallel.Placement(m, {"pod": 1, "data": 0, "model": 1}, {})
    assert parallel.data_rows(pl, 2) == (1, 2)
    assert parallel.data_rows(pl, 2, 4) == (1, 2)
    assert parallel.data_rows(pl, 3, 3) == (0, 1)
    assert parallel.data_rows(None, 3, 3) == (0, 1)
    for rows, batch in ((2, 3), (4, 2), (3, 4)):
        with pytest.raises(ValueError, match="neither the batch"):
            parallel.data_rows(pl, rows, batch)
    with pytest.raises(ValueError, match="neither the batch"):
        parallel.data_rows(None, 2, 4)
    cfg = get_smoke_config(OLMOE)
    model = Model(cfg, device="meta", seed=None)
    parallel.parallelize(model, m)
    moe = model.stack[MOE_LAYER[OLMOE]].ffn
    x = torch.empty((2, tr.T, cfg.d_model), device="meta")
    with pytest.raises(ValueError, match="neither the batch"):
        moe_mod.moe_forward(moe, x, cfg.moe, global_batch=3)


@pytest.mark.parametrize("mesh,case", CELLS)
def test_decode_steps_match_reference(runs, mesh, case):
    cfg = _cfg(case)
    ref = runs["ref"]
    m = tr.shape_mesh(mesh)
    for rank, port in enumerate(runs["port"]):
        for s in range(DECODE_STEPS):
            np.testing.assert_allclose(
                port[f"{mesh}/{case}/{s}/logits"],
                _block(ref[f"{case}/{s}/logits"],
                       _logits_pspec(m, tr.B, cfg.vocab_size, 2), mesh,
                       rank), **TOL)
            np.testing.assert_allclose(
                port[f"{mesh}/{case}/{s}/risk"],
                _rows(ref[f"{case}/{s}/risk"], mesh, rank), **TOL)


@pytest.mark.parametrize("mesh,case", CELLS)
def test_decode_batch_slots_are_the_references(runs, mesh, case):
    """The layer on a decode batch of 4 tokens: one chunk over every data
    rank.  Each rank's pairs sit at the reference's positions in their
    experts and drop where the reference's do (pos >= cap), whichever
    rank holds the expert; the rank's output rows are the reference's."""
    cfg = _cfg(case)
    ref = runs["ref"]
    cap = moe_mod.capacity(tr.B, cfg.moe)
    want = ref[f"{case}/layer/slot"]
    dropped = 0
    for rank, port in enumerate(runs["port"]):
        pos = port[f"{mesh}/{case}/layer/pos"]
        got = np.where(pos < cap, pos, -1)
        np.testing.assert_array_equal(got, _rows(want, mesh, rank))
        dropped += int((got < 0).sum())
        np.testing.assert_allclose(
            port[f"{mesh}/{case}/layer/y"],
            _rows(ref[f"{case}/layer/y"], mesh, rank), **TOL)
    if case.endswith("/drops"):
        assert dropped > 0                 # the case does drop pairs


def _leaves(res, prefix):
    n = sum(1 for k in res if k.startswith(prefix + "/"))
    return [res[f"{prefix}/{i}"] for i in range(n)]


@pytest.mark.parametrize("mesh,case", CELLS)
def test_train_step_matches_reference(runs, mesh, case):
    ref = runs["ref"]
    for port in runs["port"]:
        np.testing.assert_allclose(port[f"{mesh}/{case}/metrics"],
                                   ref[f"{case}/metrics"],
                                   rtol=METRIC_RTOL, atol=1e-6)
    port = runs["port"][0]
    grads = _leaves(ref, f"{case}/grads")
    for what in ("mu", "params"):
        got = _leaves(port, f"{mesh}/{case}/{what}")
        want = _leaves(ref, f"{case}/{what}")
        assert len(got) == len(want) == len(grads)
        for i, (a, b, g) in enumerate(zip(got, want, grads)):
            tol = LEAF_TOL * max(np.abs(b).max(), 1e-6)
            if what == "params":
                clear = np.abs(g) > 50 * LEAF_TOL * np.abs(g).max()
                a, b = a[clear], b[clear]
            np.testing.assert_allclose(a, b, rtol=0, atol=tol,
                                       err_msg=f"{what} leaf {i}")


# (gather q, gather k / v) at 2 and 4 ranks of "model": llama4's smoke
# keys are half a head a rank at 4 (2 kv heads of 64); olmoe's 4 / 4
# heads of 32 are whole heads at every m
GATHERS = {(LLAMA4, 4): (False, True)}


def schedule(case: str, mesh: str, what: str) -> tuple[dict, dict]:
    """(bytes, counts) by kind of one rank's float32 forward, prefill or
    decode step: the dense schedule (``test_torch_tensor_parallel.py``,
    ``test_torch_decode_ranks.py``) and, a MoE layer, the all-reduce of
    its float32 partial output over "model", the shared expert's down
    projection, the aux loss's f and p over each data axis (not in a
    decode step) and, where the dispatch chunk spans the data ranks'
    rows, the all-gather of their counts over each data axis."""
    cfg = _cfg(case)
    axes, shape = tr.MESHES[mesh]
    sizes = dict(zip(axes, shape))
    m = sizes["model"]
    daxes = [a for a in axes if a in DATA_AXES]
    n_data = int(np.prod(shape)) // m
    bl = tr.B // n_data
    t = 1 if what == "decode" else tr.T
    d, hd, hq, hkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    e = cfg.moe.num_experts
    act = bl * t * d * 4
    nbytes, counts = {}, {}

    def add(kind, n, each):
        if n:
            nbytes[kind] = nbytes.get(kind, 0) + n * each
            counts[kind] = counts.get(kind, 0) + n

    add("all-reduce", 1, act)                       # the embedding
    gq, gkv = GATHERS.get((case.split("/")[0], m), (False, False))
    for spec in cfg.layer_pattern * cfg.n_groups:
        if what == "decode":
            add("all-gather", 1, bl * (hq + 2 * hkv) * hd * 4)
            add("all-reduce", 1, bl * hq * 4)       # the largest logit
            add("all-reduce", 1, bl * hq * (hd + 1) * 4)
        else:
            add("all-gather", gq, act * hq * hd // d)
            add("all-gather", 2 * gkv, act * hkv * hd // d)
            if what == "prefill" and not gkv and m > 1:
                add("all-to-all", 2, bl * tr.CAP * hkv * hd * 4 // m)
        add("all-reduce", 1, act)                   # wo
        if spec.ffn == "mlp":
            add("all-reduce", 1, act)
            continue
        add("all-reduce", 1, act)                   # the experts' partial
        if cfg.moe.shared_expert:
            add("all-reduce", 1, act)
        if n_data > 1:
            if what != "decode":
                add("all-reduce", len(daxes), 2 * e * 4)
            gathered = 1
            for a in reversed(daxes):
                gathered *= sizes[a]
                add("all-gather", 1, gathered * e * 4)
    return nbytes, counts


@pytest.mark.parametrize("mesh,case", CELLS)
def test_tally_is_the_schedule(runs, mesh, case):
    for what, keys in (("fwd", ["fwd"]), ("prefill", ["prefill"]),
                       ("decode", [str(s) for s in range(DECODE_STEPS)])):
        want = schedule(case, mesh, what)
        for port in runs["port"]:
            for key in keys:
                got = tr.tally(port[f"{mesh}/{case}/{key}/tally"])
                assert got[0] == want[0] and got[1] == want[1], (
                    what, got, want)


def train_schedule(case: str, mesh: str) -> dict:
    """Counts by kind of one rank's train step (remat, float32).  Each
    remat group ends in a MoE layer, whose aux loss saves f and p for the
    backward, so the recompute runs the group's whole forward again: its
    collectives count twice.  The backward adds the "f" all-reduces (wq's
    input and the qk-norm scales a layer, an MLP's input, a MoE's input
    and gates and its shared expert's input), the adjoint of the aux
    loss's all-reduce over each data axis and the gathers'
    reduce-scatters; then the cross entropy, the metrics, each leaf's
    gradient over the data axes and the global norm, as in
    ``test_torch_train_ranks.py``."""
    from repro_torch.launch.shardings import param_pspecs
    from repro_torch.models import Model, parallel

    cfg = _cfg(case)
    mesh_ = tr.shape_mesh(mesh)
    m = mesh_.shape["model"]
    n_axes = sum(1 for a in mesh_.axis_names if a in DATA_AXES)
    n_data = mesh_.size // m
    gq, gkv = GATHERS.get((case.split("/")[0], m), (False, False))
    specs_ = param_pspecs(cfg, Model(cfg, device="meta", seed=None), mesh_)
    counts = {"all-reduce": 0, "all-gather": 0, "reduce-scatter": 0}
    shared = int(cfg.moe.shared_expert)
    for spec in cfg.layer_pattern * cfg.n_groups:
        fwd, bwd = 1, 1 + (2 if cfg.qk_norm else 0)
        counts["all-gather"] += 2 * (gq + 2 * gkv)
        counts["reduce-scatter"] += gq + 2 * gkv
        if spec.ffn == "mlp":
            fwd, bwd = fwd + 1, bwd + 1
        else:
            fwd, bwd = fwd + 1 + shared, bwd + 2 + shared
            if n_data > 1:
                fwd, bwd = fwd + n_axes, bwd + n_axes
                counts["all-gather"] += 2 * n_axes
        counts["all-reduce"] += 2 * fwd + bwd
    counts["all-reduce"] += (1 + 1 + 3 + n_axes + n_axes * len(specs_)
                             + sum(len(axes) for axes in {
                                 parallel.spec_axes(s)
                                 for s in specs_.values()}))
    return {k: v for k, v in counts.items() if v}


@pytest.mark.parametrize("mesh,case", CELLS)
def test_train_tally_is_the_schedule(runs, mesh, case):
    want = train_schedule(case, mesh)
    for port in runs["port"]:
        assert tr.tally(port[f"{mesh}/{case}/train/tally"])[1] == want


@pytest.mark.parametrize("case", EP_CASES)
def test_ep_sharding_constraint_changes_no_number(runs, case):
    ref = runs["ref"]
    np.testing.assert_allclose(ref[f"{case}/ep1/logits"],
                               ref[f"{case}/ep0/logits"], **TOL)
    np.testing.assert_allclose(ref[f"{case}/ep0/logits"],
                               ref[f"{case}/fwd/logits"], **TOL)
    for mesh in tr.MESHES:
        for port in runs["port"]:
            np.testing.assert_array_equal(port[f"{mesh}/{case}/ep1/logits"],
                                          port[f"{mesh}/{case}/fwd/logits"])


def test_experts_that_do_not_divide_fall_back_to_columns():
    """6 experts over 4 ranks of "model": the rules put every expert's
    ff columns on "model" (gate and up column parallel, down row
    parallel) and the layer runs every expert on its block; at 2 ranks
    each holds 3 whole experts."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import Model, parallel

    cfg = _cfg(E6)
    for m, want in ((4, (0, 6)), (2, (0, 3))):
        mesh = mesh_lib.Mesh(("data", "model"), (1, m))
        model = parallel.parallelize(Model(cfg, device="meta", seed=None),
                                     mesh)
        moe = model.stack[0].ffn
        plan = parallel.expert_plan(moe, 6)
        assert (plan.first, plan.count) == want
        assert plan.mesh is mesh
        if m == 4:
            assert moe.gate.shape == (6, cfg.d_model, 32)
            assert moe.down.shape == (6, 32, cfg.d_model)
        else:
            assert moe.gate.shape == (3, cfg.d_model, 128)
