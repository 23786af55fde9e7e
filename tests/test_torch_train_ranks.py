"""The train step across ranks (``training/train.py`` over a model sharded
by ``models/parallel.py``) on four gloo ranks against the reference's
``make_train_step`` on one device, and the launcher under ``torchrun``.

The reference process runs one jitted step (remat, float32 compute,
AdamW) of the qwen3, deepseek-coder, hubert and qwen2-vl smoke configs on
one device, and compiles qwen3's step under GSPMD on each four-device
mesh for ``hlo_costs.collect_collectives`` (the forward of all four is
compiled so in ``test_torch_tensor_parallel.py``).  The ranks run the step on
the meshes (1, 4), (2, 2), (4, 1) and (2, 1, 2), and once more on (2, 2)
with FSDP forced on; each gathers the parameters and both moments after
the step (``convert.model_to_numpy``).

* Loss, ce and grad norm within rtol 1e-5, on every rank.
* Both moments within 2e-5 of each leaf's largest entry (PERF.md §2's
  training rule); the parameters too, where |g| is at least 50 times
  that tolerance of the leaf's largest gradient: at step 1 AdamW moves a
  parameter by lr·g/(|g| + eps), about lr·sign(g), so a gradient within
  rounding of 0 may flip it by 2·lr (as in
  ``test_torch_training_reference.py``).
* Each rank's state bytes (parameters and moments) equal
  ``dryrun.argument_bytes_per_device``'s for the step's state.
* The tally of a rank's step equals the count the schedule implies,
  worked out here (remat: a group's forward runs again in the backward up
  to its last saved tensor, so the down projection's all-reduce is not
  repeated); the reference's HLO tally is recorded beside it.
* The launcher under ``torchrun --nproc-per-node 4`` (gloo) prints the
  one-device launcher's losses and grad norms within rtol 1e-5.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_ranks as tr
from repro_torch.configs import get_smoke_config
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import DATA_AXES
from repro_torch.launch.shardings import param_pspecs
from repro_torch.models import Model, parallel

LR = 1e-3
METRIC_RTOL = 1e-5
LEAF_TOL = 2e-5
RUNS = {**{m: False for m in tr.MESHES}, "2x2_fsdp": True}

REFERENCE = r"""
from repro.training.optimizer import AdamW
from repro.training.train import TrainState, make_loss_fn, make_train_step
tokens, labels = jnp.asarray(inp["tokens"]), jnp.asarray(inp["labels"])
for arch, tree in trees.items():
    cfg = get_smoke_config(arch)
    model = Model(cfg)
    params = jax.tree.map(jnp.asarray, tree)
    opt = AdamW(learning_rate=%(LR)r)
    loss_fn = make_loss_fn(model, remat=False, compute_dtype=jnp.float32)
    grads = jax.jit(jax.grad(lambda p: loss_fn(p, tokens, labels)[0]))(
        params)
    step = make_train_step(model, opt, remat=True,
                           compute_dtype=jnp.float32)
    state = TrainState(params, opt.init(params))
    new, metrics = jax.jit(step)(state, tokens, labels)
    out[f"{arch}/metrics"] = np.array([float(v) for v in metrics])
    for what, t in (("params", new.params), ("mu", new.opt.mu),
                    ("nu", new.opt.nu), ("grads", grads)):
        for i, leaf in enumerate(jax.tree.leaves(t)):
            out[f"{arch}/{what}/{i}"] = leaf
    for name, (axes, shape) in meshes.items():
        if arch != "qwen3-8b":
            continue        # ~4 s a compile: one config on every mesh
        mesh = jax_compat.make_mesh(tuple(shape), tuple(axes))
        with mesh, jax_compat.set_mesh(mesh):
            psh = shardings.params_shardings(params, mesh)
            rep = NamedSharding(mesh, jax.sharding.PartitionSpec())
            ssh = TrainState(psh, type(state.opt)(rep, psh, psh))
            tsh = shardings.tokens_sharding(tokens.shape[0], mesh)
            compiled = jax.jit(step, in_shardings=(ssh, tsh, tsh)).lower(
                state, tokens, labels).compile()
        out[f"{arch}/{name}/hlo"] = tally_blob(compiled)
""" % dict(LR=LR)

PORT = r"""
from repro_torch.training.optimizer import AdamW
from repro_torch.training.train import TrainState, make_train_step
runs = {**{m: (a, s, False) for m, (a, s) in meshes.items()},
        "2x2_fsdp": (*meshes["2x2"], True)}
for name, (axes, shape, fsdp) in runs.items():
    mesh = mesh_lib.init_mesh(mesh_lib.Mesh(tuple(axes), tuple(shape)),
                              device="cpu")
    for arch, tree in trees.items():
        cfg = get_smoke_config(arch)
        model = convert.model_from_numpy(cfg, tree, device="cpu", mesh=mesh,
                                         fsdp=fsdp).requires_grad_(True)
        opt = AdamW(learning_rate=%(LR)r)
        params = dict(model.named_parameters())
        state = TrainState(params, opt.init(params))
        out[f"{name}/{arch}/state_bytes"] = np.array(sum(
            t.numel() * t.element_size() for part in (params, state.opt.mu,
                                                     state.opt.nu)
            for t in part.values()))
        step = make_train_step(model, opt, remat=True,
                               compute_dtype=torch.float32)
        with mesh_lib.set_mesh(mesh), coll.tally() as t:
            state, metrics = step(state, rows(inp["tokens"], mesh),
                                  rows(inp["labels"], mesh))
        out[f"{name}/{arch}/metrics"] = np.array([float(v) for v in metrics])
        out[f"{name}/{arch}/tally"] = tally_blob(t)
        for what, values in (("params", None), ("mu", state.opt.mu),
                             ("nu", state.opt.nu)):
            tree_ = convert.model_to_numpy(cfg, model, values)
            if rank == 0:
                for i, leaf in enumerate(leaves(tree_)):
                    out[f"{name}/{arch}/{what}/{i}"] = leaf
""" % dict(LR=LR)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return tr.run(tmp_path_factory.mktemp("train"), REFERENCE, PORT)


CELLS = [(run, arch) for run in RUNS for arch in tr.ARCHS]


def _leaves(res, prefix):
    n = sum(1 for k in res if k.startswith(prefix + "/"))
    return [res[f"{prefix}/{i}"] for i in range(n)]


@pytest.mark.parametrize("run,arch", CELLS)
def test_step_metrics_match_reference(runs, run, arch):
    want = runs["ref"][f"{arch}/metrics"]
    for port in runs["port"]:
        np.testing.assert_allclose(port[f"{run}/{arch}/metrics"], want,
                                   rtol=METRIC_RTOL, atol=1e-6)


@pytest.mark.parametrize("run,arch", CELLS)
def test_parameters_and_moments_match_reference(runs, run, arch):
    ref, port = runs["ref"], runs["port"][0]
    grads = _leaves(ref, f"{arch}/grads")
    for what in ("mu", "nu", "params"):
        got = _leaves(port, f"{run}/{arch}/{what}")
        want = _leaves(ref, f"{arch}/{what}")
        assert len(got) == len(want) == len(grads)
        for i, (a, b, g) in enumerate(zip(got, want, grads)):
            tol = LEAF_TOL * max(np.abs(b).max(), 1e-6)
            if what == "params":
                clear = np.abs(g) > 50 * LEAF_TOL * np.abs(g).max()
                a, b = a[clear], b[clear]
            np.testing.assert_allclose(a, b, rtol=0, atol=tol,
                                       err_msg=f"{what} leaf {i}")


@pytest.mark.parametrize("run,arch", CELLS)
def test_rank_state_bytes_are_the_rules(runs, run, arch):
    mesh = tr.shape_mesh(run.split("_")[0])
    cfg = get_smoke_config(arch)
    bundle = specs.build_step(arch, InputShape("smoke", tr.T, tr.B,
                                               "train"), cfg=cfg)
    want = dryrun.argument_bytes_per_device(bundle, mesh,
                                            fsdp=RUNS[run])
    for port in runs["port"]:
        assert int(port[f"{run}/{arch}/state_bytes"]) == \
            want["by_argument"][0] - 4      # less the step counter


def schedule(arch: str, run: str) -> dict:
    """Counts by kind of one rank's train step (remat, float32) under the
    schedule: the forward's collectives, each group's recompute up to its
    down projection, the backward's "f" all-reduces and the gathers'
    reduce-scatters, the vocab-parallel cross entropy, the metrics and the
    gradients over the data axes, the global norm."""
    cfg = get_smoke_config(arch)
    mesh = tr.shape_mesh(run.split("_")[0])
    m = mesh.shape["model"]
    n_axes = sum(1 for a in mesh.axis_names if a in DATA_AXES)
    gq, gkv = GATHERS.get((arch, m), (False, False))
    model = Model(cfg, device="meta", seed=None)
    specs_ = param_pspecs(cfg, model, mesh, fsdp=RUNS[run])
    fsdp = {k: sum(1 for a in parallel.spec_axes(s) if a in DATA_AXES)
            for k, s in specs_.items()}
    layer = [k for k in specs_ if k.startswith("stack.0.")]
    gathers = 2 * gq + 4 * gkv + 2 * sum(fsdp[k] for k in layer)
    scatters = gq + 2 * gkv + sum(fsdp[k] for k in layer)
    all_reduce = 3 + 2 + (2 if cfg.qk_norm else 0)
    heads = [k for k in specs_ if not k.startswith("stack.")]
    counts = {"all-gather": cfg.n_layers * gathers
              + sum(fsdp[k] for k in heads),
              "reduce-scatter": cfg.n_layers * scatters
              + sum(fsdp[k] for k in heads),
              "all-reduce": cfg.n_layers * all_reduce
              + 1 + 1 + 3              # embedding, lm head's f, the CE
              + n_axes                 # the metrics
              + n_axes * sum(1 for k in specs_ if not fsdp[k])
              + sum(len(axes) for axes in {parallel.spec_axes(s)
                                           for s in specs_.values()})}
    return {k: v for k, v in counts.items() if v}


GATHERS = {("qwen3-8b", 2): (False, False), ("qwen2-vl-7b", 2): (False, False),
           ("deepseek-coder-33b", 2): (True, True),
           ("hubert-xlarge", 2): (False, False),
           ("qwen3-8b", 4): (False, True), ("qwen2-vl-7b", 4): (False, True),
           ("deepseek-coder-33b", 4): (True, True),
           ("hubert-xlarge", 4): (False, False)}


@pytest.mark.parametrize("run,arch", CELLS)
def test_tally_is_the_schedule(runs, run, arch, record_property):
    want = schedule(arch, run)
    for port in runs["port"]:
        assert tr.tally(port[f"{run}/{arch}/tally"])[1] == want
    hlo = runs["ref"].get(f"{arch}/{run.split('_')[0]}/hlo")
    if hlo is not None:
        hlo_bytes, hlo_counts = tr.tally(hlo)
        record_property("reference_hlo_collectives", json.dumps(
            {"bytes": hlo_bytes, "counts": hlo_counts}))


def _launch(tmp_path, n: int) -> list[dict]:
    out = tmp_path / f"metrics{n}.json"
    args = ["-m", "repro_torch.launch.train", "--arch", "qwen3-8b",
            "--smoke", "--device", "cpu", "--steps", "4", "--batch", "4",
            "--seq", "16", "--metrics", str(out)]
    if n > 1:
        args = ["-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", str(n)] + args
    proc = subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, timeout=240, cwd=tr.ROOT, env=tr.env())
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "done" and len(lines) == 6
    if n > 1:
        assert "mesh: {'data': 1, 'model': 4}" in lines[0]
    with open(out) as f:
        return json.load(f)


def test_launcher_over_four_gloo_ranks_matches_one_device(tmp_path):
    one, four = _launch(tmp_path, 1), _launch(tmp_path, 4)
    assert [r["step"] for r in four] == [1, 2, 3, 4]
    for a, b in zip(four, one):
        for key in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-5)


def test_mesh_for_devices_is_the_references():
    from repro_torch.launch.train import make_mesh_for_devices

    for n, shape in ((1, (1, 1)), (4, (1, 4)), (6, (3, 2)), (32, (2, 16)),
                     (256, (16, 16))):
        assert make_mesh_for_devices(n).axis_sizes == shape


def test_unsharded_models_over_several_ranks_raise():
    """A model must be sharded first (olmoe once raised, naming item
    13g's MoE half, and its a2a MoE did until that item landed; Mamba and
    xLSTM once raised item 13h′): every family's whole model under a mesh
    of several ranks raises, asking for ``parallelize``, which now takes
    the Mamba and xLSTM families and the a2a MoE too."""
    import dataclasses

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train import TrainState, make_train_step

    toks = torch.zeros((2, 8), dtype=torch.long)
    for arch, err, match in (
            ("qwen3-8b", ValueError, "parallelize"),
            ("olmoe-1b-7b", ValueError, "parallelize"),
            ("olmoe-1b-7b a2a", ValueError, "parallelize"),
            ("jamba-1.5-large-398b", ValueError, "parallelize"),
            ("xlstm-1.3b", ValueError, "parallelize")):
        cfg = get_smoke_config(arch.split()[0])
        if arch.endswith("a2a"):
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, impl="a2a"))
        if arch == "jamba-1.5-large-398b":
            cfg = dataclasses.replace(cfg, n_layers=len(cfg.layer_pattern))
        model = Model(cfg, device="cpu", seed=0).requires_grad_(True)
        opt = AdamW()
        params = dict(model.named_parameters())
        with mesh_lib.set_mesh(mesh_lib.Mesh(("data", "model"), (2, 2))), \
                pytest.raises(err, match=match):
            make_train_step(model, opt)(TrainState(params, opt.init(params)),
                                        toks, toks)
    for arch in ("xlstm-1.3b", "olmoe-1b-7b a2a"):
        cfg = get_smoke_config(arch.split()[0])
        if arch.endswith("a2a"):
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, impl="a2a"))
        placed = parallel.parallelize(Model(cfg, device="meta", seed=None),
                                      mesh_lib.Mesh(("data", "model"),
                                                    (2, 2)))
        assert parallel.of(placed).mesh.shape == {"data": 2, "model": 2}
