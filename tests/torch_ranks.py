"""Shared by the tensor-parallel tests (``test_torch_tensor_parallel.py``,
``test_torch_train_ranks.py``, ``test_torch_pod_dryrun.py``,
``test_torch_decode_ranks.py``, ``test_torch_moe_ranks.py``,
``test_torch_mamba_ranks.py``, ``test_torch_xlstm_ranks.py``): the smoke
configs chosen for their head layouts at four ranks of "model", the
meshes, numpy-seeded weights and inputs, and the runs of the port's four
gloo ranks beside one reference process, each subprocess with
``OMP_NUM_THREADS=1`` and its own time limit.  The MoE configs
(:data:`MOE_ARCHS`) and the Mamba and xLSTM ones
(:data:`RECURRENT_ARCHS`) have weights of their own, written where a run
asks for them.

* qwen3-8b: qk-norm, its keys half a head a rank at m = 4;
* deepseek-coder-33b: 7 heads of 32 over d = 224, 1.75 q heads a rank;
* hubert-xlarge: the encoder, non-causal, heads aligned;
* qwen2-vl-7b: M-RoPE, embeds in.
"""
from __future__ import annotations

import json
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("qwen3-8b", "deepseek-coder-33b", "hubert-xlarge", "qwen2-vl-7b")
MOE_ARCHS = ("olmoe-1b-7b", "llama4-maverick-400b-a17b")
RECURRENT_ARCHS = ("jamba-1.5-large-398b", "xlstm-1.3b")
MESHES = {"1x4": (("data", "model"), (1, 4)),
          "2x2": (("data", "model"), (2, 2)),
          "4x1": (("data", "model"), (4, 1)),
          "2x1x2": (("pod", "data", "model"), (2, 1, 2))}
B, T, CAP = 4, 8, 12
STEPS = 8          # decode tokens in the inputs
LONG_T = 40        # a prompt past the xLSTM smoke's chunk of 32
TIMEOUT = 240

# the ranks' common preamble: argv is (rank, tmp, meshes as JSON)
PORT_HEAD = r"""
import json, os, pickle, sys, warnings
warnings.simplefilter("ignore")
import numpy as np
import torch
import torch.distributed as dist
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.launch import collectives as coll
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.shardings import batch_pspec, local_shard
from repro_torch.models import parallel

rank, tmp = int(sys.argv[1]), sys.argv[2]
meshes = json.loads(sys.argv[3])
torch.set_num_threads(1)
dist.init_process_group(
    "gloo", store=dist.FileStore(os.path.join(tmp, "store"), 4),
    rank=rank, world_size=4)
inp = np.load(os.path.join(tmp, "inputs.npz"))
with open(os.path.join(tmp, "params.pkl"), "rb") as f:
    trees = pickle.load(f)
out = {}

def tally_blob(t):
    return np.frombuffer(json.dumps(
        [t.bytes_by_kind, t.count_by_kind]).encode(), np.uint8)

def rows(x, mesh):
    return local_shard(torch.tensor(x), batch_pspec(x.shape[0], mesh,
                                                    x.ndim - 1),
                       mesh, mesh.coords()).contiguous()

def leaves(tree):
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [a for v in tree for a in leaves(v)]
    return [tree]
"""
PORT_TAIL = r"""
np.savez(os.path.join(tmp, f"port{rank}.npz"), **out)
dist.destroy_process_group()
print("PORT_OK")
"""

# the reference's preamble: argv is (tmp, meshes as JSON)
REFERENCE_HEAD = r"""
import json, os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding
from repro import jax_compat
from repro.configs import get_smoke_config
from repro.launch import hlo_costs, shardings
from repro.models.model import Model

tmp = sys.argv[1]
meshes = json.loads(sys.argv[2])
inp = np.load(os.path.join(tmp, "inputs.npz"))
with open(os.path.join(tmp, "params.pkl"), "rb") as f:
    trees = pickle.load(f)
out = {}

def tally_blob(compiled):
    c = hlo_costs.collect_collectives(compiled.as_text())
    return np.frombuffer(json.dumps(
        [c.bytes_by_kind, c.count_by_kind]).encode(), np.uint8)
"""
REFERENCE_TAIL = r"""
np.savez(os.path.join(tmp, "reference.npz"),
         **{k: np.asarray(v) for k, v in out.items()})
print("REFERENCE_OK")
"""


def env() -> dict:
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
            "GLOO_SOCKET_IFNAME": "lo"}


def seeded_tree(cfg, seed: int):
    """The port's init of ``cfg`` from ``seed`` in the reference's tree,
    every 1-d leaf perturbed (no norm scale is exactly 1)."""
    import torch

    from repro_torch import convert
    from repro_torch.models import Model

    model = Model(cfg, device="cpu", seed=seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 1:
                p.add_(torch.linspace(-0.1, 0.1, p.numel()))
    return convert.model_to_numpy(cfg, model)


def write_inputs(tmp: pathlib.Path, archs=ARCHS) -> None:
    """The smoke models' weights (``ARCHS`` seeded 10, 11, ...; the MoE
    configs 20, 21, ...; jamba and xlstm-1.3b 30, 31) and the tokens,
    embeddings and labels, and the decode steps' tokens and
    embeddings."""
    from repro_torch.configs import get_smoke_config

    seeds = {**{a: 10 + i for i, a in enumerate(ARCHS)},
             **{a: 20 + i for i, a in enumerate(MOE_ARCHS)},
             **{a: 30 + i for i, a in enumerate(RECURRENT_ARCHS)}}
    trees = {arch: seeded_tree(get_smoke_config(arch), seeds[arch])
             for arch in archs}
    with open(tmp / "params.pkl", "wb") as f:
        pickle.dump(trees, f)
    rng = np.random.default_rng(28)
    np.savez(tmp / "inputs.npz",
             tokens=rng.integers(0, 104, (B, T)),
             labels=rng.integers(0, 104, (B, T)),
             embeds=rng.normal(0, 1, (B, T, 256)).astype(np.float32),
             decode_tokens=rng.integers(0, 104, (B, STEPS)),
             decode_embeds=rng.normal(0, 1, (B, STEPS, 256)).astype(
                 np.float32),
             long_tokens=rng.integers(0, 104, (B, LONG_T)),
             long_labels=rng.integers(0, 104, (B, LONG_T)))


def _finish(proc, what):
    try:
        stdout, stderr = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        stdout, stderr = proc.communicate()
    assert proc.returncode == 0 and f"{what}_OK" in stdout, (
        f"{what} rc={proc.returncode}\n{stdout[-2000:]}\n{stderr[-4000:]}")


def run(tmp: pathlib.Path, reference: str | None, port: str,
        meshes: dict = MESHES, archs=ARCHS) -> dict:
    """The reference process (``REFERENCE_HEAD + reference +
    REFERENCE_TAIL``) and four ranks (``PORT_HEAD + port + PORT_TAIL``)
    started together, the weights of ``archs`` in ``trees``; their
    results."""
    if not (tmp / "params.pkl").exists():
        write_inputs(tmp, archs)
    m = json.dumps(meshes)
    procs = []
    if reference is not None:
        procs.append((subprocess.Popen(
            [sys.executable, "-c", REFERENCE_HEAD + reference
             + REFERENCE_TAIL, str(tmp), m],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env(), cwd=ROOT), "REFERENCE"))
    procs += [(subprocess.Popen(
        [sys.executable, "-c", PORT_HEAD + port + PORT_TAIL, str(r),
         str(tmp), m],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env(), cwd=ROOT), "PORT") for r in range(4)]
    for proc, what in procs:
        _finish(proc, what)
    return {"ref": dict(np.load(tmp / "reference.npz"))
            if reference is not None else None,
            "port": [dict(np.load(tmp / f"port{r}.npz")) for r in range(4)]}


def tally(blob) -> tuple[dict, dict]:
    return tuple(json.loads(bytes(blob).decode()))


def coords(mesh: str, rank: int) -> dict[str, int]:
    axes, shape = MESHES[mesh]
    return dict(zip(axes, (int(c) for c in np.unravel_index(rank, shape))))


def shape_mesh(mesh: str):
    from repro_torch.launch import mesh as mesh_lib

    axes, shape = MESHES[mesh]
    return mesh_lib.Mesh(tuple(axes), tuple(shape))


def model_input(cfg) -> str:
    """The input key of the smoke config's forward, the array's name in
    ``inputs.npz``."""
    return "embeds" if cfg.embeds_input else "tokens"



# ---------------------------------------------------------------------------
# the recurrent mixers' runs (test_torch_mamba_ranks.py,
# test_torch_xlstm_ranks.py): CASES maps a case to (arch, the inputs' key
# prefix of its prompt and labels, the key of its weights in params.pkl);
# each runs forward, prefill, STEPS
# decode steps and one train step (remat, float32, AdamW at LR), on every
# mesh and once more on (2, 2) with FSDP on
# ---------------------------------------------------------------------------

RECURRENT_REFERENCE = r"""
from repro.training.train import TrainState, make_loss_fn, make_train_step
from repro.training.optimizer import AdamW
CASES, STEPS, LR = %(CASES)r, %(STEPS)d, %(LR)r
for case, (arch, key, weights) in CASES.items():
    cfg = get_smoke_config(arch)
    model = Model(cfg)
    params = jax.tree.map(jnp.asarray, trees[weights])
    x = jnp.asarray(inp[key + "tokens"])
    labels = jnp.asarray(inp[key + "labels"])
    t = x.shape[1]
    o = jax.jit(lambda p, xx: model.forward(
        p, tokens=xx, compute_dtype=jnp.float32))(params, x)
    out[f"{case}/fwd/logits"], out[f"{case}/fwd/risk"] = o.logits, \
        o.risk_score
    o, cache = jax.jit(lambda p, xx: model.prefill(
        p, tokens=xx, cache_capacity=t + STEPS,
        compute_dtype=jnp.float32))(params, x)
    out[f"{case}/prefill/logits"] = o.logits
    out[f"{case}/prefill/risk"] = o.risk_score
    for i, c in enumerate(cache):
        for f, leaf in zip(c._fields, c):
            out[f"{case}/prefill/cache/{i}/{f}"] = leaf
    step = jax.jit(lambda p, c, xx, pos: model.decode_step(
        p, c, tokens=xx, pos=pos, compute_dtype=jnp.float32))
    for s in range(STEPS):
        o = step(params, cache, jnp.asarray(inp["decode_tokens"][:, s:s + 1]),
                 t + s)
        cache = o.cache
        out[f"{case}/{s}/logits"], out[f"{case}/{s}/risk"] = o.logits, \
            o.risk_score
    for i, c in enumerate(cache):
        for f, leaf in zip(c._fields, c):
            out[f"{case}/decode/cache/{i}/{f}"] = leaf
    opt = AdamW(learning_rate=LR)
    loss_fn = make_loss_fn(model, remat=False, compute_dtype=jnp.float32)
    grads = jax.jit(jax.grad(lambda p: loss_fn(p, x, labels)[0]))(params)
    train = make_train_step(model, opt, remat=True,
                            compute_dtype=jnp.float32)
    state = TrainState(params, opt.init(params))
    new, metrics = jax.jit(train)(state, x, labels)
    out[f"{case}/metrics"] = np.array([float(v) for v in metrics])
    for what, tree_ in (("params", new.params), ("mu", new.opt.mu),
                        ("nu", new.opt.nu), ("grads", grads)):
        for i, leaf in enumerate(jax.tree.leaves(tree_)):
            out[f"{case}/{what}/{i}"] = leaf
    if key:
        continue            # the compiled forward of the T = 8 prompt only
    for name, (axes, shape) in meshes.items():
        mesh = jax_compat.make_mesh(tuple(shape), tuple(axes))
        with mesh, jax_compat.set_mesh(mesh):
            psh = shardings.params_shardings(params, mesh)
            xsh = NamedSharding(mesh, shardings.batch_pspec(
                x.shape[0], mesh, 1))
            compiled = jax.jit(
                lambda p, xx: model.forward(
                    p, tokens=xx, compute_dtype=jnp.float32).logits,
                in_shardings=(psh, xsh)).lower(params, x).compile()
        out[f"{case}/{name}/hlo"] = tally_blob(compiled)
"""

RECURRENT_PORT = r"""
from repro_torch.training.optimizer import AdamW
from repro_torch.training.train import TrainState, make_train_step
CASES, STEPS, LR = %(CASES)r, %(STEPS)d, %(LR)r
runs = {**{m: (a, s, False) for m, (a, s) in meshes.items()},
        "2x2_fsdp": (*meshes["2x2"], True)}
f32 = torch.float32
for name, (axes, shape, fsdp) in runs.items():
    mesh = mesh_lib.init_mesh(mesh_lib.Mesh(tuple(axes), tuple(shape)),
                              device="cpu")
    for case, (arch, key, weights) in CASES.items():
        cfg = get_smoke_config(arch)
        model = convert.model_from_numpy(cfg, trees[weights], device="cpu",
                                         mesh=mesh, fsdp=fsdp)
        x, labels = rows(inp[key + "tokens"], mesh), rows(
            inp[key + "labels"], mesh)
        t, cap = x.shape[1], x.shape[1] + STEPS
        tag = f"{name}/{case}"
        with coll.tally() as tl, torch.no_grad():
            o = model(x, compute_dtype=f32)
        out[f"{tag}/fwd/logits"], out[f"{tag}/fwd/risk"] = \
            o.logits.numpy(), o.risk_score.numpy()
        out[f"{tag}/fwd/tally"] = tally_blob(tl)
        with coll.tally() as tl:
            o, cache = model.prefill(x, cache_capacity=cap, compute_dtype=f32)
        out[f"{tag}/prefill/logits"] = o.logits.numpy()
        out[f"{tag}/prefill/risk"] = o.risk_score.numpy()
        out[f"{tag}/prefill/tally"] = tally_blob(tl)
        for i, c in enumerate(cache):
            for f, leaf in zip(c._fields, c):
                out[f"{tag}/prefill/cache/{i}/{f}"] = leaf.clone().numpy()
        xs = rows(inp["decode_tokens"], mesh)
        for s in range(STEPS):
            with coll.tally() as tl:
                o = model.decode_step(cache, xs[:, s:s + 1], pos=t + s,
                                      cache_capacity=cap, compute_dtype=f32)
            out[f"{tag}/{s}/logits"] = o.logits.numpy()
            out[f"{tag}/{s}/risk"] = o.risk_score.numpy()
            out[f"{tag}/{s}/tally"] = tally_blob(tl)
        for i, c in enumerate(cache):
            for f, leaf in zip(c._fields, c):
                out[f"{tag}/decode/cache/{i}/{f}"] = leaf.numpy()
        model.requires_grad_(True)
        opt = AdamW(learning_rate=LR)
        params = dict(model.named_parameters())
        state = TrainState(params, opt.init(params))
        out[f"{tag}/state_bytes"] = np.array(sum(
            a.numel() * a.element_size() for part in (params, state.opt.mu,
                                                     state.opt.nu)
            for a in part.values()))
        step = make_train_step(model, opt, remat=True, compute_dtype=f32)
        with mesh_lib.set_mesh(mesh), coll.tally() as tl:
            state, metrics = step(state, x, labels)
        out[f"{tag}/metrics"] = np.array([float(v) for v in metrics])
        out[f"{tag}/train/tally"] = tally_blob(tl)
        for what, values in (("params", None), ("mu", state.opt.mu),
                             ("nu", state.opt.nu)):
            tree_ = convert.model_to_numpy(cfg, model, values)
            if rank == 0:
                for i, leaf in enumerate(leaves(tree_)):
                    out[f"{tag}/{what}/{i}"] = leaf
"""
RECURRENT_RUNS = (*MESHES, "2x2_fsdp")


def recurrent_run(tmp: pathlib.Path, cases: dict, lr: float) -> dict:
    """The reference and the four ranks over :data:`RECURRENT_REFERENCE` /
    :data:`RECURRENT_PORT` for ``cases`` (the weights a case names that
    are not an arch's are in ``params.pkl`` already)."""
    fill = dict(CASES=cases, STEPS=STEPS, LR=lr)
    return run(tmp, RECURRENT_REFERENCE % fill, RECURRENT_PORT % fill,
               archs=tuple(sorted({a for a, _, _ in cases.values()})))


def _block(ref, spec, mesh: str, rank: int):
    import torch

    from repro_torch.launch.shardings import local_shard

    return local_shard(torch.tensor(np.asarray(ref)), spec,
                       shape_mesh(mesh), coords(mesh, rank)).numpy()


def check_outputs(runs: dict, run: str, case: str, cfg, keys, tol) -> None:
    """Each rank's logits (its rows, its block of the vocabulary) and risk
    (its rows) of every key (``fwd``, ``prefill``, a decode step) within
    ``tol`` of the reference's."""
    from repro_torch.launch.dryrun import _logits_pspec
    from repro_torch.launch.shardings import batch_pspec

    mesh = run.split("_")[0]
    m = shape_mesh(mesh)
    ref = runs["ref"]
    for rank, port in enumerate(runs["port"]):
        for key in keys:
            want = ref[f"{case}/{key}/logits"]
            got = port[f"{run}/{case}/{key}/logits"]
            want = _block(want, _logits_pspec(m, B, cfg.vocab_size,
                                              want.ndim), mesh, rank)
            assert got.shape == want.shape, (key, got.shape, want.shape)
            np.testing.assert_allclose(got, want, **tol, err_msg=key)
            np.testing.assert_allclose(
                port[f"{run}/{case}/{key}/risk"],
                _block(ref[f"{case}/{key}/risk"], batch_pspec(B, m, 0),
                       mesh, rank), **tol, err_msg=key)


def check_cache(runs: dict, run: str, case: str, what: str, tol) -> None:
    """Each rank's block of every leaf of the ``what`` cache (``prefill``:
    the prefill's; ``decode``: after the last step) is its slice of the
    reference's under ``cache_pspec``, within ``tol``."""
    from repro_torch.launch.shardings import cache_pspec

    mesh = run.split("_")[0]
    m = shape_mesh(mesh)
    ref = runs["ref"]
    prefix = f"{case}/{what}/cache/"
    names = [k[len(prefix):] for k in ref if k.startswith(prefix)]
    assert names
    for name in names:
        leaf = ref[prefix + name]
        i, field = name.split("/")
        spec = cache_pspec(f"{i}/{field}/", leaf.shape, B, m)
        for rank, port in enumerate(runs["port"]):
            got = port[f"{run}/{prefix}{name}"]
            want = _block(leaf, spec, mesh, rank)
            assert got.shape == want.shape, (name, got.shape, want.shape)
            np.testing.assert_allclose(got, want, **tol, err_msg=name)


def _leaves(res: dict, prefix: str) -> list:
    n = sum(1 for k in res if k.startswith(prefix + "/"))
    return [res[f"{prefix}/{i}"] for i in range(n)]


def check_train(runs: dict, run: str, case: str, metric_rtol: float,
                leaf_tol: float) -> None:
    """Loss, ce, aux and grad norm within ``metric_rtol`` on every rank;
    both moments within ``leaf_tol`` of each leaf's largest entry, the
    parameters too where |g| is at least 50 times that of the leaf's
    largest gradient (``test_torch_train_ranks.py``'s rule)."""
    ref, port = runs["ref"], runs["port"]
    for p in port:
        np.testing.assert_allclose(p[f"{run}/{case}/metrics"],
                                   ref[f"{case}/metrics"],
                                   rtol=metric_rtol, atol=1e-6)
    grads = _leaves(ref, f"{case}/grads")
    for what in ("mu", "nu", "params"):
        got = _leaves(port[0], f"{run}/{case}/{what}")
        want = _leaves(ref, f"{case}/{what}")
        assert len(got) == len(want) == len(grads)
        for i, (a, b, g) in enumerate(zip(got, want, grads)):
            tol = leaf_tol * max(np.abs(b).max(), 1e-6)
            if what == "params":
                clear = np.abs(g) > 50 * leaf_tol * np.abs(g).max()
                a, b = a[clear], b[clear]
            np.testing.assert_allclose(a, b, rtol=0, atol=tol,
                                       err_msg=f"{what} leaf {i}")


class Tally:
    """A hand count: bytes and counts by kind."""

    def __init__(self):
        self.bytes: dict[str, int] = {}
        self.counts: dict[str, int] = {}

    def add(self, kind: str, n: int, each: int = 0) -> None:
        if n:
            self.bytes[kind] = self.bytes.get(kind, 0) + n * each
            self.counts[kind] = self.counts.get(kind, 0) + n


def fsdp_gathers(cfg, run: str, prefix: str = "stack.") -> tuple[int, int]:
    """(count, float32 bytes) of the all-gathers over the data axes of
    every parameter whose name starts with ``prefix`` (one use each) where
    ``run`` FSDPs the model."""
    import math

    from repro_torch.launch.mesh import DATA_AXES
    from repro_torch.launch.shardings import param_pspecs, shard_shape
    from repro_torch.models import Model, parallel

    if not run.endswith("_fsdp"):
        return 0, 0
    mesh = shape_mesh(run.split("_")[0])
    model = Model(cfg, device="meta", seed=None)
    specs = param_pspecs(cfg, model, mesh, fsdp=True)
    n = nbytes = 0
    for name, p in model.named_parameters():
        if not name.startswith(prefix):
            continue
        axes = [a for a in parallel.spec_axes(specs[name])
                if a in DATA_AXES]
        local = math.prod(shard_shape(p.shape, specs[name], mesh))
        for a in reversed(axes):
            local *= mesh.shape[a]
            n += 1
            nbytes += local * 4
    return n, nbytes


def train_tail(cfg, run: str) -> tuple[dict, int, int]:
    """The train step's collectives outside the layers: all-reduce counts
    (the embedding, the lm head's "f", the cross entropy's three, the
    metrics and each whole leaf's gradient over each data axis, the
    global norm) and the gathers / reduce-scatters of the FSDP'd leaves
    outside the stack (one use each); returns (counts, layer FSDP
    gathers, their reduce-scatters)."""
    from repro_torch.launch.mesh import DATA_AXES
    from repro_torch.launch.shardings import param_pspecs
    from repro_torch.models import Model, parallel

    mesh = shape_mesh(run.split("_")[0])
    fsdp = run.endswith("_fsdp")
    n_axes = sum(1 for a in mesh.axis_names if a in DATA_AXES)
    specs = param_pspecs(cfg, Model(cfg, device="meta", seed=None), mesh,
                         fsdp=fsdp)
    data = {k: sum(1 for a in parallel.spec_axes(s) if a in DATA_AXES)
            for k, s in specs.items()}
    heads = sum(v for k, v in data.items() if not k.startswith("stack."))
    layer = sum(v for k, v in data.items() if k.startswith("stack."))
    counts = {"all-reduce": 1 + 1 + 3 + n_axes
              + n_axes * sum(1 for k in specs if not data[k])
              + sum(len(axes) for axes in {parallel.spec_axes(s)
                                           for s in specs.values()}),
              "all-gather": heads, "reduce-scatter": heads}
    return counts, layer, layer


# ---------------------------------------------------------------------------
# the --variant bundles' runs (test_torch_variant_ranks.py): the cases'
# forward, prefill, STEPS decode steps and train step under the bundle's
# kwargs (``launch/dryrun.py::variant_build_kwargs``), every case on every
# mesh of VARIANT_MESHES with FSDP on, beside the baseline's forward,
# prefill and train step for the tally; OPT3 also trains under opt3, and
# OPT4 runs opt4's forward, prefill and train step (the all-to-all MoE)
# and the all-to-all MoE's train step in the baseline layout ("a2a")
# ---------------------------------------------------------------------------

VARIANT_MESHES = ("2x2", "2x1x2")

VARIANT_REFERENCE = r"""
import dataclasses
import repro.launch.dryrun as rdry   # sets XLA_FLAGS: put back before use
# LLVM at -O0: compiling is most of this process's time at the smoke sizes
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_backend_optimization_level=0")
from repro.training.train import TrainState, make_train_step
from repro.training.optimizer import AdamW
CASES, OPT3, OPT4, STEPS, LR = (%(CASES)r, %(OPT3)r, %(OPT4)r, %(STEPS)d,
                                %(LR)r)
f32 = jnp.float32

def spec_json(kw):
    return {k: [list(e) if isinstance(e, tuple) else e for e in v]
            if k == "act_pspec" else v for k, v in kw.items()}

tables = {}
for name, (axes, shape) in meshes.items():
    one = jax_compat.make_mesh((1,) * len(axes), tuple(axes))
    tables[name] = {f"{v}/{k}": spec_json(rdry.variant_build_kwargs(
        v, k, one)) for v in ("opt", "opt2", "opt3", "opt4")
        for k in ("train", "prefill", "decode")}
out["kwargs"] = np.frombuffer(json.dumps(tables).encode(), np.uint8)
mesh = jax_compat.make_mesh((1, 1), ("data", "model"))

def kwargs(variant, kind):
    if variant == "a2a":
        return {"moe_impl": "a2a"}
    return rdry.variant_build_kwargs(variant, kind, mesh)

def variant_cfg(cfg, kw):
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, ep_sharding_constraint=kw.get("moe_ep_constraint", False),
        impl=kw.get("moe_impl", "einsum")))

with mesh, jax_compat.set_mesh(mesh):
    for arch in CASES:
        cfg = get_smoke_config(arch)
        model = Model(cfg)
        params = jax.tree.map(jnp.asarray, trees[arch])
        x = jnp.asarray(inp["tokens"])
        labels = jnp.asarray(inp["labels"])
        t = x.shape[1]
        act = kwargs("opt", "prefill")["act_pspec"]
        o = jax.jit(lambda p, xx: model.forward(
            p, tokens=xx, compute_dtype=f32, act_pspec=act))(params, x)
        out[f"{arch}/fwd/logits"], out[f"{arch}/fwd/risk"] = o.logits, \
            o.risk_score
        o, cache = jax.jit(lambda p, xx: model.prefill(
            p, tokens=xx, cache_capacity=t + STEPS, compute_dtype=f32,
            act_pspec=act))(params, x)
        out[f"{arch}/prefill/logits"] = o.logits
        out[f"{arch}/prefill/risk"] = o.risk_score
        for i, c in enumerate(cache):
            for f, leaf in zip(c._fields, c):
                out[f"{arch}/prefill/cache/{i}/{f}"] = leaf
        dact = kwargs("opt", "decode")["act_pspec"]
        step = jax.jit(lambda p, c, xx, pos: model.decode_step(
            p, c, tokens=xx, pos=pos, compute_dtype=f32, act_pspec=dact))
        for s in range(STEPS):
            o = step(params, cache,
                     jnp.asarray(inp["decode_tokens"][:, s:s + 1]), t + s)
            cache = o.cache
            out[f"{arch}/{s}/logits"], out[f"{arch}/{s}/risk"] = o.logits, \
                o.risk_score
        for i, c in enumerate(cache):
            for f, leaf in zip(c._fields, c):
                out[f"{arch}/decode/cache/{i}/{f}"] = leaf
        if arch == OPT4:
            kw = kwargs("opt4", "prefill")
            m4 = Model(variant_cfg(cfg, kw))
            o = jax.jit(lambda p, xx: m4.forward(
                p, tokens=xx, compute_dtype=f32,
                act_pspec=kw["act_pspec"]))(params, x)
            out[f"{arch}/opt4/fwd/logits"] = o.logits
            out[f"{arch}/opt4/fwd/risk"] = o.risk_score
            o, _ = jax.jit(lambda p, xx: m4.prefill(
                p, tokens=xx, cache_capacity=t + STEPS, compute_dtype=f32,
                act_pspec=kw["act_pspec"]))(params, x)
            out[f"{arch}/opt4/prefill/logits"] = o.logits
            out[f"{arch}/opt4/prefill/risk"] = o.risk_score
        variants = ["opt"] + (["opt3"] if arch == OPT3 else []) + (
            ["opt4", "a2a"] if arch == OPT4 else [])
        for variant in variants:
            kw = kwargs(variant, "train")
            tmodel = Model(variant_cfg(cfg, kw))
            opt = AdamW(learning_rate=LR)
            train = make_train_step(
                tmodel, opt, remat=kw.get("remat", True), compute_dtype=f32,
                act_pspec=kw.get("act_pspec"),
                cast_params_bf16=kw.get("cast_params_bf16", False))
            state = TrainState(params, opt.init(params))
            new, metrics = jax.jit(train)(state, x, labels)
            tag = f"{arch}/{variant}"
            out[f"{tag}/metrics"] = np.array([float(v) for v in metrics])
            for what, tree_ in (("params", new.params), ("mu", new.opt.mu),
                                ("nu", new.opt.nu)):
                for i, leaf in enumerate(jax.tree.leaves(tree_)):
                    out[f"{tag}/{what}/{i}"] = leaf
"""

VARIANT_PORT = r"""
import dataclasses
from repro_torch.launch import dryrun
from repro_torch.training.optimizer import AdamW
from repro_torch.training.train import TrainState, make_train_step
CASES, OPT3, OPT4, STEPS, LR = (%(CASES)r, %(OPT3)r, %(OPT4)r, %(STEPS)d,
                                %(LR)r)
f32 = torch.float32

def spec_json(kw):
    return {k: [list(e) if isinstance(e, tuple) else e for e in v]
            if k == "act_pspec" else v for k, v in kw.items()}

tables = {}
for name in meshes:
    axes, shape = meshes[name]
    mesh = mesh_lib.init_mesh(mesh_lib.Mesh(tuple(axes), tuple(shape)),
                              device="cpu")
    tables[name] = {f"{v}/{k}": spec_json(dryrun.variant_build_kwargs(
        v, k, mesh)) for v in ("opt", "opt2", "opt3", "opt4")
        for k in ("train", "prefill", "decode")}
    act = dryrun.variant_build_kwargs("opt", "prefill", mesh)["act_pspec"]

    def kwargs(variant):
        if variant in ("base", "a2a"):
            return {"moe_impl": "a2a"} if variant == "a2a" else {}
        return dryrun.variant_build_kwargs(variant, "train", mesh)

    def variant_cfg(cfg, kw):
        if cfg.moe is None:
            return cfg
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, ep_sharding_constraint=kw.get("moe_ep_constraint",
                                                   False),
            impl=kw.get("moe_impl", "einsum")))
    for arch in CASES:
        cfg = get_smoke_config(arch)
        model = convert.model_from_numpy(cfg, trees[arch], device="cpu",
                                         mesh=mesh, fsdp=True)
        x, labels = rows(inp["tokens"], mesh), rows(inp["labels"], mesh)
        t, cap = x.shape[1], x.shape[1] + STEPS
        tag = f"{name}/{arch}"
        for variant, spec in (("base", None), ("opt", act)):
            with coll.tally() as tl, torch.no_grad():
                o = model(x, compute_dtype=f32, act_pspec=spec)
            out[f"{tag}/{variant}/fwd/tally"] = tally_blob(tl)
            with coll.tally() as tp:
                p, cache = model.prefill(x, cache_capacity=cap,
                                         compute_dtype=f32, act_pspec=spec)
            out[f"{tag}/{variant}/prefill/tally"] = tally_blob(tp)
        out[f"{tag}/fwd/logits"] = o.logits.numpy()
        out[f"{tag}/fwd/risk"] = o.risk_score.numpy()
        out[f"{tag}/prefill/logits"] = p.logits.numpy()
        out[f"{tag}/prefill/risk"] = p.risk_score.numpy()
        for i, c in enumerate(cache):
            for f, leaf in zip(c._fields, c):
                out[f"{tag}/prefill/cache/{i}/{f}"] = leaf.clone().numpy()
        xs = rows(inp["decode_tokens"], mesh)
        ws = dryrun.variant_build_kwargs("opt", "decode", mesh)["act_pspec"]
        for s in range(STEPS):
            with coll.tally() as tl:
                o = model.decode_step(cache, xs[:, s:s + 1], pos=t + s,
                                      cache_capacity=cap, compute_dtype=f32,
                                      act_pspec=ws)
            out[f"{tag}/{s}/logits"] = o.logits.numpy()
            out[f"{tag}/{s}/risk"] = o.risk_score.numpy()
            out[f"{tag}/{s}/tally"] = tally_blob(tl)
        for i, c in enumerate(cache):
            for f, leaf in zip(c._fields, c):
                out[f"{tag}/decode/cache/{i}/{f}"] = leaf.numpy()
        if arch == OPT4:
            spec = dryrun.variant_build_kwargs("opt4", "prefill", mesh)
            model = convert.model_from_numpy(
                variant_cfg(cfg, spec), trees[arch], device="cpu",
                mesh=mesh, fsdp=True)
            with coll.tally() as tl, torch.no_grad():
                o = model(x, compute_dtype=f32, act_pspec=spec["act_pspec"])
            with coll.tally() as tp:
                p, _ = model.prefill(x, cache_capacity=cap, compute_dtype=f32,
                                     act_pspec=spec["act_pspec"])
            for what, res, t_ in (("fwd", o, tl), ("prefill", p, tp)):
                out[f"{tag}/opt4/{what}/logits"] = res.logits.numpy()
                out[f"{tag}/opt4/{what}/risk"] = res.risk_score.numpy()
                out[f"{tag}/opt4/{what}/tally"] = tally_blob(t_)
        variants = ["base", "opt"] + (["opt3"] if arch == OPT3 else []) + (
            ["opt4", "a2a"] if arch == OPT4 else [])
        for variant in variants:
            kw = kwargs(variant)
            tcfg = variant_cfg(cfg, kw)
            model = convert.model_from_numpy(tcfg, trees[arch], device="cpu",
                                             mesh=mesh, fsdp=True)
            model.requires_grad_(True)
            opt = AdamW(learning_rate=LR)
            params = dict(model.named_parameters())
            state = TrainState(params, opt.init(params))
            step = make_train_step(
                model, opt, remat=kw.get("remat", True), compute_dtype=f32,
                act_pspec=kw.get("act_pspec"),
                cast_params_bf16=kw.get("cast_params_bf16", False))
            with mesh_lib.set_mesh(mesh), coll.tally() as tl:
                state, metrics = step(state, x, labels)
            vt = f"{tag}/{variant}"
            out[f"{vt}/train/tally"] = tally_blob(tl)
            if variant == "base" and arch != OPT4:
                continue
            out[f"{vt}/metrics"] = np.array([float(v) for v in metrics])
            for what, values in (("params", None), ("mu", state.opt.mu),
                                 ("nu", state.opt.nu)):
                tree_ = convert.model_to_numpy(tcfg, model, values)
                if rank == 0:
                    for i, leaf in enumerate(leaves(tree_)):
                        out[f"{vt}/{what}/{i}"] = leaf
out["kwargs"] = np.frombuffer(json.dumps(tables).encode(), np.uint8)
"""


def variant_run(tmp: pathlib.Path, cases: tuple, opt3: str, opt4: str,
                lr: float) -> dict:
    """The reference and the four ranks over :data:`VARIANT_REFERENCE` /
    :data:`VARIANT_PORT` on the meshes of :data:`VARIANT_MESHES`."""
    fill = dict(CASES=cases, OPT3=opt3, OPT4=opt4, STEPS=STEPS, LR=lr)
    return run(tmp, VARIANT_REFERENCE % fill, VARIANT_PORT % fill,
               meshes={m: MESHES[m] for m in VARIANT_MESHES}, archs=cases)
