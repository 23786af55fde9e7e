"""The port's expert-parallel MoE (``models/moe_a2a.py``) on four gloo ranks
against the reference's ``moe_forward_a2a`` on four forced host devices.

One subprocess runs the reference with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (as
``tests/test_moe_a2a.py`` does) on the meshes ("data", "model") = (2, 2),
(1, 4), (4, 1) and ("pod", "data", "model") = (2, 1, 2): outputs, aux, the
gradients of ``sum(out**2) + 0.01·aux`` and
``hlo_costs.collect_collectives`` of the compiled forward.  Four processes
run the port over gloo on the same numpy-seeded inputs and weights.  Two
capacities: drop-free (``capacity_factor = E/k``) and one that drops
pairs (1.0), where the port is held to the reference's a2a, not to the
einsum oracle.

* Outputs within rtol = atol = 2e-5, aux within rtol 1e-5.
* Gradients (router, gate, up, down, x), summed over the ranks: within
  rtol = atol = 1e-5 of the port's einsum MoE at drop-free capacity (the
  true gradient), and of the reference's a2a gradients in both cases.
  The reference's own gradients equal its einsum gradient there too.
* The tally of the per-rank body equals the reference's collectives by
  kind, bytes and counts, exactly, for all four kinds: XLA's combiner
  makes the reference's three psums an axis one tuple all-reduce, and the
  port packs the three sums into one all-reduce an axis.
* The olmoe smoke model with ``impl="a2a"`` on the (2, 2) mesh gives the
  einsum model's logits and aux.

Every subprocess runs with ``OMP_NUM_THREADS=1`` and its own time limit.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch import collectives as coll
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import moe as t_moe
from repro_torch.models import moe_a2a
from repro_torch.models.config import MoEConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"2x2": (("data", "model"), (2, 2)),
          "1x4": (("data", "model"), (1, 4)),
          "4x1": (("data", "model"), (4, 1)),
          "2x1x2": (("pod", "data", "model"), (2, 1, 2))}
D, E, K, FF, B, T = 16, 4, 2, 32, 4, 8
CASES = {"drop_free": E / K, "drops": 1.0}
OUT_TOL = dict(rtol=2e-5, atol=2e-5)     # ROADMAP's kernel rule
AUX_TOL = dict(rtol=1e-5)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
GRADS = ("router", "gate", "up", "down", "x")
TIMEOUT = 240

REFERENCE = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
import numpy as np
from repro import jax_compat
from repro.launch import hlo_costs
from repro.models import moe as moe_mod
from repro.models.config import MoEConfig
from repro.models.moe_a2a import moe_forward_a2a

tmp = sys.argv[1]
meshes = json.loads(sys.argv[2])
cases = json.loads(sys.argv[3])
inp = np.load(os.path.join(tmp, "inputs.npz"))
params = {"router": {"w": jnp.asarray(inp["router"])},
          "gate": jnp.asarray(inp["gate"]), "up": jnp.asarray(inp["up"]),
          "down": jnp.asarray(inp["down"])}
x = jnp.asarray(inp["x"])
out = {}

def grads(fwd, mo):
    def loss(p, xx):
        o, a = fwd(p, xx, mo)
        return jnp.sum(o ** 2) + 0.01 * a
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, x)
    return {"router": gp["router"]["w"], "gate": gp["gate"],
            "up": gp["up"], "down": gp["down"], "x": gx}

for case, cf in cases.items():
    mo = MoEConfig(num_experts=%(E)d, top_k=%(K)d, d_ff_expert=%(FF)d,
                   capacity_factor=cf)
    o, a = moe_mod.moe_forward(params, x, mo)
    out[f"einsum/{case}/out"], out[f"einsum/{case}/aux"] = o, a
    for k, v in grads(moe_mod.moe_forward, mo).items():
        out[f"einsum/{case}/g_{k}"] = v
    for name, (axes, shape) in meshes.items():
        mesh = jax_compat.make_mesh(tuple(shape), tuple(axes))
        with mesh, jax_compat.set_mesh(mesh):
            compiled = jax.jit(
                lambda p, xx: moe_forward_a2a(p, xx, mo)).lower(
                    params, x).compile()
            o, a = compiled(params, x)
            g = grads(moe_forward_a2a, mo)
        tag = f"a2a/{case}/{name}"
        out[f"{tag}/out"], out[f"{tag}/aux"] = o, a
        for k, v in g.items():
            out[f"{tag}/g_{k}"] = v
        c = hlo_costs.collect_collectives(compiled.as_text())
        out[f"{tag}/tally"] = np.frombuffer(json.dumps(
            [c.bytes_by_kind, c.count_by_kind]).encode(), np.uint8)
np.savez(os.path.join(tmp, "reference.npz"),
         **{k: np.asarray(v) for k, v in out.items()})
print("REFERENCE_OK")
""" % dict(E=E, K=K, FF=FF)

PORT = r"""
import dataclasses, json, os, sys, warnings
warnings.simplefilter("ignore", FutureWarning)
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs import get_smoke_config
from repro_torch.launch import collectives as coll
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.shardings import local_shard
from repro_torch.models import Model
from repro_torch.models import moe as t_moe
from repro_torch.models import moe_a2a
from repro_torch.models.config import MoEConfig

rank, tmp = int(sys.argv[1]), sys.argv[2]
meshes, cases = json.loads(sys.argv[3]), json.loads(sys.argv[4])
torch.set_num_threads(1)
dist.init_process_group(
    "gloo", store=dist.FileStore(os.path.join(tmp, "store"), 4),
    rank=rank, world_size=4)
inp = np.load(os.path.join(tmp, "inputs.npz"))
out = {}

def layer(mo):
    moe = t_moe.MoE(%(D)d, mo, device="cpu")
    with torch.no_grad():
        moe.router.weight.copy_(torch.tensor(inp["router"].T))
        for k in ("gate", "up", "down"):
            getattr(moe, k).copy_(torch.tensor(inp[k]))
    return moe.requires_grad_(True)

for name, (axes, shape) in meshes.items():
    mesh = mesh_lib.init_mesh(mesh_lib.Mesh(tuple(axes), tuple(shape)),
                              device="cpu")
    with mesh_lib.set_mesh(mesh):
        for case, cf in cases.items():
            mo = MoEConfig(num_experts=%(E)d, top_k=%(K)d,
                           d_ff_expert=%(FF)d, capacity_factor=cf)
            moe = layer(mo)
            x = torch.tensor(inp["x"], requires_grad=True)
            o, a = moe_a2a.moe_forward_a2a(moe, x, mo)
            ((o ** 2).sum() + 0.01 * a).backward()
            tag = f"{case}/{name}"
            out[f"{tag}/out"] = o.detach().numpy()
            out[f"{tag}/aux"] = a.detach().numpy()
            out[f"{tag}/g_router"] = moe.router.weight.grad.T.numpy()
            for k in ("gate", "up", "down"):
                out[f"{tag}/g_{k}"] = getattr(moe, k).grad.numpy()
            out[f"{tag}/g_x"] = x.grad.numpy()
            specs = moe_a2a.expert_specs(mesh)
            coords = mesh.coords()
            with torch.no_grad(), coll.tally() as t:
                moe_a2a.moe_a2a_local(
                    moe, local_shard(x, specs[3], mesh, coords), mo, mesh,
                    experts=tuple(local_shard(w, s, mesh, coords) for w, s
                                  in zip((moe.gate, moe.up, moe.down),
                                         specs)))
            out[f"{tag}/tally"] = np.frombuffer(json.dumps(
                [t.bytes_by_kind, t.count_by_kind]).encode(), np.uint8)
        if name == "2x2":
            # the olmoe smoke model, a2a against einsum, float32
            cfg = get_smoke_config("olmoe-1b-7b")
            tokens = torch.tensor(inp["tokens"])
            for impl in ("a2a", "einsum"):
                c = dataclasses.replace(cfg, moe=dataclasses.replace(
                    cfg.moe, impl=impl))
                lm = Model(c, device="cpu", seed=3)(
                    tokens, compute_dtype=torch.float32)
                out[f"model/{impl}/logits"] = lm.logits.detach().numpy()
                out[f"model/{impl}/aux"] = lm.moe_aux.detach().numpy()
np.savez(os.path.join(tmp, f"port{rank}.npz"), **out)
dist.destroy_process_group()
print("PORT_OK")
""" % dict(D=D, E=E, K=K, FF=FF)


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
            "GLOO_SOCKET_IFNAME": "lo"}


def _inputs(tmp: pathlib.Path) -> None:
    rng = np.random.default_rng(27)
    s, sf = 1 / np.sqrt(D), 1 / np.sqrt(FF)
    np.savez(tmp / "inputs.npz",
             router=rng.uniform(-s, s, (D, E)).astype(np.float32),
             gate=rng.uniform(-s, s, (E, D, FF)).astype(np.float32),
             up=rng.uniform(-s, s, (E, D, FF)).astype(np.float32),
             down=rng.uniform(-sf, sf, (E, FF, D)).astype(np.float32),
             x=rng.normal(0, 1, (B, T, D)).astype(np.float32),
             tokens=rng.integers(0, 512, (4, 8)))


def _finish(proc, what):
    try:
        stdout, stderr = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        stdout, stderr = proc.communicate()
    assert proc.returncode == 0 and f"{what}_OK" in stdout, (
        f"{what} rc={proc.returncode}\n{stdout[-2000:]}\n{stderr[-4000:]}")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's and the port's results: {"ref": ..., "port": [4
    ranks]}; the reference and the four ranks run at the same time."""
    tmp = tmp_path_factory.mktemp("a2a")
    _inputs(tmp)
    meshes, cases = json.dumps(MESHES), json.dumps(CASES)
    procs = [(subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(tmp), meshes, cases],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(), cwd=ROOT), "REFERENCE")]
    procs += [(subprocess.Popen(
        [sys.executable, "-c", PORT, str(r), str(tmp), meshes, cases],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(), cwd=ROOT), "PORT") for r in range(4)]
    for proc, what in procs:
        _finish(proc, what)
    return {"ref": dict(np.load(tmp / "reference.npz")),
            "port": [dict(np.load(tmp / f"port{r}.npz")) for r in range(4)],
            "inputs": dict(np.load(tmp / "inputs.npz"))}


def _summed(runs, tag, grad):
    return sum(p[f"{tag}/g_{grad}"] for p in runs["port"])


def _tally(blob):
    return json.loads(bytes(blob).decode())


CELLS = [(case, mesh) for case in CASES for mesh in MESHES]


@pytest.mark.parametrize("case,mesh", CELLS)
def test_outputs_match_reference(runs, case, mesh):
    ref = runs["ref"]
    for rank in runs["port"]:
        np.testing.assert_allclose(rank[f"{case}/{mesh}/out"],
                                   ref[f"a2a/{case}/{mesh}/out"], **OUT_TOL)
        np.testing.assert_allclose(rank[f"{case}/{mesh}/aux"],
                                   ref[f"a2a/{case}/{mesh}/aux"], **AUX_TOL)


def test_drops_case_drops_pairs_and_differs_from_the_oracle(runs):
    """With capacity factor 1.0 some (token, slot) pairs drop, so the a2a
    output (per-rank capacity) differs from the einsum oracle's."""
    ref = runs["ref"]
    for mesh in ("2x2", "1x4", "4x1", "2x1x2"):
        assert np.abs(ref[f"a2a/drops/{mesh}/out"]
                      - ref["einsum/drops/out"]).max() > 1e-3


@pytest.mark.parametrize("case,mesh", CELLS)
def test_gradients_match_reference(runs, case, mesh):
    ref = runs["ref"]
    tag = f"{case}/{mesh}"
    for grad in GRADS:
        if grad == "x":
            # every rank holds the whole gradient of the global tokens
            for rank in runs["port"]:
                np.testing.assert_allclose(rank[f"{tag}/g_x"],
                                           ref[f"a2a/{tag}/g_x"], **GRAD_TOL)
            continue
        np.testing.assert_allclose(_summed(runs, tag, grad),
                                   ref[f"a2a/{tag}/g_{grad}"], **GRAD_TOL,
                                   err_msg=grad)


def _true_gradients(inp, cf):
    """The port's einsum MoE on one process: out, aux and the gradients of
    sum(out**2) + 0.01·aux."""
    mo = MoEConfig(num_experts=E, top_k=K, d_ff_expert=FF,
                   capacity_factor=cf)
    moe = t_moe.MoE(D, mo, device="cpu")
    with torch.no_grad():
        moe.router.weight.copy_(torch.tensor(inp["router"].T))
        for k in ("gate", "up", "down"):
            getattr(moe, k).copy_(torch.tensor(inp[k]))
    moe.requires_grad_(True)
    x = torch.tensor(inp["x"], requires_grad=True)
    out, aux = t_moe.moe_forward(moe, x, mo)
    ((out ** 2).sum() + 0.01 * aux).backward()
    return {"router": moe.router.weight.grad.T.numpy(),
            "gate": moe.gate.grad.numpy(), "up": moe.up.grad.numpy(),
            "down": moe.down.grad.numpy(), "x": x.grad.numpy()}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_gradients_are_the_true_gradient(runs, mesh):
    want = _true_gradients(runs["inputs"], CASES["drop_free"])
    tag = f"drop_free/{mesh}"
    for grad in GRADS:
        got = runs["port"][0][f"{tag}/g_x"] if grad == "x" else \
            _summed(runs, tag, grad)
        np.testing.assert_allclose(got, want[grad], **GRAD_TOL,
                                   err_msg=grad)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_reference_gradient_is_its_einsum_gradient(runs, mesh):
    """The reference's ``jax.grad`` through ``shard_map(check_vma=False)``
    is its einsum MoE's gradient at drop-free capacity (no factor of a
    mesh axis): nothing for ROADMAP Queue 3."""
    ref = runs["ref"]
    for grad in GRADS:
        np.testing.assert_allclose(ref[f"a2a/drop_free/{mesh}/g_{grad}"],
                                   ref[f"einsum/drop_free/g_{grad}"],
                                   **GRAD_TOL, err_msg=grad)


@pytest.mark.parametrize("case,mesh", CELLS)
def test_tally_matches_reference_hlo(runs, case, mesh):
    want_bytes, want_counts = _tally(runs["ref"][f"a2a/{case}/{mesh}/tally"])
    for rank in runs["port"]:
        got_bytes, got_counts = _tally(rank[f"{case}/{mesh}/tally"])
        assert got_bytes == want_bytes
        assert got_counts == want_counts
    # an all-to-all over one rank is not issued (XLA drops it too)
    assert ("all-to-all" in want_bytes) == (MESHES[mesh][1][-1] > 1)


def test_model_a2a_matches_einsum(runs):
    """olmoe smoke (drop-free capacity 2.0) on the (2, 2) mesh."""
    port = runs["port"]
    for rank in port:
        np.testing.assert_allclose(rank["model/a2a/logits"],
                                   rank["model/einsum/logits"], **OUT_TOL)
        np.testing.assert_allclose(rank["model/a2a/aux"],
                                   rank["model/einsum/aux"], **AUX_TOL)


# ---------------------------------------------------------------------------
# in process: no mesh, and the dry run of one rank on meta
# ---------------------------------------------------------------------------

def test_a2a_without_an_active_mesh_raises():
    mo = MoEConfig(num_experts=E, top_k=K, d_ff_expert=FF, impl="a2a")
    moe = t_moe.MoE(D, mo, device="cpu")
    with pytest.raises(RuntimeError, match="active"):
        moe_a2a.moe_forward_a2a(moe, torch.zeros((B, T, D)), mo)
    # a mesh without a "model" axis raises too
    with mesh_lib.set_mesh(mesh_lib.Mesh(("data",), (1,))), \
            pytest.raises(RuntimeError, match="'model' axis"):
        moe_a2a.moe_forward_a2a(moe, torch.zeros((B, T, D)), mo)


def test_train_step_over_several_ranks_raises_naming_13g():
    """The a2a layer takes gradients (above), and a placed model's a2a
    MoE trains across ranks (``tests/test_torch_variant_ranks.py``: the
    baseline layout and opt4 against the reference's steps on four gloo
    ranks).  A model that is not placed, under an active mesh of several
    ranks, raises naming ``parallelize``: its a2a layer gives every rank
    the same loss, which the data-parallel mean would count once a data
    rank."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train import TrainState, make_train_step

    cfg = get_smoke_config("olmoe-1b-7b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           impl="a2a"))
    model = Model(cfg, device="cpu", seed=0).requires_grad_(True)
    opt = AdamW(learning_rate=1e-3)
    params = dict(model.named_parameters())
    step = make_train_step(model, opt)
    tokens = torch.zeros((2, 8), dtype=torch.long)
    with mesh_lib.set_mesh(mesh_lib.Mesh(("data", "model"), (2, 2))), \
            pytest.raises(ValueError, match="parallelize"):
        step(TrainState(params, opt.init(params)), tokens, tokens)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_meta_body_counts_one_rank_of_a_pod_mesh(multi_pod):
    """On meta tensors and a shape-only pod mesh the body runs without a
    process group and tallies E·cap·d per exchange: olmoe's layer at 16 x
    2,048 tokens a rank."""
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    mo = MoEConfig(num_experts=64, top_k=8, d_ff_expert=1024)
    d, bl, tl = 2048, 16, 2048
    data = mesh_lib.data_axis_size(mesh)
    moe = t_moe.MoE(d, mo, device="meta", dtype=torch.bfloat16)
    experts = (torch.empty((4, d, 1024 // data), device="meta",
                           dtype=torch.bfloat16),) * 2 + (
        torch.empty((4, 1024 // data, d), device="meta",
                    dtype=torch.bfloat16),)
    with coll.tally() as t:
        y, aux = moe_a2a.moe_a2a_local(
            moe, torch.empty((bl, tl, d), device="meta",
                             dtype=torch.bfloat16), mo, mesh,
            experts=experts)
    assert y.shape == (bl, tl, d) and aux.shape == ()
    cap = t_moe.capacity(bl * tl, mo)
    a2a = 64 * cap * d * 2                  # (16, E/16, cap, d) bf16
    axes = len(mesh.axis_names)
    # gathers over data, then pod (x16, x32); scatters over pod, then data
    gathers, scatters = ((16, 32), (16, 1)) if multi_pod else ((16,), (1,))
    assert t.count_by_kind == {"all-to-all": 2, "all-gather": axes - 1,
                               "reduce-scatter": axes - 1,
                               "all-reduce": axes}
    assert t.bytes_by_kind == {
        "all-to-all": 2 * a2a, "all-gather": a2a * sum(gathers),
        "reduce-scatter": a2a * sum(scatters),
        "all-reduce": axes * (2 * 64 + 1) * 4}
    assert t.static_count == sum(t.count_by_kind.values())
