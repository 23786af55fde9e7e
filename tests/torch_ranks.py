"""Shared by the tensor-parallel tests (``test_torch_tensor_parallel.py``,
``test_torch_train_ranks.py``, ``test_torch_pod_dryrun.py``,
``test_torch_decode_ranks.py``, ``test_torch_moe_ranks.py``): the smoke
configs chosen for their head layouts at four ranks of "model", the
meshes, numpy-seeded weights and inputs, and the runs of the port's four
gloo ranks beside one reference process, each subprocess with
``OMP_NUM_THREADS=1`` and its own time limit.  The MoE configs
(:data:`MOE_ARCHS`) have weights of their own, written where a run asks
for them.

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
MESHES = {"1x4": (("data", "model"), (1, 4)),
          "2x2": (("data", "model"), (2, 2)),
          "4x1": (("data", "model"), (4, 1)),
          "2x1x2": (("pod", "data", "model"), (2, 1, 2))}
B, T, CAP = 4, 8, 12
STEPS = 8          # decode tokens in the inputs
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
    configs 20, 21, ...) and the tokens, embeddings and labels, and the
    decode steps' tokens and embeddings."""
    from repro_torch.configs import get_smoke_config

    seeds = {**{a: 10 + i for i, a in enumerate(ARCHS)},
             **{a: 20 + i for i, a in enumerate(MOE_ARCHS)}}
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
                 np.float32))


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

