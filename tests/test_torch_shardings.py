"""The port's sharding rules (``launch/shardings.py``), production meshes
(``launch/mesh.py``) and pod-mesh specs of the dry-run
(``launch/dryrun.py::build_shardings``) against the reference's.

* Every rule case of ``tests/test_launch.py`` on the port's functions.
* Every parameter leaf of the 10 architectures' full configs (the port's
  model on meta): the port's spec in its own layout is the reference's
  ``param_pspec`` of the reference's leaf (path and shape from
  ``jax.eval_shape``) with the group entry dropped and a ``Linear``
  weight's two entries swapped, on the single-pod and multi-pod meshes,
  with and without FSDP.  The same for each decode cache leaf and
  ``cache_pspec``; the reference's functions take the port's shape-only
  mesh as their mesh (they read only ``shape`` and ``axis_names``).
* Per-device argument bytes of every dry-run cell on both pod meshes: one
  subprocess with ``--xla_force_host_platform_device_count=512`` builds
  the reference's ``build_shardings`` on its ``eval_shape`` bundles and
  sums each leaf's ``NamedSharding.shard_shape``; the port's
  ``build_shardings`` gives the same FSDP decision, the same bytes of
  every floating leaf and the same elements of every integer leaf (the
  port's tokens are int64 where the reference's are int32).
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.launch import shardings as ref_sh
from repro.launch import specs as ref_specs
from repro.models.model import Model as RefModel
from repro_torch.configs import (ARCH_IDS, SHAPES, applicable_shapes,
                                 get_smoke_config)
from repro_torch.convert import _ref_leaf
from repro_torch.launch import collectives as coll
from repro_torch.launch import dryrun, shardings, specs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.shardings import P
from repro_torch.models.model import Model

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"pod1": mesh_lib.make_production_mesh(),
          "pod2": mesh_lib.make_production_mesh(multi_pod=True)}
CELLS = [(arch, shape) for arch in ARCH_IDS
         for shape in applicable_shapes(arch)]
HOST = mesh_lib.make_host_mesh()

# tests/test_launch.py's rule cases: (function, args, kwargs, expected)
RULE_CASES = {
    "column_parallel_qkv": ("param", ("stack/0/0/mixer/wq/w/",
                                      (24, 4096, 4096), 16), {},
                            (None, None, "model")),
    "row_parallel_wo": ("param", ("stack/0/0/mixer/wo/w/",
                                  (24, 4096, 4096), 16), {},
                        (None, "model", None)),
    "replicate_when_not_divisible": ("param", ("stack/0/0/mixer/wq/w/",
                                               (24, 100, 100), 16), {},
                                     (None, None, None)),
    "moe_expert_parallel": ("param", ("stack/0/1/ffn/gate/",
                                      (24, 64, 2048, 1024), 16), {},
                            (None, "model", None, None)),
    "shared_expert_not_expert_sharded": (
        "param", ("stack/0/1/ffn/shared/gate/w/", (24, 5120, 8192), 16), {},
        (None, None, "model")),
    "norms_replicated": ("param", ("stack/0/0/mixer_norm/scale/",
                                   (24, 4096), 16), {}, (None, None)),
    "fsdp_adds_data_axis": ("param", ("stack/0/0/mixer/wq/w/",
                                      (126, 16384, 16384), 16),
                            dict(fsdp_axes=("data",), fsdp_size=16),
                            (None, "data", "model")),
    "embedding_vocab_sharded": ("param", ("embed/table/", (92544, 2048), 16),
                                {}, ("model", None)),
    "embedding_hubert_vocab_replicated": ("param", ("embed/table/",
                                                    (504, 1280), 16), {},
                                          (None, None)),
    "cache_kv_seq_on_model": ("cache", ("cache/0/k/",
                                        (24, 128, 32768, 8, 128), 128, HOST),
                              {}, None),
}


@pytest.mark.parametrize("case", list(RULE_CASES))
def test_rule_cases_of_the_reference(case):
    kind, args, kwargs, want = RULE_CASES[case]
    if kind == "param":
        got = shardings.param_pspec(*args, **kwargs)
        assert got == want
        assert got == tuple(ref_sh.param_pspec(*args, **kwargs))
        return
    got = shardings.cache_pspec(*args)
    assert got[2] == "model"
    assert got == tuple(ref_sh.cache_pspec(*args))


# ---------------------------------------------------------------------------
# every leaf of every full config
# ---------------------------------------------------------------------------

_MODELS: dict = {}


def _models(arch):
    """(the port's model on meta, the reference's abstract leaves by path
    string), built once an architecture."""
    if arch not in _MODELS:
        from repro_torch.configs import get_config
        cfg = get_config(arch)
        model = Model(cfg, device="meta", dtype=torch.bfloat16, seed=None)
        tree = jax.eval_shape(lambda: RefModel(ref_config(arch)).init(
            jax.random.key(0), dtype=jnp.bfloat16))
        leaves = {ref_sh._path_str(p): leaf.shape for p, leaf in
                  jax.tree_util.tree_flatten_with_path(tree)[0]}
        _MODELS[arch] = (cfg, model, leaves)
    return _MODELS[arch]


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("pod", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, pod, fsdp):
    cfg, model, leaves = _models(arch)
    mesh = MESHES[pod]
    got = shardings.param_pspecs(cfg, model, mesh, fsdp=fsdp)
    faxes = mesh_lib.data_axes(mesh) if fsdp else ()
    fsize = mesh_lib.data_axis_size(mesh) if fsdp else 1
    seen, misfired = set(), set()
    for name, p in model.named_parameters():
        path, g, transpose = _ref_leaf(cfg, model, name)
        key = shardings.path_str(path)
        shape = leaves[key]
        seen.add(key)
        want = list(ref_sh.param_pspec(key, shape, 16, fsdp_axes=faxes,
                                       fsdp_size=fsize))
        if g is not None and want[0] is not None:
            # the reference's fault (next tests): its expert rule shards
            # the layer axis of a dense MLP's stacked weight; the port
            # keeps the rule the reference gives that layer's own weight
            assert key.endswith("/w/") and "/ffn/" in key, key
            want = [None] + list(ref_sh.param_pspec(
                key, shape[1:], 16, fsdp_axes=faxes, fsdp_size=fsize))
            misfired.add(key)
        if g is not None:
            assert want[0] is None, (name, want)
            want = want[1:]
        if transpose:
            want = want[::-1]
        assert got[name] == tuple(want), name
        assert shardings.shard_shape(p.shape, got[name], mesh)
    assert seen == set(leaves)
    # hubert's 48 layers are the only full config the fault reaches
    assert bool(misfired) == (arch == "hubert-xlarge"), misfired


@pytest.mark.parametrize("pod", list(MESHES))
@pytest.mark.parametrize("arch,shape", [
    (a, s) for a, s in CELLS if SHAPES[s].kind == "decode"])
def test_cache_specs_match_reference(arch, shape, pod):
    """The port names a KV leaf ``i/k/``; the reference's own path is
    ``i/.k/``, so its KV rule never fires and its state rule decides,
    which gives the same spec on every full config (the sequence is the
    largest inner dim): see the next test."""
    mesh = MESHES[pod]
    b, t = SHAPES[shape].global_batch, SHAPES[shape].seq_len
    cfg = specs.serving_config(arch, shape)
    cache = Model(cfg, device="meta", dtype=torch.bfloat16,
                  seed=None).init_cache(b, t)
    got = shardings.cache_pspecs(cache, b, mesh)
    ref_cache = ref_specs._abstract_cache(
        RefModel(ref_specs.serving_config(arch, shape)), b, t)
    want = [tuple(ref_sh.cache_pspec(ref_sh._path_str(p), leaf.shape, b,
                                     mesh))
            for p, leaf in jax.tree_util.tree_flatten_with_path(
                ref_cache)[0]]
    assert [s for state in got for s in state] == want


def test_reference_expert_rule_shards_a_dense_mlps_layer_axis():
    """A reference fault (ROADMAP Queue 3): ``param_pspec``'s expert rule
    matches any ``/ffn/gate/`` leaf of three dims, so hubert-xlarge's
    stacked dense MLP weight (48 layers, d 1,280, ff 5,120) gets its layer
    axis on "model" where the column-parallel rule was meant.  The
    per-rank bytes are the same (48 and 5,120 both divide by 16)."""
    path, shape = "stack/0/ffn/gate/w/", (48, 1280, 5120)
    assert tuple(ref_sh.param_pspec(path, shape, 16)) == \
        ("model", None, None)
    assert shardings.param_pspec(path, shape, 16) == (None, None, "model")
    # a MoE's experts (no Linear: no "w/") keep the expert rule
    assert shardings.param_pspec("stack/0/ffn/gate/", (2, 64, 2048, 1024),
                                 16) == (None, "model", None, None)


def test_reference_kv_rule_misses_its_own_cache_paths():
    """A reference fault (ROADMAP Queue 3): ``cache_pspec``'s KV rule looks
    for ``/k/``, but ``_path_str`` writes a NamedTuple field as ``.k``.  On
    a cache whose sequence is not its largest inner dim the two differ."""
    shape = (2, 32, 16, 8, 128)              # (G, B, S, Hkv, D)
    real = ref_sh.cache_pspec("0/.k/", shape, 32, MESHES["pod1"])
    meant = ref_sh.cache_pspec("0/k/", shape, 32, MESHES["pod1"])
    assert tuple(meant) == (None, "data", "model", None, None)
    assert tuple(real) == (None, "data", None, None, "model")
    assert shardings.cache_pspec("0/k/", shape, 32, MESHES["pod1"]) == \
        tuple(meant)


# ---------------------------------------------------------------------------
# per-device argument bytes on the pod meshes
# ---------------------------------------------------------------------------

REFERENCE = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax, numpy as np
from repro.configs import ARCH_IDS, applicable_shapes
from repro.launch import dryrun, specs
from repro.launch import mesh as mesh_lib

out = {}
meshes = {"pod1": mesh_lib.make_production_mesh(multi_pod=False),
          "pod2": mesh_lib.make_production_mesh(multi_pod=True)}
for arch in ARCH_IDS:
    for shape in applicable_shapes(arch):
        bundle = specs.build_step(arch, shape)
        if bundle.kind == "prefill":
            # only the arguments' shardings are read: the outputs'
            # shapes stand in for build_shardings' trace of the step
            b, t = bundle.shape.global_batch, bundle.shape.seq_len
            sds = jax.ShapeDtypeStruct
            outs = {"logits": sds((b, 1, bundle.cfg.vocab_size),
                                  jax.numpy.bfloat16),
                    "risk_score": sds((b,), jax.numpy.float32)}
            if bundle.cfg.has_decode:
                outs["cache"] = specs._abstract_cache(bundle.model, b, t)
            bundle = dataclasses.replace(bundle,
                                         step_fn=lambda *a, o=outs: o)
        for pod, mesh in meshes.items():
            in_sh, _, fsdp = dryrun.build_shardings(bundle, mesh)
            args = []
            for arg, sh in zip(bundle.abstract_args, in_sh):
                floats = ints = 0
                for leaf, s in zip(jax.tree.leaves(arg), jax.tree.leaves(
                        sh, is_leaf=lambda x: hasattr(x, "shard_shape"))):
                    n = int(np.prod(s.shard_shape(leaf.shape)))
                    if np.issubdtype(leaf.dtype, np.integer):
                        ints += n
                    else:
                        floats += n * leaf.dtype.itemsize
                args.append([floats, ints])
            out[f"{arch}/{shape}/{pod}"] = {"fsdp": fsdp, "args": args}
print("BYTES " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_bytes():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", REFERENCE],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=300)
    line = [x for x in proc.stdout.splitlines() if x.startswith("BYTES ")]
    assert proc.returncode == 0 and line, proc.stderr[-4000:]
    return json.loads(line[0][len("BYTES "):])


def _floats_ints(arg, spec, mesh) -> list[int]:
    floats = ints = 0
    for t, s in shardings._pairs(arg, spec):
        n = int(np.prod(shardings.shard_shape(t.shape, s, mesh)))
        if t.dtype.is_floating_point:
            floats += n * t.element_size()
        else:
            ints += n
    return [floats, ints]


@pytest.mark.parametrize("pod", list(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_argument_bytes_per_device_match_reference(reference_bytes, arch,
                                                   shape, pod):
    want = reference_bytes[f"{arch}/{shape}/{pod}"]
    mesh = MESHES[pod]
    bundle = specs.build_step(arch, shape)
    in_sh, out_sh, fsdp = dryrun.build_shardings(bundle, mesh)
    assert fsdp == want["fsdp"]
    got = [_floats_ints(a, s, mesh)
           for a, s in zip(bundle.abstract_args, in_sh)]
    if bundle.kind == "decode":
        # the reference passes the position as an int32 array, the port as
        # a Python int
        assert want["args"][3] == [0, 1] and got[3] == [0, 0]
        got, want["args"] = got[:3], want["args"][:3]
    assert got == want["args"]
    per_rank = dryrun.argument_bytes_per_device(bundle, mesh)
    assert per_rank["fsdp"] == fsdp
    assert per_rank["total"] == sum(per_rank["by_argument"])
    assert per_rank["total"] >= sum(f for f, _ in got)
    if bundle.kind != "train":
        assert out_sh["logits"][-1] == "model" or \
            bundle.cfg.vocab_size % 16
        assert ("cache" in out_sh) == bundle.cfg.has_decode


# ---------------------------------------------------------------------------
# the meshes, a rank's shard, the dry-run's refusals
# ---------------------------------------------------------------------------

def test_production_meshes():
    pod1, pod2 = MESHES["pod1"], MESHES["pod2"]
    assert pod1.shape == {"data": 16, "model": 16} and pod1.size == 256
    assert pod2.shape == {"pod": 2, "data": 16, "model": 16}
    assert pod2.size == 512
    assert HOST.shape == {"data": 1, "model": 1}
    assert mesh_lib.data_axes(pod2) == ("pod", "data")
    assert (mesh_lib.model_axis_size(pod2), mesh_lib.data_axis_size(pod2)) \
        == (16, 32)
    assert not pod1.live and pod1.coords() == {"data": 0, "model": 0}
    with pytest.raises(RuntimeError, match="shape-only"):
        pod1.group("model")
    with pytest.raises(RuntimeError, match="init_process_group"):
        mesh_lib.init_mesh(HOST, device="cpu")
    assert mesh_lib.get_active_mesh() is None
    with mesh_lib.set_mesh(pod2):
        assert mesh_lib.get_active_mesh() is pod2
    assert mesh_lib.get_active_mesh() is None


def test_local_shards_tile_the_tensor():
    """Over ("pod", "data", "model") = (2, 1, 2) the blocks of every rank
    cover the tensor once, the data axes row-major (pod slowest)."""
    mesh = mesh_lib.Mesh(("pod", "data", "model"), (2, 1, 2))
    x = torch.arange(4 * 6 * 3).reshape(4, 6, 3)
    spec = P(("pod", "data"), "model", None)
    assert shardings.shard_shape(x.shape, spec, mesh) == (2, 3, 3)
    seen = torch.zeros_like(x)
    for p in range(2):
        for m in range(2):
            block = shardings.local_shard(
                x, spec, mesh, {"pod": p, "data": 0, "model": m})
            assert torch.equal(block, x[2 * p:2 * p + 2, 3 * m:3 * m + 3])
            seen[2 * p:2 * p + 2, 3 * m:3 * m + 3] += 1
    assert bool((seen == 1).all())
    with pytest.raises(ValueError, match="divide"):
        shardings.shard_shape((5, 6, 3), spec, mesh)


def test_pod_mesh_dry_run_and_roofline_raise_naming_13f(tmp_path):
    """Once both raised (item 13f); now the dense family's prefill traces
    as one rank of the pod mesh, its argument bytes the rules', and its
    roofline has a collective term.  Decode over a pod and the MoE
    einsum run too since item 13h's first half, and the Mamba and xLSTM
    families since item 13h′: their decode cells trace as one rank too,
    the rank's block of the recurrent states among its arguments."""
    rec = dryrun.run_cell("qwen3-8b", "prefill_32k", mesh=MESHES["pod1"],
                          out_dir=str(tmp_path))
    assert rec["memory_analysis"]["argument_bytes"] == \
        rec["argument_bytes_per_device"]["total"]
    assert rec["roofline"]["chips"] == 256
    assert rec["roofline"]["collective_s"] > 0
    assert (tmp_path / "qwen3-8b__prefill_32k__h100_pod1.json").exists()
    for arch, shape in (("jamba-1.5-large-398b", "decode_32k"),
                        ("xlstm-1.3b", "decode_32k")):
        rec = dryrun.run_cell(arch, shape, mesh=MESHES["pod1"],
                              out_dir=str(tmp_path))
        assert rec["memory_analysis"]["argument_bytes"] == \
            rec["argument_bytes_per_device"]["total"]
        assert rec["roofline"]["collective_s"] > 0


def test_a2a_step_traces_on_meta_under_the_host_mesh():
    """``moe_impl="a2a"`` builds (olmoe smoke at 2 x 16 tokens): its
    prefill traces on meta under the shape-only host mesh, each MoE layer
    issuing the body's gather, scatter and two packed all-reduces (no
    all-to-all over one rank) and two gathers of its output tokens."""
    cfg = get_smoke_config("olmoe-1b-7b")
    shape = dataclasses.replace(SHAPES["prefill_32k"], seq_len=16,
                                global_batch=2)
    bundle = specs.build_step("olmoe-1b-7b", shape, cfg=cfg,
                              moe_impl="a2a")
    assert bundle.cfg.moe.impl == "a2a"
    with pytest.raises(RuntimeError, match="active"):
        dryrun.trace(bundle)
    with mesh_lib.set_mesh(HOST), coll.tally() as t:
        counts = dryrun.trace(bundle)
    layers = cfg.n_layers
    assert t.count_by_kind == {"all-gather": 3 * layers,
                               "reduce-scatter": layers,
                               "all-reduce": 2 * layers}
    assert counts["flops"] > 0
