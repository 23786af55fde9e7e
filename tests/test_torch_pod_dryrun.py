"""The pod dry-run (``launch/dryrun.py::run_cell(..., mesh=pod)``): one
rank of the (16, 16) and (2, 16, 16) meshes traced on meta, its
collectives counted (``launch/collectives.py``), and the roofline's
collective term (``launch/roofline.py``).

* The meta trace of one rank of the dense smoke configs' train and
  prefill steps on a shape-only (2, 2) and (2, 1, 2) mesh counts, kind by
  kind, what four live gloo ranks count running the same steps (float32
  there: gloo has no bfloat16, so the bytes differ and the counts are
  compared).
* Full-size cells: the argument bytes of a rank are
  ``argument_bytes_per_device``'s, the collective term is the trace's
  bytes (an all-reduce's twice) over one 50 GB/s NDR link a card, FSDP is
  on where the reference turns it on, and the records' names and fields.
* The CLI over both meshes and the report's pod table, in a temporary
  directory (no test reads a file under ``benchmarks/``).
"""
import dataclasses
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
from repro_torch.launch import dryrun, report, roofline, specs
from repro_torch.launch import mesh as mesh_lib

POD_MESHES = {k: tr.MESHES[k] for k in ("2x2", "2x1x2")}
TRAIN = InputShape("smoke_train", tr.T, tr.B, "train")
PREFILL = InputShape("smoke_prefill", tr.T, tr.B, "prefill")

PORT = r"""
from repro_torch.models import Model
from repro_torch.training.optimizer import AdamW
from repro_torch.training.train import TrainState, make_train_step
for name, (axes, shape) in meshes.items():
    mesh = mesh_lib.init_mesh(mesh_lib.Mesh(tuple(axes), tuple(shape)),
                              device="cpu")
    for arch in trees:
        cfg = get_smoke_config(arch)
        key = "embeds" if cfg.embeds_input else "tokens"
        model = parallel.parallelize(Model(cfg, device="cpu", seed=0), mesh)
        with coll.tally() as t, torch.no_grad():
            if cfg.has_decode:
                model.prefill(**{key: rows(inp[key], mesh)},
                              cache_capacity=%(T)d, logits_mode="last",
                              compute_dtype=torch.float32,
                              attn_impl="kernel")
            else:
                model(**{key: rows(inp[key], mesh)},
                      compute_dtype=torch.float32, attn_impl="kernel")
        out[f"{name}/{arch}/prefill"] = tally_blob(t)
        model.requires_grad_(True)
        opt = AdamW()
        params = dict(model.named_parameters())
        step = make_train_step(model, opt, remat=True,
                               compute_dtype=torch.float32)
        with mesh_lib.set_mesh(mesh), coll.tally() as t:
            step(TrainState(params, opt.init(params)),
                 rows(inp["tokens"], mesh), rows(inp["labels"], mesh))
        out[f"{name}/{arch}/train"] = tally_blob(t)
""" % dict(T=tr.T)


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    return tr.run(tmp_path_factory.mktemp("pod"), None, PORT,
                  POD_MESHES)["port"]


@pytest.mark.parametrize("mesh", list(POD_MESHES))
@pytest.mark.parametrize("arch", tr.ARCHS)
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_meta_trace_counts_what_the_live_ranks_count(live, mesh, arch,
                                                     kind):
    cfg = get_smoke_config(arch)
    bundle = specs.build_step(arch, TRAIN if kind == "train" else PREFILL,
                              cfg=cfg, mesh=tr.shape_mesh(mesh), fsdp=False)
    counted = dryrun.trace(bundle)["collectives"]["count_by_kind"]
    for rank in live:
        assert tr.tally(rank[f"{mesh}/{arch}/{kind}"])[1] == counted


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("cells")
    pod1 = mesh_lib.make_production_mesh()
    pod2 = mesh_lib.make_production_mesh(multi_pod=True)
    return out, {
        ("qwen3-8b", "train_4k", "pod1"): dryrun.run_cell(
            "qwen3-8b", "train_4k", mesh=pod1, out_dir=str(out)),
        ("llama3-405b", "train_4k", "pod1"): dryrun.run_cell(
            "llama3-405b", "train_4k", mesh=pod1, out_dir=str(out)),
        ("hubert-xlarge", "prefill_32k", "pod2"): dryrun.run_cell(
            "hubert-xlarge", "prefill_32k", mesh=pod2, out_dir=str(out)),
        ("deepseek-coder-33b", "prefill_32k", "pod2"): dryrun.run_cell(
            "deepseek-coder-33b", "prefill_32k", mesh=pod2,
            out_dir=str(out))}


def test_pod_records_hold_the_rules_and_the_collective_term(cells):
    out, recs = cells
    for (arch, shape, pod), rec in recs.items():
        assert (out / f"{arch}__{shape}__h100_{pod}.json").exists()
        ma = rec["memory_analysis"]
        assert ma["argument_bytes"] == \
            rec["argument_bytes_per_device"]["total"]
        rf = rec["roofline"]
        assert rf["chips"] == (256 if pod == "pod1" else 512)
        weighted = sum(v * (2.0 if k == "all-reduce" else 1.0)
                       for k, v in rec["collectives"]["bytes_by_kind"]
                       .items())
        assert rf["collective_bytes_per_chip"] == pytest.approx(weighted)
        assert rf["collective_s"] == pytest.approx(weighted / 50e9)
        assert "NDR" in rf["collective_note"]
        terms = {"compute": rf["compute_s"], "memory": rf["memory_s"],
                 "collective": rf["collective_s"]}
        assert rf["bottleneck"] == max(terms, key=terms.get)
        assert rec["fits_one_card"]["resident_bytes"] == \
            ma["argument_bytes"] + ma["temp_bytes"]


def test_fsdp_where_the_reference_turns_it_on(cells):
    """llama3-405b's float32 state is past 4 GiB a rank of "model": its
    leaves are FSDP'd, gathered over "data" before use and their gradients
    reduce-scattered; qwen3-8b's is not."""
    _, recs = cells
    llama = recs[("llama3-405b", "train_4k", "pod1")]
    qwen = recs[("qwen3-8b", "train_4k", "pod1")]
    assert llama["fsdp"] and not qwen["fsdp"]
    counts = llama["collectives"]["count_by_kind"]
    assert counts["reduce-scatter"] > 126 and counts["all-gather"] > \
        counts["reduce-scatter"]


def test_unaligned_vocabulary_and_heads_on_the_pod(cells):
    """hubert's 504 units do not divide over 16 ranks: its logits are
    replicated (no vocab-parallel all-reduce of the embedding: it takes
    embeddings); deepseek's 56 heads are 3.5 a rank: q and the keys are
    gathered over "model" in each of its 62 layers."""
    _, recs = cells
    hub = recs[("hubert-xlarge", "prefill_32k", "pod2")]
    assert hub["collectives"]["count_by_kind"] == {"all-reduce": 96.0}
    ds = recs[("deepseek-coder-33b", "prefill_32k", "pod2")]
    assert ds["collectives"]["count_by_kind"] == {
        "all-reduce": 1 + 2 * 62.0, "all-gather": 3 * 62.0}


def test_pod_cells_are_the_dense_family():
    assert dryrun.pod_cells() == [
        (a, s) for a in ("internlm2-1.8b", "llama3-405b", "qwen2-vl-7b",
                         "hubert-xlarge", "deepseek-coder-33b", "qwen3-8b")
        for s in ("train_4k", "prefill_32k")]


def test_cli_both_meshes_and_the_pod_table(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "internlm2-1.8b", "--shape", "prefill_32k", "--both", "--out",
         str(tmp_path)], capture_output=True, text=True, timeout=240,
        cwd=tr.ROOT, env=tr.env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert sorted(os.listdir(tmp_path)) == [
        "internlm2-1.8b__prefill_32k__h100_pod1.json",
        "internlm2-1.8b__prefill_32k__h100_pod2.json"]
    for pod, chips in (("pod1", 256), ("pod2", 512)):
        rows = report.load(pod, directory=str(tmp_path))
        assert [r["roofline"]["chips"] for r in rows] == [chips]
        table = report.pod_table(rows, pod, reference_dir=None)
        assert "internlm2-1.8b | prefill_32k" in table and \
            "all-reduce 49x" in table


def test_other_families_and_decode_raise_naming_13h():
    pod1 = mesh_lib.make_production_mesh()
    for arch, shape in (("olmoe-1b-7b", "train_4k"),
                        ("jamba-1.5-large-398b", "prefill_32k"),
                        ("xlstm-1.3b", "train_4k"),
                        ("internlm2-1.8b", "decode_32k")):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP Queue 1 item 13h"):
            specs.build_step(arch, shape, mesh=pod1)


def test_link_is_nvlink_within_a_node_and_ndr_across():
    assert roofline.link(mesh_lib.Mesh(("data", "model"), (2, 4)))[0] == \
        roofline.NVLINK_BYTES_PER_S == 450e9
    for multi in (False, True):
        assert roofline.link(mesh_lib.make_production_mesh(
            multi_pod=multi))[0] == roofline.NDR_BYTES_PER_S == 50e9


def test_nested_tallies_each_count_and_close():
    """An inner tally counts only its own block; the outer one counts
    both blocks and goes on counting after the inner one closed; neither
    stays open."""
    from repro_torch.launch import collectives as coll

    mesh = mesh_lib.Mesh(("data", "model"), (2, 2))
    x = torch.empty((4, 8), device="meta")
    with coll.tally() as outer:
        coll.all_reduce_raw(x, mesh, "model")
        with coll.tally() as inner:
            coll.all_reduce_raw(x, mesh, "model")
        coll.all_gather_raw(x, mesh, "data", 0)
    coll.all_reduce_raw(x, mesh, "model")
    assert inner.count_by_kind == {"all-reduce": 1.0}
    assert inner.bytes_by_kind == {"all-reduce": 4.0 * 32}
    assert outer.count_by_kind == {"all-reduce": 2.0, "all-gather": 1.0}
    assert outer.bytes_by_kind == {"all-reduce": 2 * 4.0 * 32,
                                   "all-gather": 4.0 * 64}
    assert coll._TALLIES == []
