"""The pod dry-run (``launch/dryrun.py::run_cell(..., mesh=pod)``): one
rank of the (16, 16) and (2, 16, 16) meshes traced on meta, its
collectives counted (``launch/collectives.py``), and the roofline's
collective term (``launch/roofline.py``).

* The meta trace of one rank of the dense and MoE smoke configs' train,
  prefill and decode steps on a shape-only (2, 2) and (2, 1, 2) mesh
  counts, kind by kind, what four live gloo ranks count running the same
  steps (float32 there: gloo has no bfloat16, so the bytes differ and the
  counts are compared).
* Full-size cells: the argument bytes of a rank are
  ``argument_bytes_per_device``'s, the collective term is the trace's
  bytes (an all-reduce's twice) over one 50 GB/s NDR link a card, FSDP is
  on where the reference turns it on, and the records' names and fields;
  the 18 cells a mesh that the decode and the MoE added (every mesh of
  them on the (16, 16) mesh, a few on (2, 16, 16)) with the tally of the
  schedule: a decode step's gathers of the token's q, k and v and of
  the combine's partials and its two all-reduces a layer, a MoE layer's
  partial output and, where the batch is sharded, the gather of the data
  ranks' expert counts.
* The CLI over both meshes and the report's pod table, in a temporary
  directory.
* The committed records under ``benchmarks/results/dryrun_h100`` (every
  pod cell of both meshes): each decode and MoE prefill record's tally
  is the schedule's, so a record traced from code that has since changed
  its collectives fails here, and each record's collective term is its
  own bytes'.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_ranks as tr
from repro_torch.configs import applicable_shapes, get_smoke_config
from repro_torch.configs.shapes import SHAPES, InputShape
from repro_torch.launch import dryrun, report, roofline, specs
from repro_torch.launch import mesh as mesh_lib

POD_MESHES = {k: tr.MESHES[k] for k in ("2x2", "2x1x2")}
TRAIN = InputShape("smoke_train", tr.T, tr.B, "train")
PREFILL = InputShape("smoke_prefill", tr.T, tr.B, "prefill")
DECODE = InputShape("smoke_decode", tr.T, tr.B, "decode")
SMOKE = {"train": TRAIN, "prefill": PREFILL, "decode": DECODE}
ARCHS = tr.ARCHS + tr.MOE_ARCHS

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
                _, cache = model.prefill(
                    **{key: rows(inp[key], mesh)}, cache_capacity=%(T)d,
                    logits_mode="last", compute_dtype=torch.float32,
                    attn_impl="kernel")
            else:
                model(**{key: rows(inp[key], mesh)},
                      compute_dtype=torch.float32, attn_impl="kernel")
        out[f"{name}/{arch}/prefill"] = tally_blob(t)
        if cfg.has_decode:
            with coll.tally() as t:
                model.decode_step(
                    cache, **{key: rows(inp[key], mesh)[:, :1]},
                    pos=%(T)d - 1, cache_capacity=%(T)d,
                    compute_dtype=torch.float32, attn_impl="kernel")
            out[f"{name}/{arch}/decode"] = tally_blob(t)
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
                  POD_MESHES, archs=ARCHS)["port"]


LIVE = [(kind, arch, mesh) for kind in ("train", "prefill", "decode")
        for arch in ARCHS for mesh in POD_MESHES
        if kind != "decode" or get_smoke_config(arch).has_decode]


@pytest.mark.parametrize("kind,arch,mesh", LIVE)
def test_meta_trace_counts_what_the_live_ranks_count(live, mesh, arch,
                                                     kind):
    cfg = get_smoke_config(arch)
    bundle = specs.build_step(arch, SMOKE[kind], cfg=cfg,
                              mesh=tr.shape_mesh(mesh), fsdp=False)
    counted = dryrun.trace(bundle)["collectives"]["count_by_kind"]
    for rank in live:
        assert tr.tally(rank[f"{mesh}/{arch}/{kind}"])[1] == counted


def _run_cell(*args, **kwargs) -> dict:
    """``dryrun.run_cell`` with a deep pod rank traced at 1 and 2 groups
    (the records trace 2 and 3): the tests read counts and bytes, linear
    in the groups from the first, not the peak that needs 2 and 3."""
    count_step = dryrun.count_step
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dryrun, "count_step", lambda *a, **kw: count_step(
            *a, **{**kw, "lo": 1}))
        return dryrun.run_cell(*args, **kwargs)


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("cells")
    pod1 = mesh_lib.make_production_mesh()
    pod2 = mesh_lib.make_production_mesh(multi_pod=True)
    return out, {
        ("qwen3-8b", "train_4k", "pod1"): _run_cell(
            "qwen3-8b", "train_4k", mesh=pod1, out_dir=str(out)),
        ("llama3-405b", "train_4k", "pod1"): _run_cell(
            "llama3-405b", "train_4k", mesh=pod1, out_dir=str(out)),
        ("hubert-xlarge", "prefill_32k", "pod2"): _run_cell(
            "hubert-xlarge", "prefill_32k", mesh=pod2, out_dir=str(out)),
        ("deepseek-coder-33b", "prefill_32k", "pod2"): _run_cell(
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
    """Once the dense family's train and prefill cells (12 a mesh), then
    every shape of every model but the Mamba and xLSTM ones (30); now
    every cell of the catalog: 38 a mesh, the encoder's two and four of
    each decoder."""
    cells = dryrun.pod_cells()
    assert len(cells) == 38
    assert {a for a, _ in cells} == {
        "internlm2-1.8b", "llama3-405b", "olmoe-1b-7b", "qwen2-vl-7b",
        "hubert-xlarge", "deepseek-coder-33b", "qwen3-8b",
        "llama4-maverick-400b-a17b", "jamba-1.5-large-398b", "xlstm-1.3b"}
    for arch in {a for a, _ in cells}:
        assert [s for a, s in cells if a == arch] == list(
            applicable_shapes(arch))
    assert len(NEW_CELLS) == 18 and set(NEW_CELLS) <= set(cells)
    # the committed records: 76, 38 a mesh, one a cell
    for pod in ("pod1", "pod2"):
        assert sorted((r["arch"], r["shape"]) for r in report.load(pod)) \
            == sorted(cells)


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
    """The MoE einsum and the decode over a pod once raised here, naming
    item 13h, and then the Mamba and xLSTM mixers, naming item 13h′; now
    every shape of every family builds as one rank of the pod mesh.  The
    all-to-all MoE raised too, naming item 13g; now it builds placed,
    its experts where ``param_pspec`` puts them."""
    pod1 = mesh_lib.make_production_mesh()
    for arch in ("jamba-1.5-large-398b", "xlstm-1.3b"):
        for shape in applicable_shapes(arch):
            assert specs.build_step(arch, shape, mesh=pod1).mesh is pod1
    for arch, shape in (("olmoe-1b-7b", "train_4k"),
                        ("internlm2-1.8b", "decode_32k")):
        assert specs.build_step(arch, shape, mesh=pod1).mesh is pod1
    a2a = specs.build_step("olmoe-1b-7b", "train_4k", mesh=pod1,
                           moe_impl="a2a")
    einsum = specs.build_step("olmoe-1b-7b", "train_4k", mesh=pod1)
    assert a2a.cfg.moe.impl == "a2a" and a2a.mesh is pod1
    assert {k: tuple(p.shape) for k, p in a2a.model.named_parameters()} \
        == {k: tuple(p.shape) for k, p in einsum.model.named_parameters()}


# the cells the decode and the MoE added to each mesh
NEW_CELLS = [(a, s) for a in ("internlm2-1.8b", "llama3-405b", "olmoe-1b-7b",
                              "qwen2-vl-7b", "deepseek-coder-33b",
                              "qwen3-8b", "llama4-maverick-400b-a17b")
             for s in applicable_shapes(a)
             if a in ("olmoe-1b-7b", "llama4-maverick-400b-a17b")
             or SHAPES[s].kind == "decode"]
POD2_CELLS = [("olmoe-1b-7b", "decode_32k"), ("olmoe-1b-7b", "prefill_32k"),
              ("qwen3-8b", "long_500k"),
              ("llama4-maverick-400b-a17b", "long_500k")]
NEW_RUNS = [(a, s, "pod1") for a, s in NEW_CELLS] + [
    (a, s, "pod2") for a, s in POD2_CELLS]
# the reference's rule (the per-rank parameter bytes past 4 GiB): the
# two 400 B models everywhere, nothing else among these cells
FSDP = ("llama3-405b", "llama4-maverick-400b-a17b")


@pytest.fixture(scope="module")
def new_cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("new_cells")
    meshes = {"pod1": mesh_lib.make_production_mesh(),
              "pod2": mesh_lib.make_production_mesh(multi_pod=True)}
    return out, {(a, s, pod): _run_cell(a, s, mesh=meshes[pod],
                                        out_dir=str(out))
                 for a, s, pod in NEW_RUNS}


@pytest.mark.parametrize("arch,shape,pod", NEW_RUNS)
def test_new_pod_records_hold_the_rules(new_cells, arch, shape, pod):
    """Each decode and MoE cell: the record on disk, a rank's argument
    bytes the rules' (the decode's cache block included), FSDP where the
    reference turns it on, and the collective term of the trace's
    bytes."""
    out, recs = new_cells
    rec = recs[(arch, shape, pod)]
    assert (out / f"{arch}__{shape}__h100_{pod}.json").exists()
    assert rec["memory_analysis"]["argument_bytes"] == \
        rec["argument_bytes_per_device"]["total"]
    assert rec["fsdp"] == (arch in FSDP) == \
        rec["argument_bytes_per_device"]["fsdp"]
    rf = rec["roofline"]
    assert rf["chips"] == (256 if pod == "pod1" else 512)
    weighted = sum(v * (2.0 if k == "all-reduce" else 1.0)
                   for k, v in rec["collectives"]["bytes_by_kind"].items())
    assert rf["collective_s"] == pytest.approx(weighted / 50e9)


def test_pod_table_shows_the_decode_and_moe_cells(new_cells):
    """``report.py --pod`` renders the new records beside the dense ones:
    a decode row, a long_500k row and a MoE row of the (16, 16) mesh."""
    out, _ = new_cells
    table = report.pod_table(report.load("pod1", directory=str(out)),
                             "pod1", reference_dir=None)
    for row in ("qwen3-8b | decode_32k", "olmoe-1b-7b | long_500k",
                "llama4-maverick-400b-a17b | train_4k"):
        assert row in table, row


def _schedule(arch: str, shape: str, pod: str) -> dict | None:
    """Counts by kind of one rank's decode step or MoE prefill: the
    embedding's all-reduce (not where embeddings come in), four
    all-reduces a layer in a decode (the combine's largest logit and its
    weighted values and sums, wo, the down projection or the MoE's
    partial output, plus the shared expert's) and one gather (the
    token's q, k and v); a MoE prefill's wo, its
    partial output and the aux loss's all-reduce over each data axis, and
    the cache's two all-to-alls; where the dispatch chunk spans the data
    ranks (a decode batch over them), a gather of their expert counts
    over each data axis.  None for the train steps and FSDP'd models (a
    gather a sharded leaf a use)."""
    cfg = specs.serving_config(arch, shape)
    kind = SHAPES[shape].kind
    if arch in FSDP or kind == "train":
        return None
    n_axes = 1 if pod == "pod1" else 2
    moe = sum(1 for b in cfg.layer_pattern if b.ffn == "moe") \
        * cfg.n_groups
    shared = moe if cfg.moe is not None and cfg.moe.shared_expert else 0
    embed = 0 if cfg.embeds_input else 1
    if kind == "prefill":
        return {"all-reduce": embed + 2 * cfg.n_layers + n_axes * moe
                + shared, "all-to-all": 2 * cfg.n_layers}
    spread = SHAPES[shape].global_batch > 1 and moe
    return {"all-reduce": embed + 4 * cfg.n_layers + shared,
            "all-gather": cfg.n_layers + (n_axes * moe if spread else 0)}


@pytest.mark.parametrize("arch,shape,pod", [
    r for r in NEW_RUNS if _schedule(*r) is not None])
def test_new_pod_tallies_are_the_schedule(new_cells, arch, shape, pod):
    rec = new_cells[1][(arch, shape, pod)]
    assert rec["collectives"]["count_by_kind"] == _schedule(arch, shape,
                                                            pod)


COMMITTED = [(a, s, pod) for pod in ("pod1", "pod2") for a, s in NEW_CELLS
             if _schedule(a, s, pod) is not None]


@pytest.mark.parametrize("arch,shape,pod", COMMITTED)
def test_committed_pod_tallies_are_the_schedule(arch, shape, pod):
    rec, = [r for r in report.load(pod)
            if (r["arch"], r["shape"]) == (arch, shape)]
    assert rec["collectives"]["count_by_kind"] == _schedule(arch, shape,
                                                            pod)
    weighted = sum(v * (2.0 if k == "all-reduce" else 1.0)
                   for k, v in rec["collectives"]["bytes_by_kind"].items())
    assert rec["roofline"]["collective_s"] == pytest.approx(weighted / 50e9)


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


# ---------------------------------------------------------------------------
# the Mamba and xLSTM families' pod records
# ---------------------------------------------------------------------------

RECURRENT = ("jamba-1.5-large-398b", "xlstm-1.3b")
RECURRENT_RECORDS = [(a, s, pod) for pod in ("pod1", "pod2")
                     for a in RECURRENT for s in applicable_shapes(a)]


def _recurrent_schedule(arch: str, shape: str, pod: str) -> dict | None:
    """Counts by kind of one rank's step of jamba or xlstm-1.3b under the
    schedule of ``models/mamba.py`` and ``models/xlstm.py`` (16 ranks of
    "model"): a Mamba layer's split all-to-all and its x_proj and
    out_proj all-reduces; an sLSTM's two gathers (a prefill's of the
    weights, a decode's of h) and, decoding, its gate exchange (d_up =
    2,730 does not divide: up and down are whole); an mLSTM's gathers of
    up's output and v, the normaliser's and down's all-reduces and the
    numerator's reduce-scatter; the attention and MoE layers as
    :func:`_schedule` counts them; every FSDP'd leaf's gather over each
    data axis (one use a step).  The train step of xlstm-1.3b: each
    group's forward twice but the last mLSTM's down all-reduce (remat),
    the backward's "f" all-reduces (up's input, w_if's weight and bias,
    the normaliser) and adjoint exchanges, then the tail.  None for
    jamba's FSDP'd train step."""
    from repro_torch.launch.mesh import DATA_AXES
    from repro_torch.launch.shardings import param_pspecs
    from repro_torch.models import Model, parallel

    cfg = specs.serving_config(arch, shape)
    kind = SHAPES[shape].kind
    fsdp = arch == "jamba-1.5-large-398b"
    if kind == "train" and fsdp:
        return None
    n_axes = 1 if pod == "pod1" else 2
    mesh = mesh_lib.make_production_mesh(multi_pod=pod == "pod2")
    counts: dict[str, int] = {}

    def add(k, n=1):
        counts[k] = counts.get(k, 0) + n

    add("all-reduce")                        # the embedding
    plan = parallel.head_plan(cfg, 16, 0)
    spread = SHAPES[shape].global_batch > 1
    for spec in cfg.layer_pattern * cfg.n_groups:
        if spec.mixer == "mamba":
            add("all-to-all")
            add("all-reduce", 2)
        elif spec.mixer == "attn":
            if kind == "decode":
                add("all-gather")
                add("all-reduce", 3)
            else:
                add("all-gather", plan.gather_q + 2 * plan.gather_kv)
                add("all-reduce")
        elif spec.mixer == "slstm":
            add("all-gather", 2)
            add("all-to-all", kind == "decode")
        else:
            add("all-gather", 2)
            add("all-reduce", 2)
            add("reduce-scatter")
        if spec.ffn == "mlp":
            add("all-reduce")
        elif spec.ffn == "moe":
            add("all-reduce")
            if kind == "prefill":
                add("all-reduce", n_axes)
            elif spread:
                add("all-gather", n_axes)
    model = Model(cfg, device="meta", seed=None)
    specs_ = param_pspecs(cfg, model, mesh, fsdp=fsdp)
    data = {k: sum(1 for a in parallel.spec_axes(s) if a in DATA_AXES)
            for k, s in specs_.items()}
    add("all-gather", sum(data.values()))
    if kind == "train":
        # xlstm-1.3b: the forward above runs again in the recompute but
        # for the last mLSTM's down; the backward and the tail
        g = cfg.n_groups
        per = len(cfg.layer_pattern) - 1     # mLSTMs a group
        counts = {"all-gather": 2 * counts["all-gather"] + g * per,
                  "all-reduce": 2 * (counts["all-reduce"] - 1) - g
                  + g * per * 4 + 1 + 1 + 3 + n_axes
                  + n_axes * len(specs_) + 1,
                  "reduce-scatter": 2 * counts["reduce-scatter"]
                  + g * per * 2}
    return {k: float(v) for k, v in counts.items() if v}


@functools.cache
def _whole_step(arch: str, shape: str) -> specs.StepBundle:
    """The cell's one-card step on meta, built once for both meshes."""
    return specs.build_step(arch, shape)


@pytest.mark.parametrize("arch,shape,pod", RECURRENT_RECORDS)
def test_committed_recurrent_records(arch, shape, pod, record_property):
    """The 16 records of jamba and xlstm-1.3b: a rank's argument bytes
    the rules' (``argument_bytes_per_device``, which
    ``test_torch_shardings.py`` holds to the reference's shardings); FSDP
    where the reference turns it on (jamba's 398 B parameters); the
    collective term of the trace's bytes; the tally the schedule's; the
    80 GB verdict recorded.  The reference's GSPMD collective bytes a
    chip of the same cell are recorded beside the port's, not held."""
    rec, = [r for r in report.load(pod)
            if (r["arch"], r["shape"]) == (arch, shape)]
    assert rec["memory_analysis"]["argument_bytes"] == \
        rec["argument_bytes_per_device"]["total"]
    whole = _whole_step(arch, shape)
    mesh = mesh_lib.make_production_mesh(multi_pod=pod == "pod2")
    assert dryrun.argument_bytes_per_device(whole, mesh) == \
        rec["argument_bytes_per_device"]
    assert rec["fsdp"] == (arch == "jamba-1.5-large-398b")
    weighted = sum(v * (2.0 if k == "all-reduce" else 1.0)
                   for k, v in rec["collectives"]["bytes_by_kind"].items())
    assert rec["roofline"]["collective_s"] == pytest.approx(weighted / 50e9)
    assert isinstance(rec["fits_one_card"]["80GB"], bool)
    want = _recurrent_schedule(arch, shape, pod)
    if want is not None:
        assert rec["collectives"]["count_by_kind"] == want
    record_property("reference_gspmd_collective_bytes_per_chip",
                    report.reference_collectives(arch, shape, pod))
    record_property("port_collective_bytes_per_chip",
                    rec["roofline"]["collective_bytes_per_chip"])


# ---------------------------------------------------------------------------
# the --variant bundles' pod records (opt: train_4k and prefill_32k of both
# meshes; opt3: train_4k), beside the baseline records
# ---------------------------------------------------------------------------

OPT_RECORDS = [(a, s, pod) for pod in ("pod1", "pod2")
               for a, s in dryrun.pod_cells() if SHAPES[s].kind != "decode"]
# the weight-stationary decode: every decode cell
WS_RECORDS = [(a, s, pod) for pod in ("pod1", "pod2")
              for a, s in dryrun.pod_cells() if SHAPES[s].kind == "decode"]
# opt4: the train and prefill cells of the models with MoE blocks
OPT4_RECORDS = [(a, s, pod) for a, s, pod in OPT_RECORDS
                if a in ("olmoe-1b-7b", "llama4-maverick-400b-a17b",
                         "jamba-1.5-large-398b")]
OPT3_RECORDS = [(a, s, pod) for a, s, pod in OPT_RECORDS
                if s == "train_4k"]
UNFIT = ("llama3-405b", "jamba-1.5-large-398b", "llama4-maverick-400b-a17b")


def _record(arch: str, shape: str, pod: str, variant: str = "") -> dict:
    rec, = [r for r in report.load(pod + (f"_{variant}" if variant else ""))
            if (r["arch"], r["shape"]) == (arch, shape)]
    return rec


@functools.cache
def _placed(arch: str, pod: str, fsdp: bool = False):
    """The model of ``arch``'s train and prefill cells placed on the
    shape-only pod mesh (meta)."""
    from repro_torch.models import Model, parallel

    cfg = specs.serving_config(arch, "train_4k")
    mesh = mesh_lib.make_production_mesh(multi_pod=pod == "pod2")
    return parallel.parallelize(Model(cfg, device="meta", seed=None), mesh,
                                fsdp=fsdp)


def _sp_changes(arch: str, shape: str, pod: str) -> dict:
    """The sequence-parallel schedule's changes to a baseline rank step
    (``models/parallel.py``), counts by kind, from the placed model on the
    shape-only pod mesh: the embedding's all-reduce a reduce-scatter
    (tokens in and a vocabulary that divides); each mixer's and FFN's
    entry one all-gather over T, its closing row-parallel all-reduce a
    reduce-scatter (a MoE's shared expert's too); the heads' all-gather.
    A train step (remat) adds each group's recompute of its entries and
    row closes (the group's last close apart unless a MoE's aux loss ends
    the group), and the backward: the embedding's and every close's
    all-gather, a reduce-scatter for each entry whose "f" all-reduced
    (a MoE's two "f" for one on the router's weight: one all-reduce fewer
    all the same; a shared expert's "f" goes), each norm's all-reduce of
    its scale's gradient and the lm head's "f" a reduce-scatter."""
    from repro_torch.models import parallel

    kind = SHAPES[shape].kind
    model = _placed(arch, pod)
    cfg = model.cfg
    tokens_in = kind == "train" or not cfg.embeds_input
    vocab = model.vocab_block() is not None
    c: dict[str, int] = {}

    def add(k, n=1):
        c[k] = c.get(k, 0) + n

    def row(lin) -> bool:
        return parallel.sharded_on_model(lin, "weight", 1)

    if tokens_in and parallel.vocab_block(model.embed, "table") is not None:
        add("all-reduce", -1)
        add("reduce-scatter")
    blocks = []   # (f-entry, close kinds) of each mixer and FFN
    for block in model.stack:
        mix, spec = block.mixer, block.spec
        if spec.mixer == "attn":
            blocks.append((True, [row(mix.wo)]))
        elif spec.mixer == "mamba":
            blocks.append((parallel.sharded_on_model(mix.in_proj, "weight",
                                                     0), [row(mix.out_proj)]))
        elif spec.mixer == "mlstm":
            blocks.append((parallel.sharded_on_model(mix.up, "weight", 0),
                           [row(mix.down)]))
        else:
            blocks.append((False, [row(mix.down)]))
        if spec.ffn == "mlp":
            blocks.append((parallel.sharded_on_model(block.ffn.gate,
                                                     "weight", 0),
                           [row(block.ffn.down)]))
        elif spec.ffn == "moe":
            placed = parallel.expert_plan(block.ffn,
                                          cfg.moe.num_experts).mesh is not None
            closes = [placed]
            if block.ffn.shared is not None:
                closes.append(row(block.ffn.shared.down))
            blocks.append((placed, closes))
    for _, closes in blocks:
        add("all-gather")
        n = sum(closes)
        add("all-reduce", -n)
        add("reduce-scatter", n)
    add("all-gather")                              # the heads
    if kind != "train":
        return {k: v for k, v in c.items() if v}
    per = len(blocks) // cfg.n_groups
    ends_in_moe = cfg.layer_pattern[-1].ffn == "moe"
    for g in range(cfg.n_groups):
        group = blocks[g * per:(g + 1) * per]
        add("all-gather", len(group))
        n = sum(sum(closes) for _, closes in group)
        if not ends_in_moe:
            n -= sum(group[-1][1])
        add("all-reduce", -n)
        add("reduce-scatter", n)
    add("all-gather", 1 + sum(len(closes) for _, closes in blocks))
    f = sum(1 for entered, _ in blocks if entered)
    add("all-reduce", -f)
    add("reduce-scatter", f)
    shared = sum(1 for b in model.stack if b.spec.ffn == "moe"
                 and b.ffn.shared is not None)
    add("all-reduce", -shared)
    norms = sum(1 for _ in model.stack) + sum(
        1 for b in model.stack if b.ffn is not None) + 1
    add("all-reduce", norms)
    if vocab:
        add("all-reduce", -1)
        add("reduce-scatter")
    return {k: v for k, v in c.items() if v}


def _plus(a: dict, b: dict) -> dict:
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0) + v
    return {k: float(v) for k, v in out.items() if v}


@pytest.mark.parametrize("arch,shape,pod", OPT_RECORDS)
def test_committed_opt_records_hold_the_rules_and_the_schedule(arch, shape,
                                                               pod):
    """Each ``_opt`` record: the argument bytes a rank the rules' (the
    bundle moves no argument), FSDP as the baseline's, the collective
    term of its bytes, and its tally the baseline record's with the
    sequence-parallel schedule's changes (:func:`_sp_changes`): one
    all-gather and one reduce-scatter on "model" where the baseline has
    one all-reduce at a block's end."""
    base, rec = _record(arch, shape, pod), _record(arch, shape, pod, "opt")
    assert rec["variant"] == "opt"
    assert rec["memory_analysis"]["argument_bytes"] == \
        rec["argument_bytes_per_device"]["total"] == \
        base["argument_bytes_per_device"]["total"]
    assert rec["fsdp"] == base["fsdp"]
    weighted = sum(v * (2.0 if k == "all-reduce" else 1.0)
                   for k, v in rec["collectives"]["bytes_by_kind"].items())
    assert rec["roofline"]["collective_s"] == pytest.approx(weighted / 50e9)
    assert rec["collectives"]["count_by_kind"] == _plus(
        base["collectives"]["count_by_kind"], _sp_changes(arch, shape, pod))


@pytest.mark.parametrize("arch,shape,pod", OPT3_RECORDS)
def test_opt_train_records_hold_less_than_their_baselines(arch, shape, pod):
    """The sequence-parallel residual: each opt train_4k record's
    temporaries are below its baseline's (the remat groups keep a rank's
    block of T); the opt3 record (remat off) issues no recompute, so fewer
    all-gathers and reduce-scatters than the opt record, the same
    arguments."""
    base = _record(arch, shape, pod)
    opt, opt3 = (_record(arch, shape, pod, v) for v in ("opt", "opt3"))
    assert opt["memory_analysis"]["temp_bytes"] < \
        base["memory_analysis"]["temp_bytes"]
    assert opt3["variant"] == "opt3"
    assert opt3["memory_analysis"]["argument_bytes"] == \
        opt["memory_analysis"]["argument_bytes"]
    for kind in ("all-gather", "reduce-scatter"):
        assert opt3["collectives"]["count_by_kind"][kind] < \
            opt["collectives"]["count_by_kind"][kind]


def test_variant_cli_refuses_what_is_not_ported(tmp_path):
    """``--variant opt4`` once raised naming item 13g and the Mamba and
    xLSTM models' opt decode cells item 13i's decode half; both build
    now (their records below).  opt4 of a model without MoE blocks builds
    opt's step, its ``moe_impl`` inert; a bundle without a pod mesh
    raises; ``report.py --pod --variant`` sets the opt and opt4 records
    beside the baseline's."""
    pod1 = mesh_lib.make_production_mesh()
    kw = dryrun.variant_build_kwargs("opt4", "train", pod1)
    assert kw.pop("moe_impl") == "a2a"
    assert kw == dryrun.variant_build_kwargs("opt", "train", pod1)
    opt4 = specs.build_step("qwen3-8b", "train_4k", mesh=pod1, **{
        **kw, "moe_impl": "a2a"})
    assert opt4.cfg == specs.build_step("qwen3-8b", "train_4k", mesh=pod1,
                                        **kw).cfg
    with pytest.raises(ValueError, match="pod mesh"):
        dryrun.run_cell("qwen3-8b", "train_4k", variant="opt4",
                        out_dir=str(tmp_path))
    assert os.listdir(tmp_path) == []
    table = report.variant_table("pod1", "opt")
    assert "llama3-405b | train_4k" in table and " -> " in table
    assert "jamba-1.5-large-398b | decode_32k" in table
    table = report.variant_table("pod1", "opt4")
    assert "olmoe-1b-7b | train_4k" in table and "all-to-all" in table


# the weights a weight-stationary decode step gathers where FSDP put
# them: the recurrent mixers' that never touch the residual
# (models/mamba.py, models/xlstm.py)
WS_GATHERED = {"mamba": ("conv_w", "x_proj.weight", "dt_proj.weight",
                         "A_log"),
               "mlstm": ("wq", "wk", "wv", "w_if.weight"),
               "slstm": ("w_rec.weight",)}


def _ws_schedule(arch: str, shape: str, pod: str, fsdp: bool) -> dict:
    """Counts by kind of one rank's weight-stationary decode step
    (``parallel.ws_mesh``): the batch's tokens (or embeddings) gathered
    over each data axis where the batch is cut there; the embedding's
    all-reduce over "model" (a vocabulary that divides, tokens in); each
    block's norms over each data axis; an attention layer's q | k | v
    partials over each data axis, the token's q, k, v gathered over
    "model", the combine's two all-reduces, the output rows gathered over
    each data axis (a cut batch) and wo's all-reduce; a Mamba layer's
    in_proj partials, the (x | z) exchange over "model", x_proj's and
    out_proj's all-reduces and the rows; an mLSTM layer's up partials,
    up's columns and v gathered over "model", the normaliser's
    all-reduce, the numerator's reduce-scatter, the rows and down's
    all-reduce; an sLSTM layer's w_in partials, h gathered over "model"
    before and after the gates' exchange, the rows, up's partials and
    down's all-reduce (each row-parallel projection's only where the
    rules put its input on "model"); the recurrent mixers' gathered
    weights (:data:`WS_GATHERED`, one a data axis their spec names); an
    MLP's gate | up partials over each data axis and down over "model";
    a MoE's router partials over each data axis, its gate | up partials
    (FSDP'd on d, or whole) or x and, down not on d_ff, h gathered over
    each data axis (on d_ff), its partial output over "model", a down on
    d_ff reduce-scattered over each data axis, and a shared expert as an
    MLP; the final norm, the lm head and the score head over each data
    axis."""
    from repro_torch.models import parallel

    model = _placed(arch, pod, fsdp)
    cfg = model.cfg
    mesh = mesh_lib.make_production_mesh(multi_pod=pod == "pod2")
    n_axes = len(mesh_lib.data_axes(mesh))
    b = SHAPES[shape].global_batch
    spread = b % mesh_lib.data_axis_size(mesh) == 0
    c = {"all-reduce": 3 * n_axes, "all-gather": n_axes * spread}

    def add(k, n=1):
        c[k] = c.get(k, 0) + n

    def row(lin) -> int:
        return int(parallel.sharded_on_model(lin, "weight", 1))

    if not cfg.embeds_input and model.vocab_block() is not None:
        add("all-reduce")
    for block in model.stack:
        mix, kind = block.mixer, block.spec.mixer
        add("all-reduce", n_axes * (1 + (block.spec.ffn != "none")))
        add("all-gather", n_axes * spread)            # the output rows
        if kind == "attn":
            add("all-reduce", n_axes + 2 + row(mix.wo))
            add("all-gather")
        elif kind == "mamba":
            add("all-reduce", n_axes + row(mix.x_proj) + row(mix.out_proj))
            add("all-to-all")
        elif kind == "mlstm":
            add("all-reduce", n_axes + 1 + row(mix.down))
            add("all-gather", 2)
            add("reduce-scatter")
        else:
            add("all-reduce", 2 * n_axes + row(mix.down))
            add("all-gather", 2)
            add("all-to-all")
        for name in WS_GATHERED.get(kind, ()):
            owner, _, attr = name.rpartition(".")
            mod = mix.get_submodule(owner) if owner else mix
            add("all-gather", sum(
                1 for a in parallel.spec_axes(
                    parallel.placement(mod).specs[attr])
                if a in mesh_lib.DATA_AXES))
        mlps = [block.ffn] if block.spec.ffn == "mlp" else []
        if block.spec.ffn == "moe":
            moe = block.ffn
            up_ff = parallel.data_dim(moe, "gate") == 2
            down_ff = parallel.data_dim(moe, "down") == 1
            add("all-reduce", n_axes + (0 if up_ff else n_axes) + (
                parallel.expert_plan(moe, cfg.moe.num_experts).mesh
                is not None))
            add("all-gather", n_axes * (up_ff + (up_ff and not down_ff)))
            add("reduce-scatter", n_axes * down_ff)
            if moe.shared is not None:
                mlps.append(moe.shared)
        for mlp in mlps:
            add("all-reduce", n_axes + row(mlp.down))
    return {k: float(v) for k, v in c.items() if v}


@pytest.mark.parametrize("arch,shape,pod", WS_RECORDS)
def test_committed_opt_decode_records_gather_no_weight(arch, shape, pod):
    """Each ``_opt`` decode record (the weight-stationary layout): the
    argument bytes the rules' (the same as the baseline's: the cache
    stays batch-sharded), the collective term of its bytes, and its tally
    the hand count, which gathers no parameter over the data axes but
    the recurrent mixers' named in :data:`WS_GATHERED`: where FSDP
    gathers every weight a baseline step, its all-gather bytes are under
    1% of the baseline's (jamba's decode_32k on pod1: 0.23 of 49.82 GB;
    elsewhere the baseline gathers no weight either and the rows'
    gathers add bytes)."""
    base, rec = _record(arch, shape, pod), _record(arch, shape, pod, "opt")
    assert rec["variant"] == "opt" and rec["fsdp"] == base["fsdp"]
    assert rec["memory_analysis"]["argument_bytes"] == \
        rec["argument_bytes_per_device"]["total"] == \
        base["argument_bytes_per_device"]["total"]
    weighted = sum(v * (2.0 if k == "all-reduce" else 1.0)
                   for k, v in rec["collectives"]["bytes_by_kind"].items())
    assert rec["roofline"]["collective_s"] == pytest.approx(weighted / 50e9)
    assert rec["collectives"]["count_by_kind"] == _ws_schedule(
        arch, shape, pod, rec["fsdp"])
    if rec["fsdp"]:
        gathered = rec["collectives"]["bytes_by_kind"]["all-gather"]
        assert gathered < 0.01 * base["collectives"]["bytes_by_kind"][
            "all-gather"]


def _a2a_changes(arch: str, shape: str, pod: str, fsdp: bool) -> dict:
    """What opt4's all-to-all MoE changes in opt's counts (the
    sequence-parallel residual), from the placed model on the shape-only
    pod mesh, every MoE layer alike.

    opt's einsum layer: the entry's all-gather over T, the FSDP gathers
    of the experts' and the shared expert's weights (one a data axis
    their spec names), the data ranks' expert counts gathered over each
    data axis where a chunk spans them, the close's reduce-scatter over
    T (and the shared expert's), the aux stats over each data axis.
    opt4's layer: the exchange of each expert weight FSDP'd on d over
    each data axis of more than one rank, the dispatch and return
    all-to-alls over "model", the buffers gathered and reduce-scattered
    over each data axis, the aux stats over each data axis and "model";
    a shared expert enters and closes on its own (an all-gather over T,
    its FSDP gathers, a reduce-scatter).

    A train step adds remat's recompute (the whole group for the einsum
    layer, whose aux loss comes last; the all-to-all layer's stops before
    the shared expert's close, which follows its aux loss) and the
    backward: each all-gather's reduce-scatter and back, the exchanges
    and all-to-alls again, the aux stats' sum over the data axes and the
    router's "f" (and, for the einsum layer's and the shared expert's
    entry, the reduce-scatter of the gathered sequence's cotangent)."""
    from repro_torch.models import parallel

    kind = SHAPES[shape].kind
    model = _placed(arch, pod, fsdp)
    cfg = model.cfg
    mesh = mesh_lib.make_production_mesh(multi_pod=pod == "pod2")
    daxes = mesh_lib.data_axes(mesh)
    na, wide = len(daxes), sum(1 for a in daxes if mesh.shape[a] > 1)
    m = mesh_lib.model_axis_size(mesh)
    b, t = SHAPES[shape].global_batch, SHAPES[shape].seq_len
    rows = b // mesh_lib.data_axis_size(mesh)
    n = rows * t * mesh_lib.data_axis_size(mesh)
    spans = (rows * t) % min(4096, n) != 0

    def gathers(mod, names) -> int:
        return sum(1 for w in names for a in parallel.spec_axes(
            parallel.placement(mod).specs[w]) if a in mesh_lib.DATA_AXES)

    out: dict[str, int] = {}

    def add(k, v):
        out[k] = out.get(k, 0) + v

    for block in model.stack:
        if block.spec.ffn != "moe":
            continue
        moe = block.ffn
        g = gathers(moe, ("gate", "up", "down"))
        sh = moe.shared
        sg = 0 if sh is None else sum(gathers(lin, ("weight",))
                                      for lin in (sh.gate, sh.up, sh.down))
        s_rs = 0 if sh is None else int(parallel.sharded_on_model(
            sh.down, "weight", 1))
        s_in = int(sh is not None)
        on_d = sum(1 for w, d_dim in (("gate", 1), ("up", 1), ("down", 2))
                   if parallel.data_dim(moe, w) == d_dim)
        a2a = on_d * wide + 2 * (m > 1)
        e_f = {"all-gather": 1 + g + sg + na * spans,
               "reduce-scatter": 1 + s_rs, "all-reduce": na}
        a_f = {"all-to-all": a2a, "all-gather": na + s_in + sg,
               "reduce-scatter": na + s_rs, "all-reduce": na + 1}
        if kind == "train":
            e_b = {"reduce-scatter": 1 + g + sg, "all-gather": 1 + s_rs,
                   "all-reduce": na + 1}
            a_b = {"all-to-all": a2a, "all-gather": na + s_rs,
                   "reduce-scatter": na + s_in + sg,
                   "all-reduce": na + 1}
            a_r = dict(a_f, **{"reduce-scatter": na})
            e = [e_f, e_f, e_b]
            a = [a_f, a_r, a_b]
        else:
            e, a = [e_f], [a_f]
        for part in a:
            for k, v in part.items():
                add(k, v)
        for part in e:
            for k, v in part.items():
                add(k, -v)
    return out


@pytest.mark.parametrize("arch,shape,pod", OPT4_RECORDS)
def test_committed_opt4_records_hold_the_rules_and_the_schedule(arch, shape,
                                                                pod):
    """Each ``_opt4`` record (opt with the all-to-all MoE for train and
    prefill): the argument bytes a rank the rules' (the experts stay where
    ``param_pspec`` puts them), FSDP as the baseline's, the collective
    term of its bytes, and its tally the ``_opt`` record's with the MoE
    layers' changes (:func:`_a2a_changes`)."""
    base = _record(arch, shape, pod)
    opt, rec = (_record(arch, shape, pod, v) for v in ("opt", "opt4"))
    assert rec["variant"] == "opt4"
    assert rec["memory_analysis"]["argument_bytes"] == \
        rec["argument_bytes_per_device"]["total"] == \
        base["argument_bytes_per_device"]["total"]
    assert rec["fsdp"] == base["fsdp"]
    weighted = sum(v * (2.0 if k == "all-reduce" else 1.0)
                   for k, v in rec["collectives"]["bytes_by_kind"].items())
    assert rec["roofline"]["collective_s"] == pytest.approx(weighted / 50e9)
    assert rec["collectives"]["count_by_kind"] == _plus(
        opt["collectives"]["count_by_kind"],
        _a2a_changes(arch, shape, pod, rec["fsdp"]))
