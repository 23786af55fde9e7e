"""The Mamba mixer under the production rules (``models/mamba.py`` on a
model sharded by ``models/parallel.py``) on four gloo ranks against the
reference's ``Model`` on one device: the jamba smoke config (a Mamba
block with an MLP, an attention block with an einsum MoE) on the meshes
(1, 4), (2, 2), (4, 1) and ("pod", "data", "model") = (2, 1, 2), and
once more on (2, 2) with FSDP on (``tests/torch_ranks.py``'s recurrent
runs).

* Forward, prefill and 8 decode steps: logits (a rank's rows, its block
  of the vocabulary) and risk within rtol = atol = 2e-5 of the
  reference's; each rank's block of every cache leaf (the conv tail and
  SSM state on their d_inner block, the KV cache on its slots) its slice
  of the reference's under ``cache_pspec``, after the prefill and after
  the last step.
* One train step (remat, float32, AdamW): loss, ce, aux and grad norm
  within rtol 1e-5; moments within 2e-5 of each leaf's largest, the
  parameters where |g| is clear; each rank's state bytes the rules'.
* Every tally equals the hand count of the schedule (a Mamba layer: the
  split all-to-all of xz, no gather of it; the all-reduces of x_proj and
  out_proj), and the meta trace of the same steps counts what the live
  ranks count; the reference's GSPMD forward tally is recorded beside it.
* In process: the x / z exchange plan for m in {1, 2, 4, 8, 16} on the
  full config's d_inner against a brute-force map of the columns, the
  layouts it refuses, and the placed model at one rank bitwise the whole
  model's.
"""
import json

import numpy as np
import pytest
import torch

import torch_ranks as tr
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import collectives as coll
from repro_torch.launch import dryrun, specs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import DATA_AXES
from repro_torch.models import Model, parallel
from repro_torch.models.mamba import dt_rank_of

TOL = dict(rtol=2e-5, atol=2e-5)
METRIC_RTOL, LEAF_TOL, LR = 1e-5, 2e-5, 1e-3
JAMBA = "jamba-1.5-large-398b"
CASES = {JAMBA: (JAMBA, "", JAMBA)}
RUNS = [(run, case) for run in tr.RECURRENT_RUNS for case in CASES]
KEYS = ["fwd", "prefill"] + [str(s) for s in range(tr.STEPS)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return tr.recurrent_run(tmp_path_factory.mktemp("mamba"), CASES, LR)


@pytest.mark.parametrize("run,case", RUNS)
def test_outputs_match_reference(runs, run, case):
    tr.check_outputs(runs, run, case, get_smoke_config(CASES[case][0]),
                     KEYS, TOL)


@pytest.mark.parametrize("what", ["prefill", "decode"])
@pytest.mark.parametrize("run,case", RUNS)
def test_rank_cache_is_its_slice_of_the_reference(runs, run, case, what):
    tr.check_cache(runs, run, case, what, TOL)


@pytest.mark.parametrize("run,case", RUNS)
def test_train_step_matches_reference(runs, run, case):
    tr.check_train(runs, run, case, METRIC_RTOL, LEAF_TOL)


@pytest.mark.parametrize("run,case", RUNS)
def test_rank_state_bytes_are_the_rules(runs, run, case):
    arch = CASES[case][0]
    bundle = specs.build_step(arch, InputShape("smoke", tr.T, tr.B,
                                               "train"),
                              cfg=get_smoke_config(arch))
    want = dryrun.argument_bytes_per_device(
        bundle, tr.shape_mesh(run.split("_")[0]),
        fsdp=run.endswith("_fsdp"))
    for port in runs["port"]:
        assert int(port[f"{run}/{case}/state_bytes"]) == \
            want["by_argument"][0] - 4      # less the step counter


def _sizes(run: str):
    mesh = tr.shape_mesh(run.split("_")[0])
    m = mesh.shape["model"]
    daxes = [a for a in mesh.axis_names if a in DATA_AXES]
    return mesh, m, daxes, mesh.size // m


def schedule(run: str, what: str) -> tr.Tally:
    """Bytes and counts by kind of one rank's float32 forward, prefill or
    decode step of the jamba smoke config.  A Mamba layer: the split
    all-to-all of its two pieces of xz (none over one rank), the
    all-reduce of x_proj's (dt_rank + 2N) output and out_proj's; its MLP's
    down projection.  The attention layer as ``test_torch_decode_ranks``
    / ``test_torch_moe_ranks`` count it (the q / kv gathers of
    ``head_plan``, the prefill cache's all-to-alls, the decode's gather
    and combine), wo, the MoE's partial output, its aux loss's
    all-reduces and the data ranks' expert counts.  FSDP: one gather over
    each data axis a sharded leaf."""
    cfg = get_smoke_config(JAMBA)
    mesh, m, daxes, n_data = _sizes(run)
    bl = tr.B // n_data
    t = 1 if what == "decode" else tr.T
    cap = tr.T + tr.STEPS
    d, hd, hq, hkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    d_in = cfg.mamba.expand * d
    xproj = dt_rank_of(d, cfg.mamba) + 2 * cfg.mamba.d_state
    e = cfg.moe.num_experts
    act = bl * t * d * 4
    plan = parallel.head_plan(cfg, m, 0)
    out = tr.Tally()
    out.add("all-reduce", 1, act)                   # the embedding
    for spec in cfg.layer_pattern * cfg.n_groups:
        if spec.mixer == "mamba":
            if m > 1:
                out.add("all-to-all", 1, 2 * bl * t * d_in // m * 4)
            out.add("all-reduce", 1, bl * t * xproj * 4)
        elif what == "decode":
            out.add("all-gather", 1, bl * (hq + 2 * hkv) * hd * 4)
            out.add("all-reduce", 1, bl * hq * 4)
            out.add("all-reduce", 1, bl * hq * (hd + 1) * 4)
        else:
            out.add("all-gather", plan.gather_q, act * hq * hd // d)
            out.add("all-gather", 2 * plan.gather_kv, act * hkv * hd // d)
            if what == "prefill" and not plan.gather_kv and m > 1:
                out.add("all-to-all", 2, bl * cap * hkv * hd * 4 // m)
        out.add("all-reduce", 1, act)               # out_proj / wo
        out.add("all-reduce", 1, act)               # down / the experts
        if spec.ffn == "moe" and n_data > 1:
            if what != "decode":
                out.add("all-reduce", len(daxes), 2 * e * 4)
            gathered = 1
            for a in reversed(daxes):
                gathered *= mesh.shape[a]
                out.add("all-gather", 1, gathered * e * 4)
    n, nbytes = tr.fsdp_gathers(cfg, run, "")
    if n:
        out.counts["all-gather"] = out.counts.get("all-gather", 0) + n
        out.bytes["all-gather"] = out.bytes.get("all-gather", 0) + nbytes
    return out


def train_schedule(run: str) -> dict:
    """Counts by kind of one rank's train step (remat, float32).  The
    remat group ends in the MoE layer, whose aux loss saves f and p, so
    the recompute runs the whole group again: its forward collectives
    count twice.  The backward adds the Mamba layer's "f" all-reduces
    (in_proj's input, x_proj's output, the replicated dt_bias narrowed to
    the rank's channels) and the reverse all-to-all, the MLP's and
    attention's "f", the MoE's two (its input and gates, and the aux
    loss's adjoint over each data axis) and the gathers'
    reduce-scatters; then the tail of ``torch_ranks.train_tail``."""
    cfg = get_smoke_config(JAMBA)
    _, m, daxes, n_data = _sizes(run)
    plan = parallel.head_plan(cfg, m, 0)
    counts, fsdp_ag, fsdp_rs = tr.train_tail(cfg, run)
    counts["all-gather"] += 2 * fsdp_ag
    counts["reduce-scatter"] += fsdp_rs
    a2a = 0
    for spec in cfg.layer_pattern * cfg.n_groups:
        if spec.mixer == "mamba":
            fwd, bwd = 3, 3 + 1
            a2a += 3 * (m > 1)
        else:
            fwd, bwd = 2, 1 + 2
            counts["all-gather"] += 2 * (plan.gather_q + 2 * plan.gather_kv)
            counts["reduce-scatter"] += plan.gather_q + 2 * plan.gather_kv
            if n_data > 1:
                fwd, bwd = fwd + len(daxes), bwd + len(daxes)
                counts["all-gather"] += 2 * len(daxes)
        counts["all-reduce"] += 2 * fwd + bwd
    counts["all-to-all"] = a2a
    return {k: v for k, v in counts.items() if v}


@pytest.mark.parametrize("run,case", RUNS)
def test_tally_is_the_schedule(runs, run, case, record_property):
    for what, keys in (("fwd", ["fwd"]), ("prefill", ["prefill"]),
                       ("decode", [str(s) for s in range(tr.STEPS)])):
        want = schedule(run, what)
        for port in runs["port"]:
            for key in keys:
                got = tr.tally(port[f"{run}/{case}/{key}/tally"])
                assert got == (want.bytes, want.counts), (what, got)
    want = train_schedule(run)
    for port in runs["port"]:
        assert tr.tally(port[f"{run}/{case}/train/tally"])[1] == want
    hlo = runs["ref"].get(f"{case}/{run.split('_')[0]}/hlo")
    if hlo is not None and not run.endswith("_fsdp"):
        hlo_bytes, hlo_counts = tr.tally(hlo)
        record_property("reference_hlo_collectives", json.dumps(
            {"bytes": hlo_bytes, "counts": hlo_counts}))


SMOKE = {k: InputShape(f"smoke_{k}", tr.T, tr.B, k)
         for k in ("train", "prefill", "decode")}


@pytest.mark.parametrize("kind", list(SMOKE))
@pytest.mark.parametrize("run", tr.RECURRENT_RUNS)
def test_meta_trace_counts_what_the_live_ranks_count(runs, run, kind):
    """The pod dry-run's meta trace of one rank (``specs.build_step`` on
    the shape-only mesh) counts, kind by kind, what the live ranks
    count."""
    cfg = get_smoke_config(JAMBA)
    bundle = specs.build_step(JAMBA, SMOKE[kind], cfg=cfg,
                              mesh=tr.shape_mesh(run.split("_")[0]),
                              fsdp=run.endswith("_fsdp"))
    counted = dryrun.trace(bundle)["collectives"]["count_by_kind"]
    key = {"train": "train", "prefill": "prefill", "decode": "0"}[kind]
    for port in runs["port"]:
        assert tr.tally(port[f"{run}/{JAMBA}/{key}/tally"])[1] == counted


# ---------------------------------------------------------------------------
# in process
# ---------------------------------------------------------------------------

def brute_force_exchange(parts: int, width: int, m: int) -> list[list]:
    """Each rank's column indices of the (parts x width) projection after
    the exchange the plans describe, by moving the columns themselves: a
    rank's column block cut in pieces, each piece sent by the plan's
    order and splits, the received pieces in rank order."""
    cols = np.arange(parts * width).reshape(m, -1)   # the rank's block
    plans = [parallel.gate_plan(parts, width, m, r) for r in range(m)]
    sent = []
    for r, p in enumerate(plans):
        pieces = cols[r].reshape(len(p.pieces), -1)[list(p.order)]
        out, i = [], 0
        for j in range(m):
            out.append(pieces[i:i + p.send[j]])
            i += p.send[j]
        sent.append(out)
    got = []
    for r, p in enumerate(plans):
        recv = [sent[j][r] for j in range(m)]
        assert [len(a) for a in recv] == list(p.recv)
        got.append(np.concatenate(recv))
    return got


@pytest.mark.parametrize("m", [1, 2, 4, 8, 16])
def test_xz_exchange_plan_against_brute_force(m):
    """On the full jamba's d_inner (16,384; in_proj 32,768 columns): rank
    r's column block is channel blocks 2r and 2r + 1 of (x | z), each
    owned by the rank whose channels they are (at 16 ranks 0-7 hold only
    x, 8-15 only z); after the split all-to-all rank r holds x's channel
    block r and z's, in that order, and sends and receives two pieces."""
    cfg = get_config(JAMBA)
    d_in = cfg.mamba.expand * cfg.d_model
    c = d_in // m
    got = brute_force_exchange(2, d_in, m)
    for r in range(m):
        plan = parallel.gate_plan(2, d_in, m, r)
        assert plan.channels == (r * c, c)
        assert [b for _, b in plan.pieces] == [(2 * r) % m, (2 * r + 1) % m]
        assert sum(plan.send) == sum(plan.recv) == 2
        want = np.concatenate([np.arange(r * c, (r + 1) * c),
                               d_in + np.arange(r * c, (r + 1) * c)])
        np.testing.assert_array_equal(got[r].ravel(), want)
    if m == 16:
        assert {p for r in range(8)
                for p, _ in parallel.gate_plan(2, d_in, m, r).pieces} == {0}
        assert {p for r in range(8, 16)
                for p, _ in parallel.gate_plan(2, d_in, m, r).pieces} == {1}


def test_exchange_plans_refuse_and_fall_back():
    """Columns that divide where the channels do not raise (12 channels,
    24 columns over 8 ranks: a block of 3 columns ends inside a channel
    block); columns that do not divide keep the mixer whole (None); an
    odd m sorts a rank's pieces by their owner."""
    with pytest.raises(ValueError, match="channels do not"):
        parallel.gate_plan(2, 12, 8, 0, "x")
    assert parallel.gate_plan(2, 12, 5, 0) is None
    p = parallel.gate_plan(2, 12, 3, 1)
    assert p.pieces == ((0, 2), (1, 0)) and p.order == (1, 0)
    got = brute_force_exchange(2, 12, 3)
    np.testing.assert_array_equal(got[1].ravel(), [4, 5, 6, 7, 16, 17, 18,
                                                   19])


@pytest.fixture
def world_of_one(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield mesh_lib.init_mesh(mesh_lib.make_host_mesh(), device="cpu")
    finally:
        dist.destroy_process_group()


def test_one_rank_is_the_whole_model(world_of_one):
    """At one rank the placed jamba smoke (the chunk at one rank: its
    pieces are its own, no all-to-all) is the whole model to the last
    bit: forward, prefill (every cache leaf) and decode steps."""
    cfg = get_smoke_config(JAMBA)
    whole = Model(cfg, device="cpu", seed=5)
    rank = parallel.parallelize(Model(cfg, device="cpu", seed=5),
                                world_of_one)
    g = torch.Generator().manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (2, 8), generator=g)
    f32 = torch.float32
    assert torch.equal(whole(prompt, compute_dtype=f32).logits,
                       rank(prompt, compute_dtype=f32).logits)
    (_, wc), (_, rc) = (mm.prefill(prompt, cache_capacity=12,
                                   compute_dtype=f32) for mm in (whole, rank))
    for pos in range(8, 11):
        tok = torch.randint(0, cfg.vocab_size, (2, 1), generator=g)
        want = whole.decode_step(wc, tok, pos=pos, compute_dtype=f32)
        with coll.tally() as t:
            got = rank.decode_step(rc, tok, pos=pos, compute_dtype=f32)
        assert torch.equal(got.logits, want.logits)
        assert "all-to-all" not in t.count_by_kind
    assert all(torch.equal(x, y) for a, b in zip(rc, wc)
               for x, y in zip(a, b))


def test_init_cache_is_the_rank_block():
    """A sharded model's zero cache is the rank's block under
    ``cache_pspec``: the conv tail and the SSM state on d_inner, the KV
    cache on its slots, the batch on the data axes."""
    cfg = get_smoke_config(JAMBA)
    mesh = mesh_lib.Mesh(("data", "model"), (2, 4))
    model = parallel.parallelize(Model(cfg, device="meta", seed=None), mesh)
    mamba, kv = model.init_cache(4, 16)
    d_in = cfg.mamba.expand * cfg.d_model
    assert mamba.conv.shape == (1, 2, cfg.mamba.d_conv - 1, d_in // 4)
    assert mamba.ssm.shape == (1, 2, d_in // 4, cfg.mamba.d_state)
    assert kv.k.shape == (1, 2, 4, cfg.n_kv_heads, cfg.head_dim)
