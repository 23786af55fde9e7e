"""The mLSTM and sLSTM mixers under the production rules
(``models/xlstm.py`` on a model sharded by ``models/parallel.py``) on four
gloo ranks against the reference's ``Model`` on one device: the xlstm
smoke config (an sLSTM block, then an mLSTM block) on the meshes (1, 4),
(2, 2), (4, 1) and ("pod", "data", "model") = (2, 1, 2), and once more on
(2, 2) with FSDP on (``tests/torch_ranks.py``'s recurrent runs).  Two
cases: the 4 x 8 prompt (one chunk of the mLSTM's 32) and a 4 x 40 one,
whose matrix memory crosses a chunk and whose last chunk is short.  The
sLSTM's d_up (170) divides over 2 ranks, not 4: its up / down run column
/ row parallel at m = 2 and whole at m = 4.

* Forward, prefill and 8 decode steps: logits and risk within rtol =
  atol = 2e-5 of the reference's; each rank's block of every state leaf
  (C and n on d_k, the sLSTM's four on d) its slice of the reference's
  under ``cache_pspec``, after the prefill and after the last step.
* One train step (remat, float32, AdamW): loss, ce, aux and grad norm
  within rtol 1e-5; moments within 2e-5 of each leaf's largest, the
  parameters where |g| is clear; each rank's state bytes the rules'.
* Every tally equals the hand count of the schedule, and the meta trace
  counts what the live ranks count; the reference's GSPMD forward tally
  is recorded beside it.
* In process: the mLSTM's d_k / d_v blocks and the sLSTM's
  gate-to-channel exchange for m in {1, 2, 4, 8, 16} on the full config
  against brute-force maps (four ranks cut the sLSTM's 4d at whole gates,
  sixteen at quarter gates); the sLSTM decode gathers no weight; the
  placed model at one rank bitwise the whole model's.
"""
import json
import pickle

import numpy as np
import pytest
import torch

import torch_ranks as tr
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import collectives as coll
from repro_torch.launch import dryrun, specs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import Model, parallel
from repro_torch.models.xlstm import mlstm_dims

TOL = dict(rtol=2e-5, atol=2e-5)
METRIC_RTOL, LEAF_TOL, LR = 1e-5, 2e-5, 1e-3
XLSTM = "xlstm-1.3b"
LONG = XLSTM + "/T40"
BIG_QK = XLSTM + "/qk4"     # the mLSTM's wq and wk scaled by 4
CASES = {XLSTM: (XLSTM, "", XLSTM), LONG: (XLSTM, "long_", BIG_QK)}
RUNS = [(run, case) for run in tr.RECURRENT_RUNS for case in CASES]
KEYS = ["fwd", "prefill"] + [str(s) for s in range(tr.STEPS)]


def _big_qk(tree: dict) -> dict:
    """The smoke weights with the mLSTM's wq and wk scaled by 4, so that
    the normaliser |n . q| passes 1 (at 1 its max(|den|, 1) is flat and
    the normaliser takes no gradient): its all-reduce's backward is then
    tested."""
    big = pickle.loads(pickle.dumps(tree))
    mixer = big["stack"][1]["mixer"]
    for w in ("wq", "wk"):
        mixer[w] = mixer[w] * 4
    return big


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("xlstm")
    tr.write_inputs(tmp, (XLSTM,))
    with open(tmp / "params.pkl", "rb") as f:
        trees = pickle.load(f)
    trees[BIG_QK] = _big_qk(trees[XLSTM])
    with open(tmp / "params.pkl", "wb") as f:
        pickle.dump(trees, f)
    return tr.recurrent_run(tmp, CASES, LR)


@pytest.mark.parametrize("run,case", RUNS)
def test_outputs_match_reference(runs, run, case):
    tr.check_outputs(runs, run, case, get_smoke_config(XLSTM), KEYS, TOL)


@pytest.mark.parametrize("what", ["prefill", "decode"])
@pytest.mark.parametrize("run,case", RUNS)
def test_rank_states_are_their_slice_of_the_reference(runs, run, case,
                                                      what):
    tr.check_cache(runs, run, case, what, TOL)


@pytest.mark.parametrize("run,case", RUNS)
def test_train_step_matches_reference(runs, run, case):
    tr.check_train(runs, run, case, METRIC_RTOL, LEAF_TOL)


@pytest.mark.parametrize("run", tr.RECURRENT_RUNS)
def test_rank_state_bytes_are_the_rules(runs, run):
    bundle = specs.build_step(XLSTM, InputShape("smoke", tr.T, tr.B,
                                                "train"),
                              cfg=get_smoke_config(XLSTM))
    want = dryrun.argument_bytes_per_device(
        bundle, tr.shape_mesh(run.split("_")[0]),
        fsdp=run.endswith("_fsdp"))
    for port in runs["port"]:
        for case in CASES:
            assert int(port[f"{run}/{case}/state_bytes"]) == \
                want["by_argument"][0] - 4      # less the step counter


def _dims():
    cfg = get_smoke_config(XLSTM)
    d = cfg.d_model
    d_in, hd = mlstm_dims(d, cfg.n_heads, cfg.xlstm)
    return cfg, d, d_in, hd, int(cfg.xlstm.slstm_proj_factor * d)


def schedule(run: str, what: str, t: int) -> tr.Tally:
    """Bytes and counts by kind of one rank's float32 forward, prefill or
    decode step of the xlstm smoke config (t prompt tokens).  The sLSTM:
    a prefill all-gathers w_in and w_rec over "model" once, a decode step
    all-gathers h before and after the cell and exchanges the gate
    columns in one split all-to-all (none over one rank); its down
    projection's all-reduce where d_up divides.  The mLSTM: the gathers
    of up's output and of v, the normaliser's all-reduce, the
    numerator's reduce-scatter and down's all-reduce.  FSDP: one gather
    over each data axis a sharded leaf."""
    cfg, d, d_in, hd, d_up = _dims()
    mesh = tr.shape_mesh(run.split("_")[0])
    m = mesh.shape["model"]
    bl = tr.B // (mesh.size // m)
    rows = bl * (1 if what == "decode" else t)
    h = cfg.n_heads
    out = tr.Tally()
    out.add("all-reduce", 1, rows * d * 4)          # the embedding
    if what == "decode":
        out.add("all-gather", 2, bl * d * 4)
        if m > 1:
            out.add("all-to-all", 1, 4 * bl * d // m * 4)
    else:
        out.add("all-gather", 2, 4 * d * d * 4)
    out.add("all-reduce", d_up % m == 0, rows * d * 4)
    out.add("all-gather", 1, rows * 2 * d_in * 4)
    out.add("all-gather", 1, rows * h * hd * 4)
    out.add("all-reduce", 1, rows * h * 4)
    out.add("reduce-scatter", 1, rows * d_in // m * 4)
    out.add("all-reduce", 1, rows * d * 4)
    n, nbytes = tr.fsdp_gathers(cfg, run, "")
    out.add("all-gather", n, 0)
    out.bytes["all-gather"] += nbytes
    return out


def train_schedule(run: str) -> dict:
    """Counts by kind of one rank's train step (remat, float32).  The
    recompute of the remat group stops at the mLSTM's down projection,
    its last saved input: down's all-reduce is not repeated.  The sLSTM's
    gathered weights every rank uses alike, so their backward exchanges
    nothing; its up's "f" where d_up divides.  The mLSTM's backward:
    up's "f", w_if's weight and bias ("f"), the normaliser's all-reduce,
    the two gathers' reduce-scatters and the reduce-scatter's gather.
    Then the tail of ``torch_ranks.train_tail``."""
    cfg, _, _, _, d_up = _dims()
    m = tr.shape_mesh(run.split("_")[0]).shape["model"]
    counts, fsdp_ag, fsdp_rs = tr.train_tail(cfg, run)
    up = int(d_up % m == 0)
    counts["all-gather"] += 2 * fsdp_ag + 2 * 2 + 2 * 2 + 1
    counts["reduce-scatter"] += fsdp_rs + 2 + 2
    counts["all-reduce"] += 2 * up + up + (2 + 1) + 4
    return {k: v for k, v in counts.items() if v}


@pytest.mark.parametrize("run,case", RUNS)
def test_tally_is_the_schedule(runs, run, case, record_property):
    t = tr.LONG_T if case == LONG else tr.T
    for what, keys in (("fwd", ["fwd"]), ("prefill", ["prefill"]),
                       ("decode", [str(s) for s in range(tr.STEPS)])):
        want = schedule(run, what, t)
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
    bundle = specs.build_step(XLSTM, SMOKE[kind],
                              cfg=get_smoke_config(XLSTM),
                              mesh=tr.shape_mesh(run.split("_")[0]),
                              fsdp=run.endswith("_fsdp"))
    counted = dryrun.trace(bundle)["collectives"]["count_by_kind"]
    key = {"train": "train", "prefill": "prefill", "decode": "0"}[kind]
    for port in runs["port"]:
        assert tr.tally(port[f"{run}/{XLSTM}/{key}/tally"])[1] == counted


# ---------------------------------------------------------------------------
# in process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [1, 2, 4, 8, 16])
def test_mlstm_plan_against_brute_force(m):
    """On the full xlstm-1.3b (4 heads of 1,024, d_in 4,096): the
    head-wise projections' columns on "model" give rank r the same block
    of every head's d_k and d_v, which the states C and n hold under
    ``cache_pspec``; its d_in block (``down``'s input) is a block of one
    head's d_v; ``up``'s pieces are x or z, owned as the Mamba's."""
    from repro_torch.launch import shardings

    cfg = get_config(XLSTM)
    d_in, hd = mlstm_dims(cfg.d_model, cfg.n_heads, cfg.xlstm)
    mesh = mesh_lib.Mesh(("data", "model"), (1, m))
    wq = shardings.param_pspec("blocks/1/mixer/wq/", (6, 4, hd, hd), m)
    c_spec = shardings.cache_pspec("1/c/", (6, 2, 4, hd, hd), 2, mesh)
    flat = np.arange(d_in).reshape(cfg.n_heads, hd)     # (head, d_v)
    for r in range(m):
        plan = parallel.mlstm_plan(cfg.n_heads, hd, m, r)
        cols = np.arange(hd).reshape(m, -1)[r]          # brute force
        assert plan.head_block == (cols[0], len(cols))
        assert wq[3] == "model" and c_spec[3] == "model"
        block = flat.ravel()[r * d_in // m:(r + 1) * d_in // m]
        assert plan.channels == (block[0], len(block))
        assert len(set(block // hd)) == 1 or m < cfg.n_heads
        assert plan.up.channels == plan.channels


@pytest.mark.parametrize("m", [1, 2, 4, 8, 16])
def test_slstm_gate_plan_against_brute_force(m):
    """On the full xlstm-1.3b (d 2,048; w_in / w_rec 8,192 columns of
    [i | f | z | o]): rank r's gate columns, cut in pieces of its channel
    width, go each to the rank whose channels they are; after the split
    all-to-all rank r holds i, f, z and o of its channel block, in that
    order.  Four ranks hold one whole gate each, sixteen a quarter of
    one."""
    from test_torch_mamba_ranks import brute_force_exchange

    d = get_config(XLSTM).d_model
    c = d // m
    got = brute_force_exchange(4, d, m)
    for r in range(m):
        plan = parallel.gate_plan(4, d, m, r)
        want = np.concatenate([g * d + np.arange(r * c, (r + 1) * c)
                               for g in range(4)])
        np.testing.assert_array_equal(got[r].ravel(), want)
        gates = {p for p, _ in plan.pieces}
        assert len(gates) == {1: 4, 2: 2, 4: 1, 8: 1, 16: 1}[m]
        if m == 16:
            assert plan.pieces == tuple((r // 4, 4 * (r % 4) + j)
                                        for j in range(4))


def test_mlstm_plan_refuses_layouts_it_does_not_handle():
    """d_in on "model" while a head's width is not (q, k, v whole beside
    a sharded down) raises; columns that do not divide keep the layer
    whole."""
    with pytest.raises(ValueError, match="width"):
        parallel.mlstm_plan(8, 6, 16, 0, "x")
    assert parallel.mlstm_plan(4, 6, 5, 0) is None


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
    """At one rank the placed xlstm smoke is the whole model to the last
    bit (forward, prefill and decode, every state leaf), while its
    gathers, reduce-scatter and all-reduces are issued over the rank of
    one; the sLSTM decode gathers h, no weight."""
    cfg = get_smoke_config(XLSTM)
    whole = Model(cfg, device="cpu", seed=5)
    rank = parallel.parallelize(Model(cfg, device="cpu", seed=5),
                                world_of_one)
    g = torch.Generator().manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (2, 40), generator=g)
    f32 = torch.float32
    assert torch.equal(whole(prompt, compute_dtype=f32).logits,
                       rank(prompt, compute_dtype=f32).logits)
    (_, wc), (_, rc) = (mm.prefill(prompt, cache_capacity=48,
                                   compute_dtype=f32) for mm in (whole, rank))
    d = cfg.d_model
    for pos in range(40, 43):
        tok = torch.randint(0, cfg.vocab_size, (2, 1), generator=g)
        want = whole.decode_step(wc, tok, pos=pos, compute_dtype=f32)
        with coll.tally() as t:
            got = rank.decode_step(rc, tok, pos=pos, compute_dtype=f32)
        assert torch.equal(got.logits, want.logits)
        # h twice (the sLSTM), up's output and v (the mLSTM): together
        # less than one gathered (4d, d) weight
        assert t.count_by_kind["all-gather"] == 4
        assert t.bytes_by_kind["all-gather"] < 4 * d * d * 4
    assert all(torch.equal(x, y) for a, b in zip(rc, wc)
               for x, y in zip(a, b))
