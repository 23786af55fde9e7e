"""The reference's ``--variant`` bundles in the port
(``launch/dryrun.py::variant_build_kwargs``: ``act_pspec``,
``cast_params_bf16``, ``moe_ep_constraint``, ``remat``) on four gloo
ranks against the reference's steps built with the same bundle's kwargs
on one device (a ("data", "model") mesh of one under ``set_mesh``): the
qwen3-8b (dense), olmoe-1b-7b (einsum MoE), jamba (Mamba + attention +
MoE) and xlstm-1.3b smoke configs on the meshes (2, 2) and ("pod",
"data", "model") = (2, 1, 2), FSDP on, in one spawn
(``tests/torch_ranks.py::variant_run``).

* ``opt``'s forward and prefill (the sequence-parallel residual), then 8
  decode steps from the prefill's cache (the weight-stationary layout,
  whose constraint changes no number on the reference's one device; the
  port's raises for the Mamba and xLSTM mixers, so jamba's and
  xlstm-1.3b's steps run the baseline layout): logits and risk within
  rtol = atol = 2e-5 of the reference's, each rank's cache blocks its
  slices of the reference's; every weight-stationary step's tally the
  hand count, with no parameter gathered.
* ``opt``'s train step (sequence parallel, remat, the bf16 casts before
  the FSDP gathers) and olmoe's ``opt3`` (remat off): loss, ce and aux
  within rtol 1e-5, the grad norm within rtol 2^-8; both moments within
  2^-7 (mu) and 2^-6 (nu) of each leaf's largest entry, the parameters
  within 2e-5 where |g| is over 2^-7 of the leaf's largest and,
  clipped, over 100 eps.  The bf16 cast makes every gradient a bf16
  value: the reference rounds each use's whole cotangent once (inside
  its time loop for the sLSTM), the port each rank's partial and then
  their bf16 reduce-scatter, so a gradient, its norm and the moments are
  held to bf16's precision and not to float32's.
* The tally: the forward's and the prefill's are the baseline's (run in
  the same spawn, whose own hand counts the family files hold) with the
  hand count of the sequence-parallel schedule's changes, kind by kind in
  bytes and counts; the train steps' counts likewise, with remat's
  recompute and opt3 without it.
* The kwargs table is the reference's, mesh by mesh.
* In process: at a mesh of one rank ``opt``, ``opt2`` and ``opt3`` are
  bitwise the baseline (forward and prefill) and the train step bitwise
  the baseline step with the same casts and remat; the layouts the port
  refuses raise, naming themselves or their item.
"""
import json
import math

import numpy as np
import pytest
import torch

import torch_ranks as tr
from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.shardings import P, param_pspecs, shard_shape
from repro_torch.models import Model, parallel
from repro_torch.training.optimizer import AdamW
from repro_torch.training.train import TrainState, make_train_step

TOL = dict(rtol=2e-5, atol=2e-5)
METRIC_RTOL, LEAF_TOL, LR = 1e-5, 2e-5, 1e-3
GNORM_RTOL = 2.0 ** -8      # a norm of bf16 gradients: bf16's precision
MU_TOL, NU_TOL = 2.0 ** -7, 2.0 ** -6
CASES = ("qwen3-8b", "olmoe-1b-7b", "jamba-1.5-large-398b", "xlstm-1.3b")
OPT3 = "olmoe-1b-7b"
RUNS = [(run, case) for run in tr.VARIANT_MESHES for case in CASES]
KEYS = ["fwd", "prefill"] + [str(s) for s in range(tr.STEPS)]
TRAINS = [(run, case, v) for run, case in RUNS
          for v in (("opt", "opt3") if case == OPT3 else ("opt",))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return tr.variant_run(tmp_path_factory.mktemp("variant"), CASES, OPT3,
                          LR)


def _norm(tables):
    """A spec's entry of one axis as the axis (JAX keeps the 1-tuple)."""
    def entry(e):
        return e[0] if isinstance(e, list) and len(e) == 1 else e
    return {mesh: {key: {k: [entry(e) for e in v] if k == "act_pspec"
                         else v for k, v in kw.items()}
                   for key, kw in table.items()}
            for mesh, table in tables.items()}


def test_kwargs_are_the_reference_table(runs):
    want = _norm(json.loads(bytes(runs["ref"]["kwargs"]).decode()))
    for port in runs["port"]:
        assert _norm(json.loads(bytes(port["kwargs"]).decode())) == want
    assert want["2x1x2"]["opt/train"] == {
        "act_pspec": [["pod", "data"], "model", None],
        "cast_params_bf16": True}
    assert want["2x2"]["opt3/decode"] == {
        "act_pspec": [None, None, "data"], "moe_ep_constraint": True}


@pytest.mark.parametrize("run,case", RUNS)
def test_outputs_match_reference(runs, run, case):
    tr.check_outputs(runs, run, case, get_smoke_config(case), KEYS, TOL)


@pytest.mark.parametrize("what", ["prefill", "decode"])
@pytest.mark.parametrize("run,case", RUNS)
def test_rank_cache_is_its_slice_of_the_reference(runs, run, case, what):
    tr.check_cache(runs, run, case, what, TOL)


@pytest.mark.parametrize("run,case,variant", TRAINS)
def test_train_step_matches_reference(runs, run, case, variant):
    ref, port = runs["ref"], runs["port"]
    for p in port:
        got, want = (r[f"{run}/{case}/{variant}/metrics"] if r is p
                     else r[f"{case}/{variant}/metrics"] for r in (p, ref))
        np.testing.assert_allclose(got[:3], want[:3], rtol=METRIC_RTOL,
                                   atol=1e-6)
        np.testing.assert_allclose(got[3], want[3], rtol=GNORM_RTOL)
    # step 1's first moments are (1 - b1) times the gradients scaled by
    # the clipping: the gradients back, near enough to pick the clear ones
    clip = max(float(ref[f"{case}/{variant}/metrics"][3]), 1.0)
    grads = [m / 0.1 * clip for m in tr._leaves(ref, f"{case}/{variant}/mu")]
    for what, tol in (("mu", MU_TOL), ("nu", NU_TOL), ("params", LEAF_TOL)):
        got = tr._leaves(port[0], f"{run}/{case}/{variant}/{what}")
        want = tr._leaves(ref, f"{case}/{variant}/{what}")
        assert len(got) == len(want) == len(grads)
        for i, (a, b, g) in enumerate(zip(got, want, grads)):
            atol = tol * max(np.abs(b).max(), 1e-6)
            if what == "params":
                # AdamW's step 1 moves a parameter by lr·g/(|g| + eps),
                # g clipped: held where g is clear of the bf16 precision
                # of the leaf and its clipped value 100 times eps
                clear = (np.abs(g) > MU_TOL * np.abs(g).max()) & (
                    np.abs(g) / clip > 100 * 1e-8)
                a, b = a[clear], b[clear]
            np.testing.assert_allclose(a, b, rtol=0, atol=atol,
                                       err_msg=f"{what} leaf {i}")


# ---------------------------------------------------------------------------
# the tally: the sequence-parallel schedule's changes to the baseline's
# ---------------------------------------------------------------------------

def _blocks(cfg):
    """(entry, close) of each mixer and FFN in layer order, at two ranks of
    "model" (every projection divides): an entry "f" becomes the
    all-gather over T ("ag"; the sLSTM, which runs whole, the gather
    whose backward keeps the rank's block: "same"); a close's all-reduce
    a reduce-scatter."""
    out = []
    for spec in cfg.layer_pattern * cfg.n_groups:
        out.append("same" if spec.mixer == "slstm" else "ag")
        if spec.ffn != "none":
            out.append("ag")
    return out


def _delta(counts: dict, bytes_: dict | None, kind: str, n: int,
           each: int = 0) -> None:
    counts[kind] = counts.get(kind, 0) + n
    if bytes_ is not None:
        bytes_[kind] = bytes_.get(kind, 0) + n * each


def forward_delta(cfg, run: str) -> tuple[dict, dict]:
    """The forward's (or the prefill's, logits of every token) changes,
    counts and bytes by kind: the embedding's all-reduce of (rows, T, d)
    a reduce-scatter onto (rows, T/m, d); each entry one all-gather of
    (rows, T, d); each close's all-reduce a reduce-scatter; the heads'
    all-gather of the final hidden states."""
    mesh = tr.shape_mesh(run)
    m = mesh.shape["model"]
    bl = tr.B // (mesh.size // m)
    act = bl * tr.T * cfg.d_model * 4
    n = len(_blocks(cfg))
    counts, bytes_ = {}, {}
    _delta(counts, bytes_, "all-reduce", -(1 + n), act)
    _delta(counts, bytes_, "reduce-scatter", 1 + n, act // m)
    _delta(counts, bytes_, "all-gather", n + 1, act)
    return counts, bytes_


def train_delta(cfg, run: str) -> dict:
    """The train step's (remat) changes in counts: the forward's, the
    recompute of each group (its entries and, the group's last close
    apart unless a MoE's aux loss ends the group, its closes), and the
    backward: the embedding's and each close's all-gather, each "ag"
    entry's reduce-scatter where its "f" all-reduced (a MoE's two "f"
    for one on the router's weight: one all-reduce fewer all the same),
    each norm's all-reduce of its scale's gradient, the lm head's "f" a
    reduce-scatter."""
    counts, _ = forward_delta(cfg, run)
    counts = dict(counts)
    blocks = _blocks(cfg)
    per_group = len(blocks) // cfg.n_groups
    ends_in_moe = cfg.layer_pattern[-1].ffn == "moe"
    for _ in range(cfg.n_groups):
        closes = per_group - (0 if ends_in_moe else 1)
        _delta(counts, None, "all-gather", per_group)
        _delta(counts, None, "all-reduce", -closes)
        _delta(counts, None, "reduce-scatter", closes)
    ag = sum(1 for b in blocks if b == "ag")
    norms = len(cfg.layer_pattern * cfg.n_groups) + len(blocks) \
        - len(cfg.layer_pattern * cfg.n_groups) + 1
    _delta(counts, None, "all-gather", 1 + len(blocks))
    _delta(counts, None, "all-reduce", -ag - 1 + norms)
    _delta(counts, None, "reduce-scatter", ag + 1)
    return counts


def recompute(cfg, run: str) -> dict:
    """What remat's recompute of the opt train step issues, in counts
    (opt3 leaves it out), for a pattern of attention blocks whose group
    ends in a MoE (its aux loss saves f and p, so the whole group runs
    again): each group's entries, FSDP gathers of its leaves and closes,
    and each MoE layer's gathers of the data ranks' expert counts and its
    aux loss's all-reduces, one each over each data axis."""
    assert {s.mixer for s in cfg.layer_pattern} == {"attn"}
    assert cfg.layer_pattern[-1].ffn == "moe"
    mesh = tr.shape_mesh(run)
    daxes = sum(1 for a in mesh.axis_names if a in mesh_lib.DATA_AXES)
    gathers, _ = tr.fsdp_gathers(cfg, run + "_fsdp")
    entries = len(_blocks(cfg))
    moe = cfg.n_groups * sum(1 for s in cfg.layer_pattern
                             if s.ffn == "moe")
    return {"all-gather": entries + gathers + moe * daxes,
            "reduce-scatter": entries, "all-reduce": moe * daxes}


def _plus(a: dict, b: dict, sign: int = 1) -> dict:
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0) + sign * v
    return {k: v for k, v in out.items() if v}


@pytest.mark.parametrize("run,case", RUNS)
def test_tally_is_the_schedule(runs, run, case):
    cfg = get_smoke_config(case)
    counts, bytes_ = forward_delta(cfg, run)
    tdelta = train_delta(cfg, run)
    for port in runs["port"]:
        for what in ("fwd", "prefill"):
            base_b, base_c = tr.tally(port[f"{run}/{case}/base/{what}/tally"])
            got_b, got_c = tr.tally(port[f"{run}/{case}/opt/{what}/tally"])
            assert got_c == _plus(base_c, counts), (what, got_c, base_c)
            assert got_b == _plus(base_b, bytes_), (what, got_b, base_b)
        _, base_c = tr.tally(port[f"{run}/{case}/base/train/tally"])
        _, got_c = tr.tally(port[f"{run}/{case}/opt/train/tally"])
        assert got_c == _plus(base_c, tdelta), (got_c, base_c)
        if case == OPT3:
            _, opt3 = tr.tally(port[f"{run}/{case}/opt3/train/tally"])
            assert opt3 == _plus(got_c, recompute(cfg, run), -1), opt3


WS_CASES = ("qwen3-8b", "olmoe-1b-7b")      # attention blocks only


def ws_decode_schedule(cfg, run: str) -> dict:
    """Counts by kind of one rank's weight-stationary decode step
    (``parallel.ws_mesh``), FSDP on: the tokens all-gathered over each
    data axis (the batch is cut there); the embedding's all-reduce over
    "model"; a layer's two norms and its q | k | v partials all-reduced
    over each data axis, the token's q, k, v gathered over "model", the
    combine's two all-reduces, the output rows gathered over each data
    axis, wo's all-reduce over "model"; an MLP's gate | up partials over
    each data axis and down over "model"; a MoE's router partials over
    each data axis, its gate | up partials (FSDP'd on d) or x and h
    gathered (on d_ff), its partial output over "model" and, down FSDP'd
    on d_ff, reduce-scattered over each data axis; the final norm, the
    lm head and the score head over each data axis.  No weight is
    gathered."""
    mesh = tr.shape_mesh(run)
    n_axes = sum(1 for a in mesh.axis_names if a in mesh_lib.DATA_AXES)
    model = parallel.parallelize(Model(cfg, device="meta", seed=None),
                                 mesh, fsdp=True)
    c = {"all-reduce": 1 + 3 * n_axes, "all-gather": n_axes}
    for block in model.stack:
        c["all-reduce"] += 2 * n_axes + n_axes + 2 + 1
        c["all-gather"] += 1 + n_axes
        if block.spec.ffn == "mlp":
            c["all-reduce"] += n_axes + 1
        elif block.spec.ffn == "moe":
            up_ff = parallel.data_dim(block.ffn, "gate") == 2
            down_ff = parallel.data_dim(block.ffn, "down") == 1
            c["all-reduce"] += n_axes + (0 if up_ff else n_axes) + 1
            c["all-gather"] += n_axes * (up_ff + (up_ff and not down_ff))
            if down_ff:
                c["reduce-scatter"] = c.get("reduce-scatter", 0) + n_axes
    return {k: float(v) for k, v in c.items()}


@pytest.mark.parametrize("case", WS_CASES)
@pytest.mark.parametrize("run", tr.VARIANT_MESHES)
def test_weight_stationary_decode_is_the_schedule(runs, run, case):
    """Every opt decode step's tally is the hand count, which gathers no
    parameter: all its all-gathers are the tokens', the token's q, k, v
    columns' and the output rows' (the baseline step gathers every
    FSDP'd leaf over the data axes)."""
    want = ws_decode_schedule(get_smoke_config(case), run)
    n_fsdp, _ = tr.fsdp_gathers(get_smoke_config(case), run + "_fsdp", "")
    for port in runs["port"]:
        for s in range(tr.STEPS):
            got = tr.tally(port[f"{run}/{case}/{s}/tally"])[1]
            assert got == want, (s, got, want)
    assert n_fsdp > want["all-gather"]


def fsdp_scatter_bytes(cfg, run: str) -> int:
    """Float32 bytes of the reduce-scatters of the FSDP gradients, one
    leaf each, over the data axes (each its output: the input of the
    forward's gather over that axis, ``tr.fsdp_gathers``)."""
    mesh = tr.shape_mesh(run)
    model = Model(cfg, device="meta", seed=None)
    specs = param_pspecs(cfg, model, mesh, fsdp=True)
    out = 0
    for name, p in model.named_parameters():
        local = math.prod(shard_shape(p.shape, specs[name], mesh)) * 4
        for a in reversed([a for a in parallel.spec_axes(specs[name])
                           if a in mesh_lib.DATA_AXES]):
            out += local
            local *= mesh.shape[a]
    return out


@pytest.mark.parametrize("run,case", RUNS)
def test_train_bytes_are_the_schedule(runs, run, case):
    """Under opt the train step's FSDP gathers (forward and recompute)
    and the sLSTM's gathers of its whole weights over "model" move bf16,
    half the baseline's float32 bytes, beside the sequence's all-gathers
    of (rows, T, d): the forward's n + 1, the recompute's n and the
    backward's n + 1 (n entries and closes); the reduce-scatters of the
    FSDP gradients move bf16 too, beside the sequence's of (rows, T/m,
    d).  jamba's and xlstm-1.3b's decode steps after
    the opt prefill gather every FSDP'd leaf, as the baseline's do (their
    weight-stationary decode raises)."""
    cfg = get_smoke_config(case)
    mesh = tr.shape_mesh(run)
    m = mesh.shape["model"]
    act = tr.B // (mesh.size // m) * tr.T * cfg.d_model * 4
    n = len(_blocks(cfg))
    n_all, f32_all = tr.fsdp_gathers(cfg, run + "_fsdp", "")
    _, f32_stack = tr.fsdp_gathers(cfg, run + "_fsdp", "stack.")
    scatter = fsdp_scatter_bytes(cfg, run)
    # w_in and w_rec of each sLSTM, whole: in the forward and the recompute
    slstm = 2 * 2 * 4 * 4 * cfg.d_model ** 2 * sum(
        1 for s in cfg.layer_pattern * cfg.n_groups if s.mixer == "slstm")
    closes = train_delta(cfg, run)["reduce-scatter"] - forward_delta(
        cfg, run)[0]["reduce-scatter"] - (sum(1 for b in _blocks(cfg)
                                              if b == "ag") + 1)
    for port in runs["port"]:
        base, _ = tr.tally(port[f"{run}/{case}/base/train/tally"])
        got, _ = tr.tally(port[f"{run}/{case}/opt/train/tally"])
        assert got["all-gather"] == base["all-gather"] - (
            f32_all + f32_stack + slstm) // 2 + act * (3 * n + 2)
        ag = sum(1 for b in _blocks(cfg) if b == "ag")
        # the rest of the baseline's (the mLSTM's, in the backward of its
        # v gathered over "model") stays float32
        assert got["reduce-scatter"] == base["reduce-scatter"] \
            - scatter // 2 + act // m * (1 + n + closes + ag + 1)
        steps = [tr.tally(port[f"{run}/{case}/{s}/tally"])
                 for s in range(tr.STEPS)]
        assert all(t == steps[0] for t in steps)
        if case not in WS_CASES:
            # the Mamba and xLSTM decode keeps the baseline layout
            assert steps[0][1]["all-gather"] > n_all


# ---------------------------------------------------------------------------
# in process
# ---------------------------------------------------------------------------

@pytest.fixture
def world_of_one(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield mesh_lib.init_mesh(mesh_lib.make_host_mesh(), device="cpu")
    finally:
        dist.destroy_process_group()


def _train(model, mesh, tokens, **kw):
    model.requires_grad_(True)
    opt = AdamW(learning_rate=LR)
    params = dict(model.named_parameters())
    state = TrainState(params, opt.init(params))
    step = make_train_step(model, opt, compute_dtype=torch.float32, **kw)
    with mesh_lib.set_mesh(mesh):
        state, metrics = step(state, tokens, tokens)
    return [float(v) for v in metrics], state.opt.mu, state.params


@pytest.mark.parametrize("case", CASES)
def test_one_rank_bundles_are_bitwise_the_baseline(world_of_one, case):
    """At one rank every collective is a copy: under opt, opt2 and opt3
    the forward, the prefill (logits, risk, every cache leaf) and, for
    the attention models, the weight-stationary decode steps are the
    baseline's to the last bit, and each bundle's train step is the
    baseline step with the same bf16 casts and remat (opt3's without
    remat is opt's: remat changes no bit)."""
    cfg = get_smoke_config(case)
    f32 = torch.float32
    tok = torch.tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 8)))

    def placed():
        return parallel.parallelize(Model(cfg, device="cpu", seed=4),
                                    world_of_one)

    model = placed()
    with torch.no_grad():
        want = model(tok, compute_dtype=f32)
        wp, wc = model.prefill(tok, cache_capacity=12, compute_dtype=f32)
    trains = {}
    for variant in ("opt", "opt2", "opt3"):
        act = dryrun.variant_build_kwargs(variant, "prefill",
                                          world_of_one)["act_pspec"]
        with torch.no_grad():
            got = model(tok, compute_dtype=f32, act_pspec=act)
            gp, gc = model.prefill(tok, cache_capacity=12, compute_dtype=f32,
                                   act_pspec=act)
        assert torch.equal(got.logits, want.logits)
        assert torch.equal(got.risk_score, want.risk_score)
        assert torch.equal(gp.logits, wp.logits)
        assert all(torch.equal(x, y) for a, b in zip(gc, wc)
                   for x, y in zip(a, b))
        if case in WS_CASES:
            ws = dryrun.variant_build_kwargs(variant, "decode",
                                             world_of_one)["act_pspec"]
            gd, wd = ([type(c)(*(a.clone() for a in c)) for c in cache]
                      for cache in (gc, wc))
            for pos in (8, 9, 10):
                step = tok[:, pos - 8:pos - 7]
                a = model.decode_step(gd, step, pos=pos, act_pspec=ws,
                                      compute_dtype=f32)
                b = model.decode_step(wd, step, pos=pos, compute_dtype=f32)
                assert torch.equal(a.logits, b.logits)
                assert torch.equal(a.risk_score, b.risk_score)
            assert all(torch.equal(x, y) for a, b in zip(gd, wd)
                       for x, y in zip(a, b))
        kw = dryrun.variant_build_kwargs(variant, "train", world_of_one)
        kw.pop("moe_ep_constraint", None)
        trains[variant] = _train(placed(), world_of_one, tok, **kw)
    base = _train(placed(), world_of_one, tok, cast_params_bf16=True)
    for variant, (metrics, mu, params) in trains.items():
        assert metrics == base[0], variant
        assert all(torch.equal(mu[k], base[1][k]) for k in mu), variant
        assert all(torch.equal(params[k], base[2][k]) for k in params)


def test_refused_layouts_name_themselves(world_of_one):
    """The weight-stationary decode of a Mamba or xLSTM model raises
    naming its item, and in a forward, a prefill or a train step it
    raises naming the decode; ``opt4`` names item 13g; a spec neither
    layout is, or one naming other data axes than the mesh's, raises
    naming itself; a sequence that does not divide over "model" raises
    with its sizes."""
    ws = dryrun.variant_build_kwargs("opt", "decode", world_of_one)
    assert ws["act_pspec"] == P(None, None, "data")
    for arch in ("jamba-1.5-large-398b", "xlstm-1.3b"):
        model = parallel.parallelize(
            Model(get_smoke_config(arch), device="cpu", seed=4),
            world_of_one)
        _, cache = model.prefill(torch.zeros((2, 8), dtype=torch.long),
                                 cache_capacity=12)
        with pytest.raises(NotImplementedError,
                           match=mesh_lib.VARIANTS[:30]):
            model.decode_step(cache, torch.zeros((2, 1), dtype=torch.long),
                              pos=8, act_pspec=ws["act_pspec"])
    cfg = get_smoke_config("qwen3-8b")
    model = parallel.parallelize(Model(cfg, device="cpu", seed=4),
                                 world_of_one)
    tok = torch.zeros((2, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="decode step"):
        model(tok, act_pspec=ws["act_pspec"])
    with pytest.raises(ValueError, match="decode step"):
        _, cache = model.prefill(tok, cache_capacity=12,
                                 act_pspec=P("data", "model", None))
        model.decode_step(cache, tok[:, :1], pos=8,
                          act_pspec=P("data", "model", None))
    with pytest.raises(NotImplementedError, match="item 13g"):
        dryrun.variant_build_kwargs("opt4", "train", world_of_one)
    for spec in (P("model", None, None), P(("pod", "data"), "model", None),
                 object()):
        with pytest.raises(ValueError, match="act_pspec"):
            model(tok, act_pspec=spec)
    mesh = mesh_lib.Mesh(("data", "model"), (1, 2))
    two = parallel.parallelize(Model(cfg, device="meta", seed=None), mesh)
    with pytest.raises(ValueError, match="T = 7"):
        two(torch.zeros((1, 7), dtype=torch.long, device="meta"),
            act_pspec=P("data", "model", None))
