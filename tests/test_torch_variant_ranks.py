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
  whose constraint changes no number on the reference's one device;
  jamba's Mamba and xlstm-1.3b's mLSTM and sLSTM blocks too): logits and
  risk within rtol = atol = 2e-5 of the reference's, each rank's cache
  blocks its slices of the reference's; every weight-stationary step's
  tally the hand count, which gathers no parameter but the recurrent
  mixers' that never touch the residual (:data:`WS_GATHERED`, as
  ``models/mamba.py`` and ``models/xlstm.py`` name them).
* olmoe's ``opt4`` (``opt`` with the all-to-all MoE, drop-free at the
  smoke config's capacity factor of E / k): its forward and prefill
  within 2e-5 and its train step under the cast rule below; the
  all-to-all MoE's train step in the baseline layout (no casts) within
  rtol 1e-5 (loss, ce, aux, grad norm) and 2e-5 of each leaf's largest
  (moments), its summed gradients (step 1's first moments) those of the
  port's placed einsum step within 2e-5; each tally the einsum step's
  with the hand count of the layer's changes (:func:`a2a_delta`).
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
import collections
import dataclasses
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
OPT3 = OPT4 = "olmoe-1b-7b"
RUNS = [(run, case) for run in tr.VARIANT_MESHES for case in CASES]
KEYS = ["fwd", "prefill"] + [str(s) for s in range(tr.STEPS)]
TRAINS = [(run, case, v) for run, case in RUNS
          for v in ["opt"] + (["opt3"] if case == OPT3 else [])
          + (["opt4", "a2a"] if case == OPT4 else [])]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return tr.variant_run(tmp_path_factory.mktemp("variant"), CASES, OPT3,
                          OPT4, LR)


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
    assert want["2x2"]["opt4/prefill"] == {
        "act_pspec": ["data", "model", None], "moe_impl": "a2a"}
    assert want["2x2"]["opt4/decode"] == want["2x2"]["opt/decode"]


@pytest.mark.parametrize("run", tr.VARIANT_MESHES)
def test_opt4_outputs_match_reference(runs, run):
    tr.check_outputs(runs, run, OPT4, get_smoke_config(OPT4),
                     ["opt4/fwd", "opt4/prefill"], TOL)


@pytest.mark.parametrize("run,case", RUNS)
def test_outputs_match_reference(runs, run, case):
    tr.check_outputs(runs, run, case, get_smoke_config(case), KEYS, TOL)


@pytest.mark.parametrize("what", ["prefill", "decode"])
@pytest.mark.parametrize("run,case", RUNS)
def test_rank_cache_is_its_slice_of_the_reference(runs, run, case, what):
    tr.check_cache(runs, run, case, what, TOL)


@pytest.mark.parametrize("run,case,variant", TRAINS)
def test_train_step_matches_reference(runs, run, case, variant):
    """The bundles with the bf16 casts under the cast rule; the
    all-to-all MoE's baseline-layout step ("a2a", float32 throughout)
    under float32's: the grad norm within rtol 1e-5, the moments within
    2e-5 of a leaf's largest."""
    ref, port = runs["ref"], runs["port"]
    if variant == "a2a":
        gnorm_rtol, mu_tol, nu_tol = METRIC_RTOL, LEAF_TOL, LEAF_TOL
    else:
        gnorm_rtol, mu_tol, nu_tol = GNORM_RTOL, MU_TOL, NU_TOL
    for p in port:
        got, want = (r[f"{run}/{case}/{variant}/metrics"] if r is p
                     else r[f"{case}/{variant}/metrics"] for r in (p, ref))
        np.testing.assert_allclose(got[:3], want[:3], rtol=METRIC_RTOL,
                                   atol=1e-6)
        np.testing.assert_allclose(got[3], want[3], rtol=gnorm_rtol)
    # step 1's first moments are (1 - b1) times the gradients scaled by
    # the clipping: the gradients back, near enough to pick the clear ones
    clip = max(float(ref[f"{case}/{variant}/metrics"][3]), 1.0)
    grads = [m / 0.1 * clip for m in tr._leaves(ref, f"{case}/{variant}/mu")]
    for what, tol in (("mu", mu_tol), ("nu", nu_tol), ("params", LEAF_TOL)):
        got = tr._leaves(port[0], f"{run}/{case}/{variant}/{what}")
        want = tr._leaves(ref, f"{case}/{variant}/{what}")
        assert len(got) == len(want) == len(grads)
        for i, (a, b, g) in enumerate(zip(got, want, grads)):
            atol = tol * max(np.abs(b).max(), 1e-6)
            if what == "params":
                # AdamW's step 1 moves a parameter by lr·g/(|g| + eps),
                # g clipped: held where g is clear of the bf16 precision
                # of the leaf and its clipped value 100 times eps
                clear = (np.abs(g) > mu_tol * np.abs(g).max()) & (
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


def _moe_counts(cfg, run: str, impl: str, seq: bool, what: str) -> dict:
    """Counts by kind of one placed MoE layer of ``cfg`` (FSDP on, two
    ranks of "model"), ``what`` "fwd" (a forward or a prefill) or "train"
    (the forward, remat's recompute and the backward).

    einsum: FSDP gathers of gate, up and down (one an axis their spec
    names; backward reduce-scatters), the data ranks' expert counts
    gathered over each data axis (a chunk spans them), the aux stats
    all-reduced over each data axis both ways; in the baseline layout the
    partial output's all-reduce over "model" and the tokens' and gates'
    "f" (backward), under ``seq`` the entry's all-gather over T and the
    close's reduce-scatter (each the other's backward) and the router's
    "f".  The whole group recomputes (its aux saves f and p).

    a2a: the exchange of each expert weight FSDP'd on d over each data
    axis of two ranks and the dispatch and return all-to-alls over
    "model" (each backward the same), the buffers gathered over each data
    axis and reduce-scattered back (each the other's backward), the aux
    stats over each data axis both ways and over "model" forward, the
    router's "f"; in the baseline layout the output gathered over "model"
    (its backward keeps the rank's block, and the recompute stops before
    it) and the token block's backward gather."""
    mesh = tr.shape_mesh(run)
    daxes = [a for a in mesh.axis_names if a in mesh_lib.DATA_AXES]
    na = len(daxes)
    kw = {} if impl == "einsum" else {"impl": impl}
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **kw))
    model = parallel.parallelize(Model(cfg, device="meta", seed=None),
                                 mesh, fsdp=True)
    moe = next(b.ffn for b in model.stack if b.spec.ffn == "moe")
    specs = parallel.placement(moe).specs
    if impl == "einsum":
        g = sum(1 for w in ("gate", "up", "down")
                for a in parallel.spec_axes(specs[w])
                if a in mesh_lib.DATA_AXES)
        fwd = {"all-gather": g + na + seq, "reduce-scatter": seq,
               "all-reduce": na + (not seq)}
        back = {"reduce-scatter": g + seq, "all-gather": seq,
                "all-reduce": na + (1 if seq else 2)}
        again = fwd
    else:
        on_d = sum(1 for w, d_dim in (("gate", 1), ("up", 1), ("down", 2))
                   if parallel.data_dim(moe, w) == d_dim)
        x = on_d * sum(1 for a in daxes if mesh.shape[a] > 1)
        fwd = {"all-to-all": x + 2, "all-gather": na + (not seq),
               "reduce-scatter": na, "all-reduce": na + 1}
        back = fwd
        again = _plus(fwd, {"all-gather": not seq}, -1)
    return fwd if what == "fwd" else _plus(_plus(fwd, again), back)


def a2a_delta(cfg, run: str, seq: bool, what: str) -> dict:
    """The all-to-all MoE's changes to the einsum MoE's step in counts,
    every MoE layer of ``cfg`` (:func:`_moe_counts`)."""
    n = cfg.n_groups * sum(1 for s in cfg.layer_pattern if s.ffn == "moe")
    a2a = _moe_counts(cfg, run, "a2a", seq, what)
    einsum = _moe_counts(cfg, run, "einsum", seq, what)
    return {k: n * (a2a.get(k, 0) - einsum.get(k, 0))
            for k in set(a2a) | set(einsum)}


@pytest.mark.parametrize("run", tr.VARIANT_MESHES)
def test_a2a_tally_is_the_schedule(runs, run):
    """opt4's forward, prefill and train step are opt's with the MoE
    layers' changes (:func:`a2a_delta`, sequence parallel); the
    all-to-all MoE's baseline-layout train step the placed einsum
    step's with the baseline layout's."""
    cfg = get_smoke_config(OPT4)
    for port in runs["port"]:
        for what in ("fwd", "prefill"):
            _, opt = tr.tally(port[f"{run}/{OPT4}/opt/{what}/tally"])
            _, got = tr.tally(port[f"{run}/{OPT4}/opt4/{what}/tally"])
            assert got == _plus(opt, a2a_delta(cfg, run, True, "fwd")), (
                what, got, opt)
        for variant, base, seq in (("opt4", "opt", True),
                                   ("a2a", "base", False)):
            _, want = tr.tally(port[f"{run}/{OPT4}/{base}/train/tally"])
            _, got = tr.tally(port[f"{run}/{OPT4}/{variant}/train/tally"])
            assert got == _plus(want, a2a_delta(cfg, run, seq, "train")), (
                variant, got, want)


@pytest.mark.parametrize("run", tr.VARIANT_MESHES)
def test_a2a_gradients_are_the_einsum_steps(runs, run):
    """The all-to-all MoE's baseline-layout train step and the placed
    einsum step from the same weights (drop-free): the metrics within
    rtol 1e-5 on every rank and step 1's first moments (the summed
    gradients, clipped alike) within 2e-5 of each leaf's largest."""
    for port in runs["port"]:
        np.testing.assert_allclose(port[f"{run}/{OPT4}/a2a/metrics"],
                                   port[f"{run}/{OPT4}/base/metrics"],
                                   rtol=METRIC_RTOL)
    got = tr._leaves(runs["port"][0], f"{run}/{OPT4}/a2a/mu")
    want = tr._leaves(runs["port"][0], f"{run}/{OPT4}/base/mu")
    assert len(got) == len(want) > 0
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, rtol=0, atol=LEAF_TOL * max(
            np.abs(b).max(), 1e-6), err_msg=f"mu leaf {i}")


# the weights a weight-stationary decode step gathers over the data axes
# where FSDP put them: the recurrent mixers' that never touch the
# residual, as models/mamba.py and models/xlstm.py name them
WS_GATHERED = {"mamba": ("conv_w", "x_proj.weight", "dt_proj.weight",
                         "A_log"),
               "mlstm": ("wq", "wk", "wv", "w_if.weight"),
               "slstm": ("w_rec.weight",)}


def _ws_gathers(block) -> int:
    """All-gathers of :data:`WS_GATHERED`'s weights of ``block``'s mixer:
    one a data axis their spec names."""
    n = 0
    for name in WS_GATHERED.get(block.spec.mixer, ()):
        owner, _, attr = name.rpartition(".")
        mod = block.mixer.get_submodule(owner) if owner else block.mixer
        n += sum(1 for a in parallel.spec_axes(
            parallel.placement(mod).specs[attr])
            if a in mesh_lib.DATA_AXES)
    return n


def ws_decode_schedule(cfg, run: str) -> dict:
    """Counts by kind of one rank's weight-stationary decode step
    (``parallel.ws_mesh``), FSDP on, two ranks of "model": the tokens
    all-gathered over each data axis (the batch is cut there); the
    embedding's all-reduce over "model"; a block's norms over each data
    axis; an attention layer's q | k | v partials over each data axis,
    the token's q, k, v gathered over "model", the combine's two
    all-reduces, the output rows gathered over each data axis, wo's
    all-reduce over "model"; a Mamba layer's in_proj partials over each
    data axis, the (x | z) exchange over "model", x_proj's and
    out_proj's all-reduces over "model" and the output rows; an mLSTM
    layer's up partials, up's columns and v gathered over "model", the
    numerator's reduce-scatter and the normaliser's all-reduce, the rows
    and down's all-reduce; an sLSTM layer's w_in partials, h gathered
    over "model" before and after the gates' exchange, the rows, up's
    partials and down's all-reduce; the recurrent mixers' gathered
    weights (:data:`WS_GATHERED`); an MLP's gate | up partials over each
    data axis and down over "model"; a MoE's router partials over each
    data axis, its gate | up partials (FSDP'd on d) or x and h gathered
    (on d_ff), its partial output over "model" and, down FSDP'd on d_ff,
    reduce-scattered over each data axis; the final norm, the lm head
    and the score head over each data axis."""
    mesh = tr.shape_mesh(run)
    n_axes = sum(1 for a in mesh.axis_names if a in mesh_lib.DATA_AXES)
    model = parallel.parallelize(Model(cfg, device="meta", seed=None),
                                 mesh, fsdp=True)
    c = collections.Counter({"all-reduce": 1 + 3 * n_axes,
                             "all-gather": n_axes})
    for block in model.stack:
        kind = block.spec.mixer
        c["all-reduce"] += n_axes * (1 + (block.spec.ffn != "none"))
        if kind == "attn":
            c["all-reduce"] += n_axes + 2 + 1
            c["all-gather"] += 1 + n_axes
        elif kind == "mamba":
            c["all-reduce"] += n_axes + 2
            c["all-to-all"] += 1
            c["all-gather"] += n_axes
        elif kind == "mlstm":
            c["all-reduce"] += n_axes + 2
            c["all-gather"] += 2 + n_axes
            c["reduce-scatter"] += 1
        else:
            c["all-reduce"] += 2 * n_axes + 1
            c["all-gather"] += 2 + n_axes
            c["all-to-all"] += 1
        c["all-gather"] += _ws_gathers(block)
        if block.spec.ffn == "mlp":
            c["all-reduce"] += n_axes + 1
        elif block.spec.ffn == "moe":
            up_ff = parallel.data_dim(block.ffn, "gate") == 2
            down_ff = parallel.data_dim(block.ffn, "down") == 1
            c["all-reduce"] += n_axes + (0 if up_ff else n_axes) + 1
            c["all-gather"] += n_axes * (up_ff + (up_ff and not down_ff))
            if down_ff:
                c["reduce-scatter"] += n_axes
    return {k: float(v) for k, v in c.items() if v}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("run", tr.VARIANT_MESHES)
def test_weight_stationary_decode_is_the_schedule(runs, run, case):
    """Every opt decode step's tally is the hand count, which gathers no
    parameter but :data:`WS_GATHERED`'s: its other all-gathers are the
    tokens', the token's q, k, v columns', the recurrent mixers' own
    features' and the output rows' (the baseline step gathers every
    FSDP'd leaf over the data axes)."""
    want = ws_decode_schedule(get_smoke_config(case), run)
    _, f32_fsdp = tr.fsdp_gathers(get_smoke_config(case), run + "_fsdp", "")
    for port in runs["port"]:
        for s in range(tr.STEPS):
            nbytes, got = tr.tally(port[f"{run}/{case}/{s}/tally"])
            assert got == want, (s, got, want)
            assert nbytes["all-gather"] < f32_fsdp


def test_ws_gathered_weights_are_the_docstrings():
    """Each weight the weight-stationary decode gathers is named in its
    mixer module's docstring, where the choice is argued."""
    from repro_torch.models import mamba, xlstm
    for kind, names in WS_GATHERED.items():
        doc = (mamba if kind == "mamba" else xlstm).__doc__
        for name in names:
            assert f"``{name.split('.')[0]}``" in doc, (kind, name)


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
    d).  Every decode step after the opt prefill is alike and gathers
    fewer bytes than the baseline's FSDP gathers."""
    cfg = get_smoke_config(case)
    mesh = tr.shape_mesh(run)
    m = mesh.shape["model"]
    act = tr.B // (mesh.size // m) * tr.T * cfg.d_model * 4
    n = len(_blocks(cfg))
    _, f32_all = tr.fsdp_gathers(cfg, run + "_fsdp", "")
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
        # the weight-stationary steps gather fewer bytes than the
        # baseline's FSDP gathers
        assert steps[0][0]["all-gather"] < f32_all


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
    """At one rank every collective is a copy: under opt, opt2, opt3 and
    opt4 the forward, the prefill (logits, risk, every cache leaf) and the
    weight-stationary decode steps are the baseline's to the last bit
    (opt4's all-to-all MoE the einsum MoE's), and each bundle's train step
    is the baseline step with the same bf16 casts and remat (opt3's
    without remat is opt's: remat changes no bit)."""
    cfg = get_smoke_config(case)
    f32 = torch.float32
    tok = torch.tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 8)))

    def placed(kw=None):
        c = cfg
        if cfg.moe is not None and (kw or {}).get("moe_impl"):
            c = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, impl=kw["moe_impl"]))
        return parallel.parallelize(Model(c, device="cpu", seed=4),
                                    world_of_one)

    model = placed()
    with torch.no_grad():
        want = model(tok, compute_dtype=f32)
        wp, wc = model.prefill(tok, cache_capacity=12, compute_dtype=f32)
    trains = {}
    for variant in ("opt", "opt2", "opt3", "opt4"):
        pkw = dryrun.variant_build_kwargs(variant, "prefill", world_of_one)
        vmodel = placed(pkw)
        with torch.no_grad():
            got = vmodel(tok, compute_dtype=f32, act_pspec=pkw["act_pspec"])
            gp, gc = vmodel.prefill(tok, cache_capacity=12,
                                    compute_dtype=f32,
                                    act_pspec=pkw["act_pspec"])
        assert torch.equal(got.logits, want.logits)
        assert torch.equal(got.risk_score, want.risk_score)
        assert torch.equal(gp.logits, wp.logits)
        assert all(torch.equal(x, y) for a, b in zip(gc, wc)
                   for x, y in zip(a, b))
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
        trains[variant] = _train(placed(kw), world_of_one, tok,
                                 **{k: v for k, v in kw.items()
                                    if k != "moe_impl"})
    base = _train(placed(), world_of_one, tok, cast_params_bf16=True)
    for variant, (metrics, mu, params) in trains.items():
        assert metrics == base[0], variant
        assert all(torch.equal(mu[k], base[1][k]) for k in mu), variant
        assert all(torch.equal(params[k], base[2][k]) for k in params)


def test_refused_layouts_name_themselves(world_of_one):
    """The weight-stationary layout in a forward, a prefill or a train
    step raises naming the decode; ``opt4`` is ``opt`` with the
    all-to-all MoE for train and prefill and ``opt``'s decode (the
    weight-stationary decode of the Mamba and xLSTM models runs, above);
    a spec neither layout is, or one naming other data axes than the
    mesh's, raises naming itself; a sequence that does not divide over
    "model" raises with its sizes."""
    ws = dryrun.variant_build_kwargs("opt", "decode", world_of_one)
    assert ws["act_pspec"] == P(None, None, "data")
    for kind in ("train", "prefill", "decode"):
        opt = dryrun.variant_build_kwargs("opt", kind, world_of_one)
        opt4 = dryrun.variant_build_kwargs("opt4", kind, world_of_one)
        assert opt4 == (opt if kind == "decode"
                        else {**opt, "moe_impl": "a2a"}), kind
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
    for spec in (P("model", None, None), P(("pod", "data"), "model", None),
                 object()):
        with pytest.raises(ValueError, match="act_pspec"):
            model(tok, act_pspec=spec)
    mesh = mesh_lib.Mesh(("data", "model"), (1, 2))
    two = parallel.parallelize(Model(cfg, device="meta", seed=None), mesh)
    with pytest.raises(ValueError, match="T = 7"):
        two(torch.zeros((1, 7), dtype=torch.long, device="meta"),
            act_pspec=P("data", "model", None))
