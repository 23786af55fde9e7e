"""The port's one-card dry-run and roofline against the reference's.

* The analytic roofline terms (``model_flops``, ``analytic_flops``,
  ``analytic_hbm_bytes``) of ``repro_torch.launch.roofline`` equal the
  reference's on every (arch x applicable shape) cell, given the same
  parameter and cache bytes, and keep its ``TestAnalyticCosts`` invariants.
* The port's abstract (meta) parameters, AdamW moments and caches hold the
  bytes of the reference's ``jax.eval_shape`` bundles, cell by cell.
* Each family's smoke-config steps (train, prefill, decode) trace on meta
  to the reference's ``eval_shape`` output shapes.
* Each kernel wrapper's meta branch returns its plain version's shapes and
  dtypes, launches nothing and tallies the kernel's work by the formulas
  of its bound.
* The dry-run's extrapolation from one and two layer groups equals a trace
  of the whole depth; the CLI stands alone; the committed
  ``benchmarks/results/dryrun_h100`` cells are present and sane.

The reference's ``launch/dryrun.py`` sets ``XLA_FLAGS`` when imported, so
only its ``roofline`` and ``specs`` are imported here.
"""
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.launch import roofline as ref_roofline
from repro.launch import specs as ref_specs
from repro.launch.shardings import total_param_bytes as ref_bytes
from repro_torch.benchmarks import timing
from repro_torch.configs import (ARCH_IDS, SHAPES, InputShape,
                                 applicable_shapes, get_config,
                                 get_smoke_config)
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, report, roofline, specs
from repro_torch.models import layers

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELLS = [(arch, shape) for arch in ARCH_IDS
         for shape in applicable_shapes(arch)]


def test_thirty_eight_cells():
    assert len(CELLS) == 38


# ---------------------------------------------------------------------------
# analytic roofline terms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", CELLS)
def test_analytic_terms_equal_the_reference(arch, shape):
    cfg = specs.serving_config(arch, shape)
    ref_cfg = ref_specs.serving_config(arch, shape)
    assert cfg.sliding_window == ref_cfg.sliding_window
    s, ref_s = SHAPES[shape], ref_specs.SHAPES[shape]
    kind = s.kind
    pb, cb = 1.2345e12 * (1 + ARCH_IDS.index(arch)), 6.789e11
    pairs = [
        (roofline.model_flops(cfg, s, kind),
         ref_roofline.model_flops(ref_cfg, ref_s, kind)),
        (roofline.analytic_flops(cfg, s, kind),
         ref_roofline.analytic_flops(ref_cfg, ref_s, kind)),
        (roofline.analytic_hbm_bytes(cfg, s, kind, param_bytes=pb,
                                     cache_bytes=cb),
         ref_roofline.analytic_hbm_bytes(ref_cfg, ref_s, kind,
                                         param_bytes=pb, cache_bytes=cb)),
    ]
    for got, want in pairs:
        assert want > 0
        assert abs(got - want) <= 1e-12 * abs(want), (got, want)


class TestAnalyticCosts:
    """The reference's invariants (``tests/test_launch.py``) on the port."""

    def test_dense_flops_close_to_6nd(self):
        cfg = get_config("qwen3-8b")
        shape = SHAPES["train_4k"]
        f = roofline.analytic_flops(cfg, shape, "train")
        model = roofline.model_flops(cfg, shape, "train")
        assert 1.1 < f / model < 2.2

    def test_decode_flops_tiny_vs_prefill(self):
        cfg = get_config("qwen3-8b")
        f_dec = roofline.analytic_flops(cfg, SHAPES["decode_32k"], "decode")
        f_pre = roofline.analytic_flops(cfg, SHAPES["prefill_32k"],
                                        "prefill")
        assert f_dec < f_pre / 1000

    def test_sliding_window_caps_attention_context(self):
        cfg_full = get_config("qwen3-8b")
        cfg_win = specs.serving_config("qwen3-8b", "long_500k")
        assert cfg_win.sliding_window == 8192
        f_full = roofline.analytic_flops(cfg_full, SHAPES["long_500k"],
                                         "decode")
        f_win = roofline.analytic_flops(cfg_win, SHAPES["long_500k"],
                                        "decode")
        assert f_win < f_full

    def test_moe_active_not_total(self):
        cfg = get_config("olmoe-1b-7b")
        shape = SHAPES["prefill_32k"]
        f = roofline.analytic_flops(cfg, shape, "prefill")
        total_dense_equiv = (2.0 * cfg.param_count() * shape.global_batch
                             * shape.seq_len)
        assert f < 0.5 * total_dense_equiv

    def test_hbm_model_decode_dominated_by_params_and_cache(self):
        cfg = get_config("llama3-405b")
        pb, cb = 810e9, 1e12
        hbm = roofline.analytic_hbm_bytes(cfg, SHAPES["decode_32k"],
                                          "decode", param_bytes=pb,
                                          cache_bytes=cb)
        assert 0.9 * (pb + cb) < hbm < 1.3 * (pb + cb)


def test_roofline_uses_the_h100_rates_and_one_card():
    assert roofline.BF16_FLOPS is timing.BF16_FLOPS == 989e12
    assert roofline.HBM_BYTES_PER_S is timing.HBM_BYTES_PER_S == 3.35e12
    bundle = specs.build_step("qwen3-8b", "decode_32k")
    rep = roofline.analyze(bundle, {"flops": 1.0, "bytes": 2.0},
                           param_bytes_global=1e10, cache_bytes_global=1e11)
    assert rep.collective_s == 0.0 and rep.collective_bytes_per_chip == 0.0
    assert rep.collective_note == roofline.ONE_CARD
    assert rep.memory_s == pytest.approx(rep.bytes_per_chip / 3.35e12)
    assert rep.compute_s == pytest.approx(rep.flops_per_chip / 989e12)
    assert rep.bottleneck == "memory"
    assert (rep.counted_flops, rep.counted_bytes) == (1.0, 2.0)
    with pytest.raises(NotImplementedError, match="13f"):
        roofline.analyze(bundle, {}, chips=2)


# ---------------------------------------------------------------------------
# abstract arguments against the reference's eval_shape bundles
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_params():
    """The reference's abstract bf16 parameters by arch, each made once
    (its ``build_step`` makes them again for every cell), and its model."""
    from repro.models.model import Model as RefModel

    memo = {}

    def get(arch, shape):
        # the parameters do not depend on the shape's sliding window
        model = RefModel(ref_specs.serving_config(arch, shape))
        if arch not in memo:
            memo[arch] = ref_specs._abstract_params(model, jnp.bfloat16)
        return memo[arch], model

    return get


def _numel(tree) -> int:
    return sum(math.prod(leaf.shape) for leaf in jax.tree.leaves(tree))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_abstract_argument_bytes_equal_the_reference(arch, shape, ref_params):
    bundle = specs.build_step(arch, shape)
    s = SHAPES[shape]
    assert all(t.device.type == "meta"
               for t in specs.tensors_of(bundle.abstract_args))
    params, model = ref_params(arch, shape)
    if s.kind == "train":
        # the reference trains float32 parameters with float32 AdamW
        # moments, leaf for leaf the shapes of its bf16 parameters
        state = bundle.abstract_args[0]
        for tree in (state.params, state.opt.mu, state.opt.nu):
            assert {t.dtype for t in tree.values()} == {torch.float32}
            assert specs.total_param_bytes(tree) == 4 * _numel(params)
        return
    assert specs.total_param_bytes(bundle.abstract_args[0]) == \
        ref_bytes(params)
    if s.kind == "decode":
        cache = ref_specs._abstract_cache(model, s.global_batch, s.seq_len)
        assert specs.total_param_bytes(bundle.abstract_args[1]) == \
            ref_bytes(cache)


def test_reference_trains_float32_parameters_and_moments():
    """What the train cells above take of the reference, on one arch:
    its float32 parameters and moments are 4 bytes a bf16 leaf's
    element."""
    from repro.models.model import Model as RefModel

    model = RefModel(ref_specs.serving_config("qwen3-8b", "train_4k"))
    p32 = ref_specs._abstract_params(model, jnp.float32)
    p16 = ref_specs._abstract_params(model, jnp.bfloat16)
    opt = jax.eval_shape(ref_specs.make_optimizer().init, p32)
    assert {leaf.dtype for leaf in jax.tree.leaves((p32, opt.mu, opt.nu))} \
        == {jnp.dtype(jnp.float32)}
    assert ref_bytes(p32) == ref_bytes(opt.mu) == ref_bytes(opt.nu) \
        == 4 * _numel(p16)


def test_mesh_options_raise():
    with pytest.raises(NotImplementedError, match="13f"):
        specs.build_step("qwen3-8b", "decode_32k", act_pspec=("data",))
    with pytest.raises(NotImplementedError, match="11b"):
        specs.build_step("olmoe-1b-7b", "prefill_32k", moe_impl="a2a")


# ---------------------------------------------------------------------------
# smoke-config steps traced on meta against the reference's eval_shape
# ---------------------------------------------------------------------------

SMOKE_T, SMOKE_B = 16, 2


def _leaves(tree) -> list[tuple[tuple[int, ...], str]]:
    """Sorted (shape, dtype) of every array or tensor in ``tree``."""
    if isinstance(tree, (torch.Tensor, jax.ShapeDtypeStruct)) or hasattr(
            tree, "dtype") and hasattr(tree, "shape"):
        return [(tuple(tree.shape),
                 str(tree.dtype).replace("torch.", ""))]
    leaves = [x for x in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, torch.Tensor))]
    return sorted(leaf for x in leaves for leaf in _leaves(x))


def _ref_step_shapes(arch, kind, monkeypatch):
    shape = ref_specs.InputShape(f"smoke_{kind}", SMOKE_T, SMOKE_B, kind)
    monkeypatch.setitem(ref_specs.SHAPES, shape.name, shape)
    monkeypatch.setattr(ref_specs, "serving_config",
                        lambda arch, name: ref_smoke_config(arch))
    bundle = ref_specs.build_step(arch, shape.name)
    return jax.eval_shape(bundle.step_fn, *bundle.abstract_args)


SMOKE_STEPS = [(arch, kind) for arch in ARCH_IDS
               for kind in ("train", "prefill", "decode")
               if kind != "decode" or get_smoke_config(arch).has_decode]


@pytest.mark.parametrize("arch,kind", SMOKE_STEPS)
def test_smoke_step_traces_to_the_reference_shapes(arch, kind, monkeypatch):
    want = _ref_step_shapes(arch, kind, monkeypatch)
    bundle = specs.build_step(arch, InputShape(f"smoke_{kind}", SMOKE_T,
                                               SMOKE_B, kind),
                              cfg=get_smoke_config(arch))
    got = bundle.step_fn(*bundle.abstract_args)
    if kind == "train":
        (state, metrics), (ref_state, ref_metrics) = got, want
        assert _leaves(tuple(metrics)) == _leaves(tuple(ref_metrics))
        assert specs.total_param_bytes(state.params) == \
            ref_bytes(ref_state.params)
        assert specs.total_param_bytes((state.opt.mu, state.opt.nu)) == \
            ref_bytes((ref_state.opt.mu, ref_state.opt.nu))
        assert all(t.device.type == "meta"
                   for t in specs.tensors_of(state.params))
        return
    assert set(got) == set(want)
    for key in got:
        assert _leaves(got[key]) == _leaves(want[key]), key


# ---------------------------------------------------------------------------
# the kernels' meta branches
# ---------------------------------------------------------------------------

def _scan_inputs(b=2, t=70, c=8, n=4):
    rng = np.random.default_rng(0)
    f = lambda *s: torch.tensor(rng.normal(0, 0.3, s), dtype=torch.float32)
    return (f(b, t, c).abs(), f(b, t, c), f(b, t, n), f(b, t, n),
            -f(c, n).abs(), f(b, c, n))


def _qmap(dev):
    s = torch.linspace(0, 1, 36, device=dev).reshape(4, 9)
    q = torch.linspace(0, 1, 16, device=dev)
    return ops.quantile_map(s, q, q)


def _spipe(dev):
    s = torch.rand(4, 7, 3).to(dev)
    return ops.score_pipeline(s, torch.zeros(3, device=dev),
                              torch.ones(3, device=dev),
                              torch.linspace(0, 1, 16, device=dev),
                              torch.linspace(0, 1, 16, device=dev))


def _banked(dev):
    s = torch.rand(5, 6, 3).to(dev)
    tid = torch.zeros(5, 6, dtype=torch.int64).to(dev)
    qs = torch.linspace(0, 1, 16).repeat(4, 1).to(dev)
    return ops.score_pipeline_banked(s, tid, torch.zeros(4, 3, device=dev),
                                     torch.ones(4, 3, device=dev), qs, qs)


def _flash(dev):
    q = torch.randn(2, 40, 4, 16).to(dev)
    kv = torch.randn(2, 40, 2, 16).to(dev)
    return ops.flash_attention(q, kv, kv, causal=True, sliding_window=9)


def _decode(dev):
    q = torch.randn(2, 4, 16).to(dev)
    kv = torch.randn(2, 30, 2, 16).to(dev)
    return ops.decode_attention(q, kv, kv, [30, 30])


def _scan(dev):
    return ops.selective_scan(*(x.to(dev) for x in _scan_inputs()))


def _scan_grad(dev):
    ins = [x.to(dev).requires_grad_(True) for x in _scan_inputs()]
    with torch.enable_grad():
        y, h = ops.selective_scan(*ins)
        grads = torch.autograd.grad((y.sum(), h.sum()), ins)
    return (y.detach(), h.detach(), *grads)


# name -> (call, the kernels its tally names, their work from timing.py)
META_CASES = {
    "quantile_map": (_qmap, {"quantile_map": timing.quantile_map_work(
        36, 16, 4)}),
    "score_pipeline": (_spipe, {"score_pipeline":
                                timing.score_pipeline_work(28, 3, 16, 4)}),
    "score_pipeline_banked": (_banked, {"score_pipeline_banked":
                                        timing.banked_work(30, 3, 4, 16)}),
    "flash_attention": (_flash, {"flash_attention": timing.attention_work(
        2, 40, 40, 4, 2, 16, True, 9, 4)}),
    "decode_attention": (_decode, {"decode_attention": timing.decode_work(
        [30, 30], 4, 2, 16, 4)}),
    "selective_scan": (_scan, {"selective_scan": (
        lambda e, o, n: (e + o, n))(*timing.selective_scan_work(
            2, 70, 8, 4, h0=True))}),
    "selective_scan_backward": (_scan_grad, {
        "selective_scan": (lambda e, o, n: (e + o, n))(
            *timing.selective_scan_work(2, 70, 8, 4, h0=True)),
        "selective_scan_bwd": (lambda e, o, n: (e + o, n))(
            *timing.selective_scan_bwd_work(2, 70, 8, 4, dh_t=True))}),
}


@pytest.mark.parametrize("name", sorted(META_CASES))
def test_meta_branch_shapes_no_launch_and_tally(name):
    call, work = META_CASES[name]
    torch.manual_seed(0)
    want = call(torch.device("cpu"))
    before = dict(ops.LAUNCHES)
    torch.manual_seed(0)
    with ops.meta_work() as tally:
        got = call(torch.device("meta"))
    assert ops.LAUNCHES == before
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert [(g.shape, g.dtype, g.device.type) for g in got] == \
        [(w.shape, w.dtype, "meta") for w in want]
    assert set(tally) == set(work)
    for kernel, (flops, nbytes) in work.items():
        assert tally[kernel] == {"calls": 1, "flops": flops,
                                 "bytes": nbytes}
    # no tally open: nothing recorded anywhere
    call(torch.device("meta"))
    assert ops._TALLIES == []


def test_selective_scan_state_out_on_meta():
    dt, x, bm, cm, a, h0 = (t.to("meta") for t in _scan_inputs(t=1))
    y, h = ops.selective_scan(dt, x, bm, cm, a, h0, state_out=h0)
    assert h is h0 and y.shape == x.shape


# ---------------------------------------------------------------------------
# M-RoPE section index: bitwise as it was, and it traces on meta
# ---------------------------------------------------------------------------

def test_mrope_angles_bitwise_and_on_meta():
    cfg = get_smoke_config("qwen2-vl-7b")
    rng = np.random.default_rng(0)
    pos = torch.tensor(rng.integers(0, 500, (3, 2, 11)))
    got = layers.mrope_angles(pos, cfg.head_dim, cfg.rope_theta,
                              cfg.mrope_sections)
    # the construction it replaces: repeat_interleave by the section sizes
    half = cfg.head_dim // 2
    inv = layers.rope_frequencies(cfg.head_dim, cfg.rope_theta)
    ang = torch.movedim(pos[..., None].to(torch.float32) * inv, 0, -1)
    sec = torch.repeat_interleave(torch.arange(3),
                                  torch.tensor(cfg.mrope_sections))
    want = torch.gather(ang, -1, sec.view(1, 1, half, 1).expand(
        *ang.shape[:3], 1))[..., 0]
    assert torch.equal(got, want)
    full = get_config("qwen2-vl-7b")
    meta = layers.mrope_angles(pos.to("meta"), full.head_dim,
                               full.rope_theta, full.mrope_sections)
    assert meta.shape == (2, 11, full.head_dim // 2)


# ---------------------------------------------------------------------------
# the dry-run: extrapolation, the CLI, the committed cells
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kind", [("qwen3-8b", "prefill"),
                                       ("jamba-1.5-large-398b", "decode"),
                                       ("olmoe-1b-7b", "train")])
def test_extrapolated_counts_equal_a_whole_trace(arch, kind):
    cfg = get_smoke_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=3 * len(cfg.layer_pattern))
    shape = InputShape("s", 24, 2, kind)
    ex = dryrun.count_step(arch, shape, cfg=cfg)
    assert ex["traced_groups"] == [1, 2]
    full = dryrun.trace(specs.build_step(arch, shape, cfg=cfg))
    for key in ("flops", "bytes", "output_bytes", "argument_bytes",
                "kernels"):
        assert ex[key] == full[key], key
    # the peak is extrapolated: at least the whole trace's, within 10%
    assert full["temp_bytes"] <= ex["temp_bytes"] <= 1.1 * full["temp_bytes"]


def test_dryrun_cli_stands_alone(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.modules['jax'] = None\n"
         "from repro_torch.launch import dryrun\n"
         "dryrun.main(sys.argv[1:])\n"
         "assert not [m for m in sys.modules if m == 'repro' "
         "or m.startswith('repro.')]",
         "--arch", "qwen3-8b", "--shape", "long_500k", "--out",
         str(tmp_path)],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr
    (path,) = tmp_path.glob("*.json")
    assert path.name == "qwen3-8b__long_500k__h100.json"
    cell = json.loads(path.read_text())
    assert cell["device"] == "meta" and cell["kind"] == "decode"
    assert cell["roofline"]["bottleneck"] == "memory"
    bundle = specs.build_step("qwen3-8b", "long_500k")
    assert cell["memory_analysis"]["argument_bytes"] == \
        specs.total_param_bytes(bundle.abstract_args)


class TestDryrunResults:
    """The committed cells, as the reference's ``TestDryrunResults``
    checks its own."""

    def test_all_cells_present_and_sane(self):
        rows = report.load()
        assert sorted((r["arch"], r["shape"]) for r in rows) == sorted(CELLS)
        for r in rows:
            rf = r["roofline"]
            assert rf["compute_s"] >= 0 and rf["collective_s"] == 0
            assert r["memory_analysis"]["temp_bytes"] is not None
            assert r["memory_analysis"]["argument_bytes"] > 0
            assert 0.1 < rf["useful_flops_ratio"] <= 1.2, (
                r["arch"], r["shape"], rf["useful_flops_ratio"])
            assert rf["counted_flops"] is None or rf["counted_flops"] > 0
            cfg = specs.serving_config(r["arch"], r["shape"])
            s = SHAPES[r["shape"]]
            assert rf["flops_per_chip"] == roofline.analytic_flops(
                cfg, s, s.kind)
            assert rf["bytes_per_chip"] == roofline.analytic_hbm_bytes(
                cfg, s, s.kind, param_bytes=r["param_bytes"],
                cache_bytes=r["cache_bytes"])

    def test_decode_cells_memory_bound(self):
        for r in report.load():
            if r["kind"] == "decode":
                assert r["roofline"]["bottleneck"] == "memory"

    def test_report_renders_both_tables(self):
        rows = report.load()
        roof = report.roofline_table(rows)
        dry = report.dryrun_table(rows)
        assert roof.count("\n") == dry.count("\n") == 39
        assert "collect" not in roof + dry
        assert "qwen3-8b | decode_32k" in roof
