"""The port's training (``training/``, ``launch/train.py``,
``examples/train_fraud_scorer.py``) against the JAX package, on the CPU;
the train step against the reference's is in
``test_torch_training_reference.py``.

* AdamW given the SAME numpy gradients as the reference's: parameters and
  both moments within 1e-6 over three steps, with and without global-norm
  clipping, float32 and bf16 moments (weight decay on matrices only), and
  ``cosine_schedule`` at warm-up, the middle and the end.
* ``Trainer.fit``: a 3-step history against the reference's within rtol
  2e-5.
* The serve paths build no graph; ``attn_impl="kernel"`` under grad on
  CPU tensors runs the plain version with the reference path's gradients.
* The launcher and the example (with resume) in subprocesses, each with
  one intra-op thread: beside busy test workers, an intra-op pool as wide
  as the machine stalls in its barriers and multiplies the example's
  time.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models.model import Model as JModel
from repro.training import optimizer as j_opt
from repro.training import train as j_train
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.models.model import Model
from repro_torch.training import (AdamW, Trainer, cosine_schedule,
                                  make_train_step)
from repro_torch.training.data import TokenStream
from repro_torch.training.train import make_loss_fn

ROOT = pathlib.Path(__file__).resolve().parents[1]
LR = 1e-3


def _tree_np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


# ---------------------------------------------------------------- AdamW
def _adam_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32),
            "e": rng.standard_normal((3, 4, 2)).astype(np.float32)}


@pytest.mark.parametrize("clip", [1.0, 0.0])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_matches_reference(clip, moments):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[moments]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[moments]
    sched = dict(peak_lr=0.01, warmup_steps=2, total_steps=5)
    jo = j_opt.AdamW(learning_rate=j_opt.cosine_schedule(**sched),
                     grad_clip_norm=clip, moment_dtype=jdt)
    to = AdamW(learning_rate=cosine_schedule(**sched), grad_clip_norm=clip,
               moment_dtype=tdt)
    jp = jax.tree.map(jnp.asarray, _adam_tree(0))
    tp = {k: torch.tensor(v) for k, v in _adam_tree(0).items()}
    js, ts = jo.init(jp), to.init(tp)
    for step in range(3):
        g = {k: v * 3.0 for k, v in _adam_tree(10 + step).items()}
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = to.update({k: torch.tensor(v) for k, v in g.items()}, ts,
                           tp)
        assert int(ts.step) == int(js.step) == step + 1
        for k in tp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6)
            for tm, jm in ((ts.mu, js.mu), (ts.nu, js.nu)):
                assert tm[k].dtype == tdt
                np.testing.assert_allclose(
                    tm[k].float().numpy(),
                    np.asarray(jm[k].astype(jnp.float32)), rtol=1e-6,
                    atol=1e-6)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 55, 100, 150])
def test_cosine_schedule_matches_reference(step):
    want = j_opt.cosine_schedule(3e-3, 10, 100)(jnp.asarray(step, jnp.int32))
    got = cosine_schedule(3e-3, 10, 100)(torch.tensor(step,
                                                      dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-7)


def test_weight_decay_leaves_vectors_alone():
    """A zero gradient: only the matrix decays."""
    opt = AdamW(learning_rate=0.1, weight_decay=0.5)
    params = {"m": torch.ones(2, 2), "v": torch.ones(2)}
    params, _ = opt.update({}, opt.init(params), params)
    assert torch.equal(params["v"], torch.ones(2))
    torch.testing.assert_close(params["m"], torch.full((2, 2), 0.95))


def test_fit_history_matches_reference():
    arch = "jamba-1.5-large-398b"
    jm = JModel(j_smoke(arch))
    params = jm.init(jax.random.key(7))
    start = _tree_np(params)          # the reference's fit donates params
    jo = j_opt.AdamW(learning_rate=j_opt.cosine_schedule(LR, 1, 3))
    want = j_train.Trainer(jm, jo, remat=True, compute_dtype=jnp.float32
                           ).fit(j_train.TrainState(params, jo.init(params)),
                                 iter(TokenStream(512, 16, 2)), num_steps=3,
                                 log_every=1, log_fn=lambda s: None)[1]
    cfg = get_smoke_config(arch)
    model = convert.model_from_numpy(cfg, start, device="cpu")
    trainer = Trainer(model, AdamW(learning_rate=cosine_schedule(LR, 1, 3)),
                      remat=True, compute_dtype=torch.float32)
    lines = []
    state, got = trainer.fit(trainer.init_state(None),
                             iter(TokenStream(512, 16, 2)), num_steps=3,
                             log_every=1, log_fn=lines.append)
    assert len(lines) == 3 and lines[0].startswith("step     1  loss ")
    assert [r["step"] for r in got] == [1, 2, 3]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in ("loss", "ce", "moe_aux", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=2e-5)
    assert int(state.opt.step) == 3


def test_act_pspec_raises_naming_13f():
    model = Model(get_smoke_config("qwen3-8b"), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 13f"):
        make_train_step(model, AdamW(), act_pspec=object())


def test_serving_builds_no_graph():
    model = Model(get_smoke_config("jamba-1.5-large-398b"), device="cpu")
    tok = torch.zeros((1, 8), dtype=torch.long)
    out = model(tok, compute_dtype=torch.float32)
    assert not out.logits.requires_grad
    state = Trainer(model, AdamW()).init_state(3)
    assert all(p.requires_grad for p in state.params.values())
    served, _ = model.prefill(tok, cache_capacity=8,
                              compute_dtype=torch.float32)
    assert not served.logits.requires_grad


def test_kernel_branch_on_cpu_differentiates_like_the_reference_path():
    """Prompts of 128+ tokens take ``ops.flash_attention``: on CPU tensors
    its plain version, whose gradients equal the chunked path's."""
    cfg = dataclasses.replace(get_smoke_config("qwen3-8b"), n_layers=1)
    model = Model(cfg, device="cpu", seed=2)
    state = Trainer(model, AdamW()).init_state(None)
    toks = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 130)))
    grads = {}
    for impl in ("reference", "kernel"):
        loss, _ = make_loss_fn(model, remat=False, attn_impl=impl,
                               compute_dtype=torch.float32)(
            state.params, toks, toks)
        grads[impl] = torch.autograd.grad(loss, list(state.params.values()),
                                          allow_unused=True)
    for a, b in zip(grads["reference"], grads["kernel"]):
        if a is not None:
            torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-7)


def _run(*args):
    return subprocess.run(
        [sys.executable, "-m", *args], capture_output=True, text=True,
        timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"})


def test_train_launcher_runs_on_the_cpu():
    proc = _run("repro_torch.launch.train", "--arch", "jamba-1.5-large-398b",
                "--smoke", "--device", "cpu", "--steps", "10", "--batch",
                "4", "--seq", "32")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0].startswith("device: cpu  arch: jamba-1.5-large-398b")
    assert lines[-1] == "done" and len(lines) == 12
    losses = [float(ln.split()[3]) for ln in lines[1:-1]]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_train_fraud_scorer_trains_and_resumes(tmp_path):
    args = ("repro_torch.examples.train_fraud_scorer", "--device", "cpu",
            "--steps", "20", "--batch", "8", "--seq", "32", "--ckpt-dir",
            str(tmp_path))
    first = _run(*args)
    assert first.returncode == 0, first.stderr
    summary = first.stdout.strip().splitlines()[-1].split()
    assert summary[0] == "loss" and float(summary[3]) < float(summary[1])
    assert sorted(os.listdir(tmp_path)) == ["10", "20"]
    second = _run(*args)
    assert second.returncode == 0, second.stderr
    assert "resumed params from checkpoint step 20" in second.stdout
    again = second.stdout.strip().splitlines()[-1].split()
    assert float(again[1]) < float(summary[1])
