"""The port's train step (``training/``, ``remat``) against the JAX
package's, on the CPU, from one module fixture: the reference's four smoke
train steps, jitted, computed once (the test files of training are two, so
that a run with one worker a file spreads them over two).

* The train step on the reference's converted weights at float32 compute,
  for internlm2-1.8b, olmoe-1b-7b, jamba-1.5-large-398b and xlstm-1.3b
  smoke: loss, ce, aux and grad_norm within rtol 1e-5; every gradient
  (``convert.model_to_numpy``) against ``jax.grad`` within 2e-5 of the
  leaf's largest entry; the parameters after the step within 1e-6 where
  |g| is at least 50 times that tolerance (at step 1 AdamW moves a
  parameter by lr·g/(|g| + eps), about lr·sign(g), so a gradient within
  rounding of 0 may flip it by 2·lr, and one a few tolerances from 0 may
  move it by a share of lr; those are left out).
* ``remat=True`` bitwise equal to ``remat=False``: loss and gradients.
* ``cast_params_bf16`` against the reference's at float32 compute (loss
  within 1e-5, gradients of its bf16 leaves within two bf16 ulps).
* AdamW's state and the parameter trees converted both ways.
"""
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
from repro_torch.training import AdamW, Trainer, make_train_step
from repro_torch.training.train import make_loss_fn

ARCHS = ("internlm2-1.8b", "olmoe-1b-7b", "jamba-1.5-large-398b",
         "xlstm-1.3b")
B, T = 2, 24
LR = 1e-3


def _tree_np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    return toks, labels


@pytest.fixture(scope="module")
def reference_steps():
    """arch -> the reference's params, batch, (loss, ce, aux), gradients,
    grad_norm and parameters after one AdamW step, float32 compute."""
    out = {}
    for arch in ARCHS:
        jm = JModel(j_smoke(arch))
        params = jm.init(jax.random.key(42))
        toks, labels = _batch(j_smoke(arch))
        opt = j_opt.AdamW(learning_rate=LR)
        loss_fn = j_train.make_loss_fn(jm, remat=False,
                                       compute_dtype=jnp.float32)
        (loss, (ce, aux)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params, jnp.asarray(toks),
                                    jnp.asarray(labels))
        step = jax.jit(j_train.make_train_step(jm, opt, remat=False,
                                               compute_dtype=jnp.float32))
        state, metrics = step(j_train.TrainState(params, opt.init(params)),
                              jnp.asarray(toks), jnp.asarray(labels))
        out[arch] = dict(params=_tree_np(params), toks=toks, labels=labels,
                         metrics=[float(v) for v in metrics],
                         value=(float(loss), float(ce), float(aux)),
                         grads=_tree_np(grads), after=_tree_np(state.params))
    return out


def _port(arch, ref, *, remat=False):
    cfg = get_smoke_config(arch)
    model = convert.model_from_numpy(cfg, ref["params"], device="cpu")
    trainer = Trainer(model, AdamW(learning_rate=LR), remat=remat,
                      compute_dtype=torch.float32)
    return cfg, model, trainer.init_state(None)


def _grads(model, state, toks, labels, *, remat):
    loss_fn = make_loss_fn(model, remat=remat, compute_dtype=torch.float32)
    loss, (ce, aux) = loss_fn(state.params, torch.tensor(toks).long(),
                              torch.tensor(labels).long())
    found = torch.autograd.grad(loss, list(state.params.values()),
                                allow_unused=True)
    return (loss, ce, aux), dict(zip(state.params, found))


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax_grad(arch, reference_steps):
    ref = reference_steps[arch]
    cfg, model, state = _port(arch, ref)
    value, grads = _grads(model, state, ref["toks"], ref["labels"],
                          remat=False)
    np.testing.assert_allclose([float(v.detach()) for v in value],
                               ref["value"],
                               rtol=1e-5, atol=1e-6)
    got = convert.model_to_numpy(cfg, model, grads)
    got_leaves, tree = jax.tree.flatten(got)
    want_leaves, want_tree = jax.tree.flatten(ref["grads"])
    assert tree == want_tree
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=2e-5 * max(np.abs(w).max(), 1e-6))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, reference_steps):
    ref = reference_steps[arch]
    cfg, model, state = _port(arch, ref)
    step = make_train_step(model, AdamW(learning_rate=LR), remat=False,
                           compute_dtype=torch.float32)
    state, metrics = step(state, torch.tensor(ref["toks"]).long(),
                          torch.tensor(ref["labels"]).long())
    np.testing.assert_allclose([float(v) for v in metrics], ref["metrics"],
                               rtol=1e-5, atol=1e-6)
    assert int(state.opt.step) == 1
    after = jax.tree.leaves(convert.model_to_numpy(cfg, model))
    for p, w, g in zip(after, jax.tree.leaves(ref["after"]),
                       jax.tree.leaves(ref["grads"])):
        clear = np.abs(g) > 50 * 2e-5 * np.abs(g).max()
        np.testing.assert_allclose(p[clear], w[clear], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bitwise_equal_to_no_remat(arch, reference_steps):
    ref = reference_steps[arch]
    _, model, state = _port(arch, ref)
    v0, g0 = _grads(model, state, ref["toks"], ref["labels"], remat=False)
    v1, g1 = _grads(model, state, ref["toks"], ref["labels"], remat=True)
    assert all(torch.equal(a, b) for a, b in zip(v0, v1))
    for k in g0:
        assert (g0[k] is None and g1[k] is None) or torch.equal(g0[k], g1[k])


def test_cast_params_bf16_matches_reference(reference_steps):
    arch = "jamba-1.5-large-398b"
    ref = reference_steps[arch]
    jm = JModel(j_smoke(arch))
    loss_fn = j_train.make_loss_fn(jm, remat=True, compute_dtype=jnp.float32,
                                   cast_params_bf16=True)
    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, ref["params"]), jnp.asarray(ref["toks"]),
        jnp.asarray(ref["labels"]))
    cfg, model, state = _port(arch, ref)
    t_loss, _ = make_loss_fn(model, remat=True, compute_dtype=torch.float32,
                             cast_params_bf16=True)(
        state.params, torch.tensor(ref["toks"]).long(),
        torch.tensor(ref["labels"]).long())
    assert not np.isclose(float(loss), ref["value"][0], rtol=1e-7)
    np.testing.assert_allclose(float(t_loss.detach()), float(loss),
                               rtol=1e-5)
    found = torch.autograd.grad(t_loss, list(state.params.values()),
                                allow_unused=True)
    got = jax.tree.leaves(convert.model_to_numpy(
        cfg, model, dict(zip(state.params, found))))
    for g, w in zip(got, jax.tree.leaves(_tree_np(grads))):
        # the gradient of a bf16 leaf is rounded to bf16 on both sides,
        # after sums taken in different orders: two bf16 ulps apart
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=2 ** -7,
                                   atol=2e-5 * max(np.abs(w).max(), 1e-6))


def test_adamw_state_and_trees_convert_both_ways(reference_steps):
    arch = "olmoe-1b-7b"
    ref = reference_steps[arch]
    cfg = get_smoke_config(arch)
    model = convert.model_from_numpy(cfg, ref["params"], device="cpu")
    back = convert.model_to_numpy(cfg, model)
    assert jax.tree.structure(back) == jax.tree.structure(ref["params"])
    assert all(np.array_equal(a, b) for a, b in
               zip(jax.tree.leaves(back), jax.tree.leaves(ref["params"])))
    jo = j_opt.AdamW(learning_rate=LR, moment_dtype=jnp.bfloat16)
    jp = jax.tree.map(jnp.asarray, ref["params"])
    _, js = jax.jit(jo.update)(jax.tree.map(jnp.asarray, ref["grads"]),
                               jo.init(jp), jp)
    state = convert.adamw_state_from_numpy(cfg, model,
                                           jax.tree.map(np.asarray, js))
    assert int(state.step) == 1
    assert set(state.mu) == set(dict(model.named_parameters()))
    assert all(v.dtype == torch.bfloat16 for v in state.nu.values())
    mu = convert.model_to_numpy(cfg, model, state.mu)
    for a, b in zip(jax.tree.leaves(mu), jax.tree.leaves(js.mu)):
        assert np.array_equal(a, np.asarray(b.astype(jnp.float32)))
