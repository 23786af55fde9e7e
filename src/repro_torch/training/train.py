"""Training loop: the train step (loss, gradients, AdamW) and the trainer,
as the reference's ``training/train.py``.

The reference jits a pure ``train_step`` over a parameter pytree.  Here the
model owns its parameters: ``TrainState.params`` is
``dict(model.named_parameters())`` (the model's own tensors, turned on for
grad by :meth:`Trainer.init_state`), the step runs the model's forward and
``torch.autograd.grad`` and AdamW updates those tensors in place.  On the
card the Mamba scan's forward and backward are hand-written kernels
(``kernels/ops.py::SelectiveScanFn``); attention in training takes the
``"reference"`` path, as the reference's trainer does, and the attention
kernels raise under grad.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator, NamedTuple

import numpy as np
import torch

from repro_torch.launch import collectives as coll
from repro_torch.launch.mesh import (MODEL_AXIS, data_axes,
                                     data_axis_size, get_active_mesh)
from repro_torch.models import layers, parallel
from repro_torch.models.model import Model
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optimizer import (AdamW, AdamWState, global_norm,
                                            matrix_leaves)

Tree = dict[str, torch.Tensor]


class TrainState(NamedTuple):
    params: Tree
    opt: AdamWState


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    ce_loss: torch.Tensor
    moe_aux: torch.Tensor
    grad_norm: torch.Tensor


def _bf16_casts(params: Tree) -> Tree:
    """float32 ``matrix_leaves`` cast to bf16 (differentiably, so the
    gradients reach the float32 masters); the rest as they are.  On a
    sharded model the cast is of the rank's block, before the FSDP
    gathers of ``parallel.weight``: they and the reduce-scatters of the
    gradients move bf16."""
    cast = matrix_leaves(params)
    return {k: p.to(torch.bfloat16)
            if p.dtype == torch.float32 and k in cast else p
            for k, p in params.items()}


class _CrossEntropy(torch.autograd.Function):
    """Megatron's vocab-parallel cross entropy: the negated mean
    log-probability of ``labels`` under float32 ``logits``, ``log Σ
    exp(x - max) - (x_label - max)``.  Where the logits are the rank's
    ``block`` (first entry, entries) of the vocabulary, the max, the
    label's logit and the sum of exponentials are all-reduced over
    "model".  One float32 copy of the logits is made and becomes the
    softmax in place, the one tensor the backward keeps: the gradient is
    (softmax - one-hot) over the count of labels, written into it."""

    @staticmethod
    def forward(ctx, logits, labels, block, mesh):
        x = logits.to(torch.float32, copy=True)
        idx = labels[..., None].long()
        hot = torch.ones(idx.shape, dtype=torch.float32, device=x.device)
        if block is not None:
            lo, rows = block
            idx = idx - lo
            inside = (idx >= 0) & (idx < rows)
            idx = torch.where(inside, idx, 0)
            hot = hot.masked_fill_(~inside, 0)
        mx = torch.amax(x, dim=-1, keepdim=True)
        picked = torch.gather(x, -1, idx) * hot
        if block is not None:
            mx = coll.all_reduce_raw(mx, mesh, MODEL_AXIS, op="max")
            picked = coll.all_reduce_raw(picked, mesh, MODEL_AXIS)
        total = torch.sum(x.sub_(mx).exp_(), dim=-1, keepdim=True)
        if block is not None:
            total = coll.all_reduce_raw(total, mesh, MODEL_AXIS)
        ctx.save_for_backward(x.div_(total), idx, hot)
        ctx.dtype = logits.dtype
        return torch.mean(torch.log(total) - (picked - mx))

    @staticmethod
    def backward(ctx, g):
        grad, idx, hot = ctx.saved_tensors
        grad.scatter_add_(-1, idx, -hot).mul_(g / idx.numel())
        return grad.to(ctx.dtype), None, None, None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  model: Model) -> torch.Tensor:
    """:class:`_CrossEntropy` of ``model``'s logits: over the rank's block
    of the vocabulary where the lm head is column parallel, else over the
    whole vocabulary with the same ops and no collective."""
    block = model.vocab_block()
    mesh = None if block is None else parallel.of(model).mesh
    return _CrossEntropy.apply(logits, labels, block, mesh)


def make_loss_fn(model: Model, *, aux_weight: float = 0.01,
                 remat: bool = True, compute_dtype=torch.bfloat16,
                 attn_impl: str = "reference", act_pspec=None,
                 cast_params_bf16: bool = False,
                 global_batch: int | None = None):
    """``loss_fn(params, tokens, labels) -> (loss, (ce, moe_aux))``: the
    model run on ``params`` (its parameters by name), float32 logits,
    ``ce`` the negated mean log-probability of the labels, ``loss = ce +
    aux_weight · moe_aux``.  ``global_batch`` and ``act_pspec``:
    ``Model.forward``'s (a spec the port does not take raises here)."""
    parallel.seq_mesh(model, act_pspec)

    def loss_fn(params: Tree, tokens: torch.Tensor, labels: torch.Tensor):
        if cast_params_bf16:
            params = _bf16_casts(params)
        # an encoder's tokens stand in for its frame features, as in the
        # reference (its frontend stub embeds them through the token table)
        with layers.parameters_as(model, params):
            out = model.forward(tokens, remat=remat,
                                compute_dtype=compute_dtype,
                                attn_impl=attn_impl, act_pspec=act_pspec,
                                global_batch=global_batch)
        ce = cross_entropy(out.logits, labels, model)
        loss = ce + aux_weight * out.moe_aux
        return loss, (ce, out.moe_aux)

    return loss_fn


def make_train_step(model: Model, optimizer: AdamW, *,
                    aux_weight: float = 0.01, remat: bool = True,
                    compute_dtype=torch.bfloat16,
                    attn_impl: str = "reference", act_pspec=None,
                    cast_params_bf16: bool = False,
                    global_batch: int | None = None
                    ) -> Callable[[TrainState, torch.Tensor, torch.Tensor],
                                  tuple[TrainState, StepMetrics]]:
    """``train_step(state, tokens, labels) -> (state, metrics)``: the loss
    and its gradients with respect to ``state.params`` (a parameter the
    loss does not reach gets zeros, as from ``jax.grad``), their global
    norm, then AdamW, which writes the parameters and moments in place.

    On a sharded model (``models/parallel.py``) ``tokens`` and ``labels``
    are the rank's rows and the step runs over the model's mesh (an
    active mesh must be that mesh); the metrics are the global batch's.
    ``global_batch`` equal to the rows: they are the whole batch on every
    rank (``parallel.data_rows``).
    An unsharded model under an active mesh of several ranks raises."""
    loss_fn = make_loss_fn(model, aux_weight=aux_weight, remat=remat,
                           compute_dtype=compute_dtype, attn_impl=attn_impl,
                           act_pspec=act_pspec,
                           cast_params_bf16=cast_params_bf16,
                           global_batch=global_batch)

    par = parallel.of(model)

    def train_step(state: TrainState, tokens: torch.Tensor,
                   labels: torch.Tensor) -> tuple[TrainState, StepMetrics]:
        active = get_active_mesh()
        if par is None and active is not None and active.size > 1:
            raise ValueError("a train step over several ranks takes a model "
                             "sharded by models.parallel.parallelize")
        if par is not None and active is not None and \
                active.shape != par.mesh.shape:
            raise ValueError(f"the model is sharded over {par.mesh.shape}, "
                             f"the active mesh is {active.shape}")
        mesh = None if par is None else par.mesh
        # each rank's loss over the data ranks' count: the sum over the
        # data axes is then the gradient of the global mean
        n_data = 1 if mesh is None else data_axis_size(mesh)
        names = list(state.params)
        with torch.enable_grad():
            loss, (ce, aux) = loss_fn(state.params, tokens, labels)
            found = torch.autograd.grad(
                loss / n_data, [state.params[k] for k in names],
                allow_unused=True)
        grads = {k: torch.zeros_like(state.params[k]) if g is None else g
                 for k, g in zip(names, found)}
        del found
        metrics = torch.stack([loss.detach(), ce.detach(), aux.detach()])
        if mesh is None:
            gnorm = global_norm(grads)
        else:
            metrics = metrics / n_data
            for a in data_axes(mesh):
                metrics = coll.all_reduce_raw(metrics, mesh, a)
            for k, g in grads.items():
                if not set(data_axes(mesh)) & set(
                        parallel.spec_axes(par.specs[k])):
                    for a in data_axes(mesh):
                        coll.all_reduce_(g, mesh, a)
            gnorm = global_norm(grads, par.specs, mesh)
        params, opt = optimizer.update(grads, state.opt, state.params,
                                       gnorm=gnorm)
        loss, ce, aux = metrics.unbind()
        return (TrainState(params, opt), StepMetrics(loss, ce, aux, gnorm))

    return train_step


@dataclasses.dataclass
class Trainer:
    model: Model
    optimizer: AdamW
    aux_weight: float = 0.01
    remat: bool = True
    compute_dtype: Any = torch.bfloat16
    checkpoint_dir: str | None = None
    checkpoint_every: int = 0

    def init_state(self, seed: int | torch.Generator | None) -> TrainState:
        """Draw the model's weights from ``seed`` (a seed or a generator on
        the model's device; None keeps the weights it has, e.g. loaded by
        ``convert.model_from_numpy``), turn its parameters on for grad and
        start AdamW.  The state's parameters are the model's own tensors."""
        if seed is not None:
            gen = seed if isinstance(seed, torch.Generator) else \
                torch.Generator(device=self.model.device).manual_seed(seed)
            self.model.reset_parameters(gen)
        self.model.requires_grad_(True)
        params = dict(self.model.named_parameters())
        return TrainState(params=params, opt=self.optimizer.init(params))

    def fit(self, state: TrainState,
            batches: Iterator[tuple[np.ndarray, np.ndarray]],
            num_steps: int, log_every: int = 10,
            log_fn=print) -> tuple[TrainState, list[dict]]:
        step_fn = make_train_step(
            self.model, self.optimizer, aux_weight=self.aux_weight,
            remat=self.remat, compute_dtype=self.compute_dtype)
        device = self.model.device
        history: list[dict] = []
        t0 = time.perf_counter()
        for step in range(1, num_steps + 1):
            tokens, labels = next(batches)
            state, metrics = step_fn(
                state, torch.as_tensor(tokens, dtype=torch.long,
                                       device=device),
                torch.as_tensor(labels, dtype=torch.long, device=device))
            if step % log_every == 0 or step == num_steps:
                rec = {
                    "step": step,
                    "loss": float(metrics.loss),
                    "ce": float(metrics.ce_loss),
                    "moe_aux": float(metrics.moe_aux),
                    "grad_norm": float(metrics.grad_norm),
                    "elapsed_s": time.perf_counter() - t0,
                }
                history.append(rec)
                log_fn(f"step {rec['step']:>5d}  loss {rec['loss']:.4f}  "
                       f"ce {rec['ce']:.4f}  gnorm {rec['grad_norm']:.3f}")
            if (self.checkpoint_dir and self.checkpoint_every
                    and step % self.checkpoint_every == 0):
                ckpt.save_checkpoint(self.checkpoint_dir, step, state.params,
                                     {"loss": float(metrics.loss)})
        return state, history
