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
import torch.nn.functional as F

from repro_torch.launch.mesh import (TENSOR_PARALLEL, TRAIN_ACROSS_RANKS,
                                     get_active_mesh)
from repro_torch.models import layers
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


ACT_PSPEC = ("sharded activations (act_pspec) are not ported yet: "
             + TENSOR_PARALLEL)


def _bf16_casts(params: Tree) -> Tree:
    """float32 ``matrix_leaves`` cast to bf16 (differentiably, so the
    gradients reach the float32 masters); the rest as they are."""
    cast = matrix_leaves(params)
    return {k: p.to(torch.bfloat16)
            if p.dtype == torch.float32 and k in cast else p
            for k, p in params.items()}


def make_loss_fn(model: Model, *, aux_weight: float = 0.01,
                 remat: bool = True, compute_dtype=torch.bfloat16,
                 attn_impl: str = "reference", act_pspec=None,
                 cast_params_bf16: bool = False):
    """``loss_fn(params, tokens, labels) -> (loss, (ce, moe_aux))``: the
    model run on ``params`` (its parameters by name), float32 logits,
    ``ce`` the negated mean log-probability of the labels, ``loss = ce +
    aux_weight · moe_aux``."""
    if act_pspec is not None:
        raise NotImplementedError(ACT_PSPEC)

    def loss_fn(params: Tree, tokens: torch.Tensor, labels: torch.Tensor):
        if cast_params_bf16:
            params = _bf16_casts(params)
        # an encoder's tokens stand in for its frame features, as in the
        # reference (its frontend stub embeds them through the token table)
        with layers.parameters_as(model, params):
            out = model.forward(tokens, remat=remat,
                                compute_dtype=compute_dtype,
                                attn_impl=attn_impl)
        logp = F.log_softmax(out.logits.to(torch.float32), dim=-1)
        ce = -torch.mean(torch.gather(logp, -1, labels[..., None].long()))
        loss = ce + aux_weight * out.moe_aux
        return loss, (ce, out.moe_aux)

    return loss_fn


def make_train_step(model: Model, optimizer: AdamW, *,
                    aux_weight: float = 0.01, remat: bool = True,
                    compute_dtype=torch.bfloat16,
                    attn_impl: str = "reference", act_pspec=None,
                    cast_params_bf16: bool = False
                    ) -> Callable[[TrainState, torch.Tensor, torch.Tensor],
                                  tuple[TrainState, StepMetrics]]:
    """``train_step(state, tokens, labels) -> (state, metrics)``: the loss
    and its gradients with respect to ``state.params`` (a parameter the
    loss does not reach gets zeros, as from ``jax.grad``), their global
    norm, then AdamW, which writes the parameters and moments in place."""
    loss_fn = make_loss_fn(model, aux_weight=aux_weight, remat=remat,
                           compute_dtype=compute_dtype, attn_impl=attn_impl,
                           act_pspec=act_pspec,
                           cast_params_bf16=cast_params_bf16)

    def train_step(state: TrainState, tokens: torch.Tensor,
                   labels: torch.Tensor) -> tuple[TrainState, StepMetrics]:
        mesh = get_active_mesh()
        if mesh is not None and mesh.size > 1:
            raise NotImplementedError(
                "a train step over several ranks needs the gradient "
                f"all-reduce of the replicated leaves: {TRAIN_ACROSS_RANKS}")
        names = list(state.params)
        with torch.enable_grad():
            loss, (ce, aux) = loss_fn(state.params, tokens, labels)
            found = torch.autograd.grad(
                loss, [state.params[k] for k in names], allow_unused=True)
        grads = {k: torch.zeros_like(state.params[k]) if g is None else g
                 for k, g in zip(names, found)}
        del found
        gnorm = global_norm(grads)
        params, opt = optimizer.update(grads, state.opt, state.params)
        return (TrainState(params, opt),
                StepMetrics(loss.detach(), ce.detach(), aux.detach(), gnorm))

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
