"""AdamW + the cosine schedule, op for op as the reference's
``training/optimizer.py``.

The parameters, gradients and moments are dicts of tensors keyed alike
(``dict(model.named_parameters())`` in the trainer).  Unlike the
reference, which returns new trees, :meth:`AdamW.update` writes the new
parameters and moments into the tensors it is given and returns them: at
jamba-1.5-large's first layer one more copy of the parameters is 8.4 GB.
The elementwise work is plain torch ops, leaf by leaf, as it is XLA (not
Pallas) in the reference.  ``moment_dtype`` allows bf16 moments.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from repro_torch.launch import collectives as coll
from repro_torch.models.parallel import spec_axes

Tree = dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32
    mu: Tree             # first moments
    nu: Tree             # second moments


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def global_norm(grads: Tree, specs=None, mesh=None) -> torch.Tensor:
    """sqrt of the float32 sum of squares over every leaf, the leaves added
    in order (the reference's ``sum`` over ``jax.tree.leaves``).

    Over a mesh, ``grads`` are a rank's blocks and ``specs`` their
    ``PartitionSpec``s by name: each leaf's sum of squares is summed over
    exactly the axes it is sharded on (a replicated leaf counted once),
    the leaves sharded alike packed in one all-reduce an axis, before
    the leaves are added in order."""
    sq = [torch.sum(torch.square(_f32(g))) for g in grads.values()]
    if specs is not None:
        groups: dict[tuple[str, ...], list[int]] = {}
        for i, name in enumerate(grads):
            axes = spec_axes(specs[name])
            if axes:
                groups.setdefault(axes, []).append(i)
        for axes, idx in groups.items():
            packed = torch.stack([sq[i] for i in idx])
            for a in axes:
                packed = coll.all_reduce_raw(packed, mesh, a)
            for j, i in enumerate(idx):
                sq[i] = packed[j]
    gsq = 0
    for s in sq:
        gsq = gsq + s
    return torch.sqrt(gsq)


def matrix_leaves(params: Tree) -> set[str]:
    """The leaves the reference's ``ndim >= 2`` rules (AdamW's weight decay,
    ``cast_params_bf16``) take.  It stacks every leaf of the layer stack
    over a leading ``n_groups`` axis, so those rules take each leaf of the
    port's ``stack.*`` (norm scales and biases too) and, elsewhere, the
    leaves of ``ndim >= 2``."""
    return {k for k, p in params.items()
            if p.dim() >= 2 or k.startswith("stack.")}


def _blend(moment: torch.Tensor, beta: float, term: torch.Tensor) -> None:
    """``moment <- beta · moment + term`` in float32, stored in the
    moment's dtype (in place for a float32 moment)."""
    if moment.dtype == torch.float32:
        moment.mul_(beta).add_(term)
    else:
        moment.copy_(_f32(moment) * beta + term)


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: float | Callable[[torch.Tensor], torch.Tensor] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    moment_dtype: torch.dtype = torch.float32

    def init(self, params: Tree) -> AdamWState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=self.moment_dtype,
                               device=p.device)
        device = next(iter(params.values())).device
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            mu={k: zeros(p) for k, p in params.items()},
            nu={k: zeros(p) for k, p in params.items()})

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.learning_rate):
            return self.learning_rate(step).to(torch.float32)
        return torch.tensor(self.learning_rate, dtype=torch.float32,
                            device=step.device)

    @torch.no_grad()
    def update(self, grads: Tree, state: AdamWState, params: Tree, *,
               gnorm: torch.Tensor) -> tuple[Tree, AdamWState]:
        """One step from ``grads`` (a missing or None leaf counts as zeros,
        as ``jax.grad`` gives an unused parameter): global-norm clipping,
        moments updated in float32 and stored in ``moment_dtype``, bias
        corrections from the float32 step, weight decay on
        :func:`matrix_leaves` only, each new parameter cast back to its
        dtype.  Writes ``params``, ``state.mu`` and ``state.nu`` in
        place.  ``gnorm`` is the clipping norm, :func:`global_norm` of
        the whole gradients: a sharded step's over the ranks, which only
        the caller knows."""
        step = state.step + 1
        grads = {k: (grads.get(k) if grads.get(k) is not None
                     else torch.zeros_like(p)) for k, p in params.items()}
        scale = None
        if self.grad_clip_norm > 0:
            scale = torch.clamp(self.grad_clip_norm / (gnorm + 1e-9),
                                max=1.0)
        b1, b2 = self.b1, self.b2
        step_f = step.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                         device=step.device), step_f)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=step.device), step_f)
        lr = self._lr(step)
        decay = matrix_leaves(params) if self.weight_decay > 0 else set()
        # leaf by leaf, in place where the dtype allows, each op the
        # reference's in its order: no full copy of the gradients, moments
        # or parameters is made
        for k, p in params.items():
            g = grads[k]
            if scale is not None:
                g = g * scale.to(g.dtype)
            g32 = _f32(g)
            _blend(state.mu[k], b1, g32 * (1 - b1))
            _blend(state.nu[k], b2, torch.square(g32) * (1 - b2))
            delta = _f32(state.mu[k]) / bc1
            denom = _f32(state.nu[k]) / bc2
            delta.div_(denom.sqrt_().add_(self.eps))
            del denom
            if k in decay:
                delta.add_(self.weight_decay * _f32(p))
            if p.dtype == torch.float32:
                p.sub_(delta.mul_(lr))
            else:
                p.copy_(_f32(p) - lr * delta)
        state.step.copy_(step)
        return params, state


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warm-up to ``peak_lr`` over ``warmup_steps``, then a cosine
    down to ``final_frac · peak_lr`` at ``total_steps``; float32 math on
    the step tensor, as the reference's."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 *
                         (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr
