"""Abstract input specs and step functions for the one-card dry-run.

``build_step(arch, shape)`` builds the port's own step on the ``meta``
device (shapes and dtypes, no data, nothing allocated) and returns what
the dry-run (``launch/dryrun.py``) traces:

  train_4k     -> train_step(state, tokens, labels)   (AdamW, remat)
  prefill_32k  -> prefill_step(params, inputs)        [encoder: encode_step]
  decode_*     -> serve_step(params, cache, inputs, pos): ONE new token
                  against a seq_len KV cache / recurrent state.

The prefill and the decode step take the kernel branch (``attn_impl=
"kernel"``), as the serve launcher does, so the trace goes through the
kernels' wrappers, whose meta branch (``kernels/ops.py``) tallies their
work.  long_500k on dense/MoE/VLM decoders switches the config to the
sliding-window variant (window 8192), the sub-quadratic requirement; SSM /
hybrid archs run their native constant-state decode.

The reference's sharded activations (``act_pspec``) and its all-to-all
MoE need a mesh over several cards and raise here (ROADMAP Queue 1 items
13f and 11b).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES, InputShape
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.training.optimizer import AdamW
from repro_torch.training.train import ACT_PSPEC, TrainState, make_train_step

SLIDING_WINDOW_LONG = 8192


def serving_config(arch: str, shape_name: str) -> ModelConfig:
    """The (possibly shape-adapted) config used for this dry-run cell."""
    cfg = get_config(arch)
    if shape_name == "long_500k" and cfg.causal and cfg.arch_type not in (
        "ssm", "hybrid"
    ):
        # sub-quadratic requirement: bounded sliding-window KV cache
        cfg = dataclasses.replace(cfg, sliding_window=SLIDING_WINDOW_LONG)
    return cfg


@dataclasses.dataclass(frozen=True)
class StepBundle:
    """Everything the dry-run needs to trace one (arch x shape) cell."""

    arch: str
    shape: InputShape
    cfg: ModelConfig
    model: Model
    step_fn: Callable
    abstract_args: tuple            # meta tensors (and pos), step_fn(*args)
    kind: str                        # "train" | "prefill" | "decode"


def tensors_of(tree: Any) -> list[torch.Tensor]:
    """Every tensor in a nest of dicts, lists, tuples and NamedTuples."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for leaf in tree for t in tensors_of(leaf)]
    return []


def total_param_bytes(tree: Any) -> int:
    """Bytes of every tensor in ``tree`` (the reference's
    ``shardings.total_param_bytes``: each leaf counted once)."""
    return sum(t.numel() * t.element_size() for t in tensors_of(tree))


def make_optimizer(moment_dtype=torch.float32) -> AdamW:
    return AdamW(learning_rate=3e-4, moment_dtype=moment_dtype)


def _empty(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def build_step(arch: str, shape: str | InputShape, *,
               moment_dtype=torch.float32,
               remat: bool = True,
               logits_mode: str = "last",
               act_pspec=None,
               cast_params_bf16: bool = False,
               moe_ep_constraint: bool = False,
               moe_impl: str = "einsum",
               cfg: ModelConfig | None = None) -> StepBundle:
    """The step of ``arch`` at ``shape`` (a name of ``SHAPES`` or an
    :class:`InputShape`) on meta tensors.  ``cfg`` replaces the cell's
    config (a run's own cut of it); by default :func:`serving_config`."""
    if act_pspec is not None:
        raise NotImplementedError(ACT_PSPEC)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    cfg = serving_config(arch, shape.name) if cfg is None else cfg
    if cfg.moe is not None and (moe_ep_constraint or moe_impl != "einsum"):
        # the model's MoE layers raise on these (moe.check_options)
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(
                cfg.moe, ep_sharding_constraint=moe_ep_constraint,
                impl=moe_impl))
    b, t = shape.global_batch, shape.seq_len

    if shape.kind == "train":
        model = Model(cfg, device="meta", dtype=torch.float32, seed=None)
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        opt = make_optimizer(moment_dtype)
        state = TrainState(params, opt.init(params))
        step = make_train_step(model, opt, remat=remat,
                               cast_params_bf16=cast_params_bf16)
        tokens = _empty((b, t), torch.long)
        labels = _empty((b, t), torch.long)
        return StepBundle(arch, shape, cfg, model, step,
                          (state, tokens, labels), "train")

    model = Model(cfg, device="meta", dtype=torch.bfloat16, seed=None)
    params = dict(model.named_parameters())
    if cfg.embeds_input:
        inputs = {"embeds": _empty((b, 1 if shape.kind == "decode" else t,
                                    cfg.d_model), torch.bfloat16)}
    else:
        inputs = {"tokens": _empty((b, 1 if shape.kind == "decode" else t),
                                   torch.long)}

    if shape.kind == "prefill":
        if cfg.is_encoder_only:
            def encode_step(p, inputs):
                with layers.parameters_as(model, p):
                    out = model(**inputs, logits_mode="all",
                                attn_impl="kernel")
                return {"logits": out.logits, "risk_score": out.risk_score}

            return StepBundle(arch, shape, cfg, model, encode_step,
                              (params, inputs), "prefill")

        def prefill_step(p, inputs):
            with layers.parameters_as(model, p):
                out, cache = model.prefill(
                    **inputs, cache_capacity=t, logits_mode=logits_mode,
                    attn_impl="kernel")
            return {"logits": out.logits, "risk_score": out.risk_score,
                    "cache": cache}

        return StepBundle(arch, shape, cfg, model, prefill_step,
                          (params, inputs), "prefill")

    # decode: one token, cache of capacity seq_len (window for sliding),
    # at the last position the cache holds
    if not cfg.has_decode:
        raise ValueError(f"{arch} is encoder-only: no decode shapes")
    cache = model.init_cache(b, t)

    def serve_step(p, cache_in, inputs, pos):
        with layers.parameters_as(model, p):
            out = model.decode_step(cache_in, **inputs, pos=pos,
                                    attn_impl="kernel")
        return {"logits": out.logits, "risk_score": out.risk_score,
                "cache": out.cache}

    return StepBundle(arch, shape, cfg, model, serve_step,
                      (params, cache, inputs, t - 1), "decode")
