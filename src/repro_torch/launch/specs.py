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

``moe_impl="a2a"`` builds MoE layers that run the expert-parallel MoE
(``models/moe_a2a.py``), traced under an active mesh
(``launch/mesh.py::set_mesh``).  ``moe_ep_constraint`` sets the MoE's
``ep_sharding_constraint``, which changes no number
(``models/moe.py``).  ``act_pspec``, ``cast_params_bf16`` and ``remat``
(the ``--variant`` bundles, ``launch/dryrun.py::variant_build_kwargs``)
reach every step, the rank's too: the sequence-parallel residual for
train and prefill and the weight-stationary decode
(``models/parallel.py::act_layout``), the bf16 casts before the FSDP
gathers (``training/train.py``) and remat off.  A placed model's
``moe_impl="a2a"`` MoE runs over its own mesh
(``models/moe_a2a.py``).

``mesh=`` builds one rank's step of a pod mesh (train, prefill and
decode, for every model of the catalog): the model
sharded by ``models/parallel.py`` under the production rules, FSDP
decided as the reference's dry-run decides it, and every argument on
meta at the rank's shard shape (its rows of the batch, its block of the
decode cache under ``cache_pspec``).  The step runs under
``set_mesh(mesh)`` with the global batch passed on (whole on every rank
where it does not divide over the data axes); on a shape-only mesh its
collectives only count (``launch/collectives.py``).  Every family runs
over a mesh, the Mamba and xLSTM mixers on their channel blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES, InputShape
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import shardings
from repro_torch.models import layers, parallel
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.training.optimizer import AdamW
from repro_torch.training.train import TrainState, make_train_step

SLIDING_WINDOW_LONG = 8192
# per-rank parameter bytes past which the parameters are FSDP'd (ZeRO-3)
FSDP_THRESHOLD_BYTES = 4 * 2**30


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
    mesh: Any = None                 # the pod mesh of one rank's step
    fsdp: bool = False


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


def decide_fsdp(params, mesh) -> bool:
    """The reference's rule: the per-rank bytes of ``params`` (whole)
    over the model axis pass :data:`FSDP_THRESHOLD_BYTES`."""
    per_rank = total_param_bytes(params) / mesh_lib.model_axis_size(mesh)
    return per_rank > FSDP_THRESHOLD_BYTES


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
               cfg: ModelConfig | None = None,
               mesh=None, fsdp: bool | None = None) -> StepBundle:
    """The step of ``arch`` at ``shape`` (a name of ``SHAPES`` or an
    :class:`InputShape`) on meta tensors.  ``cfg`` replaces the cell's
    config (a run's own cut of it); by default :func:`serving_config`.
    With ``mesh``, one rank's step (``fsdp=None`` decides FSDP as the
    reference does).  An ``act_pspec`` the port does not take raises
    here (``parallel.act_layout``)."""
    parallel.act_layout(act_pspec, mesh)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    cfg = serving_config(arch, shape.name) if cfg is None else cfg
    if cfg.moe is not None and (moe_ep_constraint or moe_impl != "einsum"):
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(
                cfg.moe, ep_sharding_constraint=moe_ep_constraint,
                impl=moe_impl))
    if mesh is not None:
        if shape.kind == "decode" and not cfg.has_decode:
            raise ValueError(f"{arch} is encoder-only: no decode shapes")
        return _rank_step(arch, shape, cfg, mesh, fsdp,
                          moment_dtype=moment_dtype, remat=remat,
                          logits_mode=logits_mode, act_pspec=act_pspec,
                          cast_params_bf16=cast_params_bf16)
    b, t = shape.global_batch, shape.seq_len

    if shape.kind == "train":
        model = Model(cfg, device="meta", dtype=torch.float32, seed=None)
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        opt = make_optimizer(moment_dtype)
        state = TrainState(params, opt.init(params))
        step = make_train_step(model, opt, remat=remat, act_pspec=act_pspec,
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
                                attn_impl="kernel", act_pspec=act_pspec)
                return {"logits": out.logits, "risk_score": out.risk_score}

            return StepBundle(arch, shape, cfg, model, encode_step,
                              (params, inputs), "prefill")

        def prefill_step(p, inputs):
            with layers.parameters_as(model, p):
                out, cache = model.prefill(
                    **inputs, cache_capacity=t, logits_mode=logits_mode,
                    attn_impl="kernel", act_pspec=act_pspec)
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
                                    attn_impl="kernel", act_pspec=act_pspec)
        return {"logits": out.logits, "risk_score": out.risk_score,
                "cache": out.cache}

    return StepBundle(arch, shape, cfg, model, serve_step,
                      (params, cache, inputs, t - 1), "decode")


def _rank_step(arch: str, shape: InputShape, cfg: ModelConfig, mesh,
               fsdp: bool | None, *, moment_dtype, remat: bool,
               logits_mode: str, act_pspec=None,
               cast_params_bf16: bool = False) -> StepBundle:
    """One rank's train, prefill or decode step over ``mesh`` (see the
    module's docstring)."""
    b, t = shape.global_batch, shape.seq_len
    train = shape.kind == "train"
    model = Model(cfg, device="meta",
                  dtype=torch.float32 if train else torch.bfloat16,
                  seed=None)
    if fsdp is None:
        # a train step's moments are never larger than its float32
        # parameters, so the parameters decide, as in the reference
        fsdp = decide_fsdp(dict(model.named_parameters()), mesh)
    model.requires_grad_(train)
    parallel.parallelize(model, mesh, fsdp=fsdp)
    params = dict(model.named_parameters())
    bl = shardings.shard_shape((b,), shardings.batch_pspec(b, mesh, 0),
                               mesh)[0]

    def on_mesh(fn):
        def step(*args):
            with mesh_lib.set_mesh(mesh):
                return fn(*args)
        return step

    if train:
        opt = make_optimizer(moment_dtype)
        state = TrainState(params, opt.init(params))
        step = make_train_step(model, opt, remat=remat, global_batch=b,
                               act_pspec=act_pspec,
                               cast_params_bf16=cast_params_bf16)
        tokens = _empty((bl, t), torch.long)
        labels = _empty((bl, t), torch.long)
        return StepBundle(arch, shape, cfg, model, on_mesh(step),
                          (state, tokens, labels), "train", mesh, fsdp)

    tq = 1 if shape.kind == "decode" else t
    if cfg.embeds_input:
        inputs = {"embeds": _empty((bl, tq, cfg.d_model), torch.bfloat16)}
    else:
        inputs = {"tokens": _empty((bl, tq), torch.long)}

    if shape.kind == "decode":
        # the rank's block of the cache: made at its shard shape, not a
        # view of a whole cache (whose storage the arguments would count)
        cache = model.init_cache(b, t)

        def serve_step(p, cache_in, inputs, pos):
            with layers.parameters_as(model, p):
                out = model.decode_step(cache_in, **inputs, pos=pos,
                                        attn_impl="kernel",
                                        cache_capacity=t, global_batch=b,
                                        act_pspec=act_pspec)
            return {"logits": out.logits, "risk_score": out.risk_score,
                    "cache": out.cache}

        return StepBundle(arch, shape, cfg, model, on_mesh(serve_step),
                          (params, cache, inputs, t - 1), "decode", mesh,
                          fsdp)

    def prefill_step(p, inputs):
        with layers.parameters_as(model, p):
            if cfg.is_encoder_only:
                out = model(**inputs, logits_mode="all", attn_impl="kernel",
                            global_batch=b, act_pspec=act_pspec)
                return {"logits": out.logits, "risk_score": out.risk_score}
            out, cache = model.prefill(
                **inputs, cache_capacity=t, logits_mode=logits_mode,
                attn_impl="kernel", global_batch=b, act_pspec=act_pspec)
        return {"logits": out.logits, "risk_score": out.risk_score,
                "cache": cache}

    return StepBundle(arch, shape, cfg, model, on_mesh(prefill_step),
                      (params, inputs), "prefill", mesh, fsdp)
