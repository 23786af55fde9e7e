"""Block composition and the layer stack.

A *block* = sequence mixer (attention, mLSTM or sLSTM) + optional FFN
(dense SwiGLU or MoE), pre-norm residual.  The stack is one
``nn.ModuleList`` of ``n_layers`` blocks, layer ``g * P + i`` being pattern
position ``i`` of group ``g`` (P = ``len(cfg.layer_pattern)``), and
``stack_forward`` loops over it in Python.

Caches keep the reference's layout: ``cache[i]`` is the state for pattern
position ``i`` (a ``KVCache`` for attention, an ``MLSTMState`` or
``SLSTMState`` for the xLSTM mixers), every leaf carrying a leading
``n_groups`` axis.

Still raising ``NotImplementedError``, each naming the ROADMAP item that
ports it: the Mamba mixer (13c), the all-to-all MoE (``impl="a2a"``, 13b's
``moe_a2a`` with 11b), rematerialisation for training (13e), and sharded
activations and expert-parallel constraints (13f).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as attn_mod
from repro_torch.models import layers
from repro_torch.models import moe as moe_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.attention import KVCache
from repro_torch.models.config import BlockSpec, ModelConfig

# what is not ported yet -> the ROADMAP item that ports it
NOT_PORTED = {
    "mamba": "the Mamba mixer (models/mamba.py) is not ported yet: "
             "ROADMAP Queue 1 item 13c",
    "remat": "training (remat=True, training/, launch/train.py) is not "
             "ported yet: ROADMAP Queue 1 item 13e",
    "act_pspec": "sharded activations (act_pspec) are not ported yet: "
                 "ROADMAP Queue 1 item 13f",
}
MIXERS = ("attn", "mlstm", "slstm")
FFNS = ("mlp", "moe", "none")


def check_ported(spec: BlockSpec) -> None:
    for part in (spec.mixer, spec.ffn):
        if part in NOT_PORTED:
            raise NotImplementedError(NOT_PORTED[part])
    if spec.mixer not in MIXERS:
        raise ValueError(spec.mixer)
    if spec.ffn not in FFNS:
        raise ValueError(spec.ffn)


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, spec: BlockSpec, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        check_ported(spec)
        kw = dict(device=device, dtype=dtype)
        self.spec = spec
        self.mixer_norm = layers.RMSNorm(cfg.d_model, **kw)
        if spec.mixer == "attn":
            self.mixer = attn_mod.Attention(cfg, **kw)
        elif spec.mixer == "mlstm":
            self.mixer = xlstm_mod.MLSTM(cfg.d_model, cfg.n_heads, cfg.xlstm,
                                         **kw)
        else:
            self.mixer = xlstm_mod.SLSTM(cfg.d_model, cfg.xlstm, **kw)
        self.ffn_norm = self.ffn = None
        if spec.ffn == "mlp":
            self.ffn_norm = layers.RMSNorm(cfg.d_model, **kw)
            self.ffn = layers.MLP(cfg.d_model, cfg.d_ff, **kw)
        elif spec.ffn == "moe":
            self.ffn_norm = layers.RMSNorm(cfg.d_model, **kw)
            self.ffn = moe_mod.MoE(cfg.d_model, cfg.moe, **kw)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.mixer_norm.reset_parameters(gen)
        self.mixer.reset_parameters(gen)
        if self.ffn is not None:
            self.ffn_norm.reset_parameters(gen)
            self.ffn.reset_parameters(gen)


def init_stack(cfg: ModelConfig, *, device=None, dtype=torch.float32
               ) -> nn.ModuleList:
    """``n_layers`` uninitialised blocks; layer ``g * P + i`` has pattern
    position i."""
    pattern = cfg.layer_pattern
    return nn.ModuleList(
        Block(cfg, pattern[i % len(pattern)], device=device, dtype=dtype)
        for i in range(cfg.n_layers))


def _stacked_zeros(state, n_groups: int):
    """A state tuple with a leading ``n_groups`` axis on every leaf, each
    leaf its own tensor."""
    return type(state)(*(torch.zeros((n_groups,) + tuple(a.shape),
                                     dtype=a.dtype, device=a.device)
                         for a in state))


def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               dtype=torch.bfloat16, device=None) -> list:
    """Fresh decode cache, one entry per pattern position, leaves stacked
    over ``n_groups``.  Attention caches take ``dtype``; the xLSTM states
    are float32, as the reference's."""
    out = []
    for spec in cfg.layer_pattern:
        check_ported(spec)
        if spec.mixer == "mlstm":
            out.append(_stacked_zeros(xlstm_mod.init_mlstm_state(
                batch, cfg.d_model, cfg.n_heads, cfg.xlstm, device),
                cfg.n_groups))
            continue
        if spec.mixer == "slstm":
            out.append(_stacked_zeros(xlstm_mod.init_slstm_state(
                batch, cfg.d_model, device), cfg.n_groups))
            continue
        cap = min(capacity, cfg.sliding_window) if cfg.sliding_window \
            else capacity
        shape = (cfg.n_groups, batch, cap, cfg.n_kv_heads, cfg.head_dim)
        out.append(KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                           v=torch.zeros(shape, dtype=dtype, device=device)))
    return out


def _mixer_forward(block: Block, x, cfg, *, angles, mode, cache, cache_pos,
                   attn_impl):
    mixer, kind = block.mixer, block.spec.mixer
    if kind == "mlstm":
        if mode == "decode":
            return xlstm_mod.mlstm_decode_step(mixer, x, cfg.n_heads,
                                               cfg.xlstm, cache)
        return xlstm_mod.mlstm_forward(mixer, x, cfg.n_heads, cfg.xlstm,
                                       return_state=(mode == "prefill"))
    if kind == "slstm":
        if mode == "decode":
            return xlstm_mod.slstm_decode_step(mixer, x, cfg.xlstm, cache)
        return xlstm_mod.slstm_forward(mixer, x, cfg.xlstm,
                                       return_state=(mode == "prefill"))
    if mode == "decode":
        return attn_mod.attention_forward(
            mixer, x, cfg, angles=angles, cache=cache, cache_pos=cache_pos,
            attn_impl=attn_impl)
    out, _ = attn_mod.attention_forward(
        mixer, x, cfg, angles=angles, cache=None, attn_impl=attn_impl)
    new_cache = None
    if mode == "prefill":
        new_cache = attn_mod.prefill_kv(
            mixer, x, cfg, angles=angles,
            capacity=cache.k.shape[1] if cache is not None else x.shape[1])
    return out, new_cache


def block_forward(block: Block, x, cfg, *, angles, mode, cache, cache_pos,
                  attn_impl):
    """Pre-norm residual block. Returns (x, new_cache, moe_aux)."""
    h = layers.rmsnorm(block.mixer_norm, x, cfg.norm_eps)
    out, new_cache = _mixer_forward(
        block, h, cfg, angles=angles, mode=mode, cache=cache,
        cache_pos=cache_pos, attn_impl=attn_impl)
    x = x + out
    aux = None
    if block.spec.ffn == "mlp":
        h2 = layers.rmsnorm(block.ffn_norm, x, cfg.norm_eps)
        x = x + layers.mlp(block.ffn, h2)
    elif block.spec.ffn == "moe":
        h2 = layers.rmsnorm(block.ffn_norm, x, cfg.norm_eps)
        out2, aux = moe_mod.moe_forward(block.ffn, h2, cfg.moe)
        x = x + out2
    return x, new_cache, aux


def stack_forward(
    stack: nn.ModuleList,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    angles: torch.Tensor | None,
    mode: str = "forward",
    cache: list | None = None,
    cache_pos: int = 0,
    remat: bool = False,
    attn_impl: str = "reference",
    act_pspec=None,
) -> tuple[torch.Tensor, list | None, torch.Tensor]:
    """Run the blocks in order.  Returns (x, new_cache_or_None, moe_aux),
    ``moe_aux`` the float32 sum of the MoE layers' load-balance losses in
    layer order (0 without MoE layers).

    ``prefill`` takes the attention capacities from ``cache`` and returns a
    new cache in the reference's layout; ``decode`` writes into ``cache``
    in place (attention keys and values at ``cache_pos``, xLSTM states
    replaced) and returns it.
    """
    if remat:
        raise NotImplementedError(NOT_PORTED["remat"])
    if act_pspec is not None:
        raise NotImplementedError(NOT_PORTED["act_pspec"])
    n_pat = len(cfg.layer_pattern)
    built: list[list] = [[] for _ in range(n_pat)]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer, block in enumerate(stack):
        g, i = divmod(layer, n_pat)
        c_in = None
        if cache is not None:
            c_in = type(cache[i])(*(a[g] for a in cache[i]))
        x, c_out, layer_aux = block_forward(
            block, x, cfg, angles=angles, mode=mode, cache=c_in,
            cache_pos=cache_pos, attn_impl=attn_impl)
        if layer_aux is not None:
            aux = aux + layer_aux
        if mode == "prefill":
            built[i].append(c_out)
        elif mode == "decode" and block.spec.mixer != "attn":
            for dst, src in zip(c_in, c_out):
                dst.copy_(src)
    if mode == "prefill":
        new_cache = [type(cs[0])(*(torch.stack(leaves)
                                   for leaves in zip(*cs)))
                     for cs in built]
        return x, new_cache, aux
    if mode == "decode":
        return x, cache, aux
    return x, None, aux
