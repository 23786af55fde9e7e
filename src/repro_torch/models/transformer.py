"""Block composition and the layer stack, for attention + MLP blocks.

A *block* = sequence mixer + optional FFN, pre-norm residual.  The stack is
one ``nn.ModuleList`` of ``n_layers`` blocks, layer ``g * P + i`` being
pattern position ``i`` of group ``g`` (P = ``len(cfg.layer_pattern)``), and
``stack_forward`` loops over it in Python.

Caches keep the reference's layout: ``cache[i]`` is the state for pattern
position ``i``, every leaf carrying a leading ``n_groups`` axis.

Only ``BlockSpec("attn", "mlp")`` (and an attention block with no FFN) is
ported.  The Mamba and xLSTM mixers, the MoE FFN, rematerialisation for
training and sharded activations raise ``NotImplementedError`` naming the
ROADMAP item that will port them.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as attn_mod
from repro_torch.models import layers
from repro_torch.models.attention import KVCache
from repro_torch.models.config import BlockSpec, ModelConfig

# what is not ported yet -> the ROADMAP item that ports it
NOT_PORTED = {
    "moe": "the MoE FFN (models/moe.py, moe_a2a.py) is not ported yet: "
           "ROADMAP Queue 1 item 13b",
    "mamba": "the Mamba mixer (models/mamba.py) is not ported yet: "
             "ROADMAP Queue 1 item 13c",
    "mlstm": "the xLSTM mixers (models/xlstm.py) are not ported yet: "
             "ROADMAP Queue 1 item 13d",
    "slstm": "the xLSTM mixers (models/xlstm.py) are not ported yet: "
             "ROADMAP Queue 1 item 13d",
    "remat": "training (remat=True, training/, launch/train.py) is not "
             "ported yet: ROADMAP Queue 1 item 13e",
    "act_pspec": "sharded activations (act_pspec) are not ported yet: "
                 "ROADMAP Queue 1 item 13f",
}


def check_ported(spec: BlockSpec) -> None:
    for part in (spec.mixer, spec.ffn):
        if part in NOT_PORTED:
            raise NotImplementedError(NOT_PORTED[part])
    if spec.mixer != "attn":
        raise ValueError(spec.mixer)
    if spec.ffn not in ("mlp", "none"):
        raise ValueError(spec.ffn)


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, spec: BlockSpec, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        check_ported(spec)
        kw = dict(device=device, dtype=dtype)
        self.spec = spec
        self.mixer_norm = layers.RMSNorm(cfg.d_model, **kw)
        self.mixer = attn_mod.Attention(cfg, **kw)
        self.ffn_norm = self.ffn = None
        if spec.ffn == "mlp":
            self.ffn_norm = layers.RMSNorm(cfg.d_model, **kw)
            self.ffn = layers.MLP(cfg.d_model, cfg.d_ff, **kw)

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


def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               dtype=torch.bfloat16, device=None) -> list[KVCache]:
    """Fresh decode cache, one entry per pattern position, leaves stacked
    over ``n_groups``."""
    out = []
    for spec in cfg.layer_pattern:
        check_ported(spec)
        cap = min(capacity, cfg.sliding_window) if cfg.sliding_window \
            else capacity
        shape = (cfg.n_groups, batch, cap, cfg.n_kv_heads, cfg.head_dim)
        out.append(KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                           v=torch.zeros(shape, dtype=dtype, device=device)))
    return out


def _mixer_forward(block: Block, x, cfg, *, angles, mode, cache, cache_pos,
                   attn_impl):
    if mode == "decode":
        return attn_mod.attention_forward(
            block.mixer, x, cfg, angles=angles, cache=cache,
            cache_pos=cache_pos, attn_impl=attn_impl)
    out, _ = attn_mod.attention_forward(
        block.mixer, x, cfg, angles=angles, cache=None, attn_impl=attn_impl)
    new_cache = None
    if mode == "prefill":
        new_cache = attn_mod.prefill_kv(
            block.mixer, x, cfg, angles=angles,
            capacity=cache.k.shape[1] if cache is not None else x.shape[1])
    return out, new_cache


def block_forward(block: Block, x, cfg, *, angles, mode, cache, cache_pos,
                  attn_impl):
    """Pre-norm residual block. Returns (x, new_cache)."""
    h = layers.rmsnorm(block.mixer_norm, x, cfg.norm_eps)
    out, new_cache = _mixer_forward(
        block, h, cfg, angles=angles, mode=mode, cache=cache,
        cache_pos=cache_pos, attn_impl=attn_impl)
    x = x + out
    if block.ffn is not None:
        h2 = layers.rmsnorm(block.ffn_norm, x, cfg.norm_eps)
        x = x + layers.mlp(block.ffn, h2)
    return x, new_cache


def stack_forward(
    stack: nn.ModuleList,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    angles: torch.Tensor | None,
    mode: str = "forward",
    cache: list[KVCache] | None = None,
    cache_pos: int = 0,
    remat: bool = False,
    attn_impl: str = "reference",
    act_pspec=None,
) -> tuple[torch.Tensor, list[KVCache] | None, torch.Tensor]:
    """Run the blocks in order.  Returns (x, new_cache_or_None, moe_aux).

    ``prefill`` takes the capacities from ``cache`` and returns a new cache
    in the reference's layout; ``decode`` writes into ``cache`` in place.
    """
    if remat:
        raise NotImplementedError(NOT_PORTED["remat"])
    if act_pspec is not None:
        raise NotImplementedError(NOT_PORTED["act_pspec"])
    n_pat = len(cfg.layer_pattern)
    built: list[list[KVCache]] = [[] for _ in range(n_pat)]
    for layer, block in enumerate(stack):
        g, i = divmod(layer, n_pat)
        c_in = None
        if cache is not None:
            c_in = KVCache(k=cache[i].k[g], v=cache[i].v[g])
        x, c_out = block_forward(
            block, x, cfg, angles=angles, mode=mode, cache=c_in,
            cache_pos=cache_pos, attn_impl=attn_impl)
        if mode == "prefill":
            built[i].append(c_out)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if mode == "prefill":
        new_cache = [KVCache(k=torch.stack([c.k for c in cs]),
                             v=torch.stack([c.v for c in cs]))
                     for cs in built]
        return x, new_cache, aux
    if mode == "decode":
        return x, cache, aux
    return x, None, aux
