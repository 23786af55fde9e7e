"""Block composition and the layer stack.

A *block* = sequence mixer (attention, Mamba, mLSTM or sLSTM) + optional
FFN (dense SwiGLU or MoE), pre-norm residual.  The stack is one
``nn.ModuleList`` of ``n_layers`` blocks, layer ``g * P + i`` being pattern
position ``i`` of group ``g`` (P = ``len(cfg.layer_pattern)``), and
``stack_forward`` loops over it in Python.

Caches keep the reference's layout: ``cache[i]`` is the state for pattern
position ``i`` (a ``KVCache`` for attention, a ``MambaState`` for Mamba,
an ``MLSTMState`` or ``SLSTMState`` for the xLSTM mixers), every leaf
carrying a leading ``n_groups`` axis.

``remat=True`` wraps each group of P blocks in
``torch.utils.checkpoint.checkpoint`` (non-reentrant), the counterpart of
the reference's ``jax.checkpoint(group_body)``: the backward recomputes a
group's activations from its input instead of keeping them.

A MoE block with ``impl="a2a"`` runs the expert-parallel MoE
(``models/moe_a2a.py``) over the active mesh.  A model sharded by
``models/parallel.py`` runs each block on the rank's blocks: the layers'
column / row machinery, the attention's head-aligned exchange and its
flash-decoding over the rank's slots of the cache
(``attention.attention_forward``), the Mamba and xLSTM mixers on the
rank's channels with their states' blocks (``mamba.py``, ``xlstm.py``)
and the MoE on the rank's experts (``moe.moe_forward``), with remat as
without a mesh.  With ``seq`` (the reference's sequence-parallel
``act_pspec``, ``parallel.act_layout``) the residual between blocks is
the rank's block of T: norms run on it, each mixer and FFN gathers T at
entry and reduce-scatters at its close, and a remat group keeps that
block, not a gathered one.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.launch import shardings
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import moe_a2a
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.attention import KVCache
from repro_torch.models.config import BlockSpec, ModelConfig

MIXERS = ("attn", "mamba", "mlstm", "slstm")
FFNS = ("mlp", "moe", "none")


def check_ported(spec: BlockSpec) -> None:
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
        elif spec.mixer == "mamba":
            self.mixer = mamba_mod.Mamba(cfg.d_model, cfg.mamba, **kw)
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
               dtype=torch.bfloat16, device=None, mesh=None) -> list:
    """Fresh decode cache, one entry per pattern position, leaves stacked
    over ``n_groups``.  Attention caches and the Mamba conv tail take
    ``dtype``; the Mamba SSM state and the xLSTM states are float32, as the
    reference's.  With ``mesh`` (a sharded model's), each leaf is this
    rank's block of the cache of a global ``batch`` under
    ``launch/shardings.py::cache_pspec``, made at its block's shape."""
    if mesh is not None:
        whole = init_cache(cfg, batch, capacity, dtype, device="meta")
        return [type(c)(*(torch.zeros(
            shardings.shard_shape(a.shape, sp, mesh), dtype=a.dtype,
            device=device) for a, sp in zip(c, cs)))
            for c, cs in zip(whole, shardings.cache_pspecs(whole, batch,
                                                           mesh))]
    out = []
    for spec in cfg.layer_pattern:
        check_ported(spec)
        if spec.mixer == "mamba":
            out.append(_stacked_zeros(mamba_mod.init_mamba_state(
                batch, cfg.d_model, cfg.mamba, dtype, device),
                cfg.n_groups))
            continue
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
                   attn_impl, capacity=None, seq=None, ws=None):
    mixer, kind = block.mixer, block.spec.mixer
    if kind == "mamba":
        if mode == "decode":
            return mamba_mod.mamba_decode_step(mixer, x, cfg.mamba, cache,
                                               ws=ws)
        return mamba_mod.mamba_forward(mixer, x, cfg.mamba,
                                       return_state=(mode == "prefill"),
                                       seq=seq)
    if kind == "mlstm":
        if mode == "decode":
            return xlstm_mod.mlstm_decode_step(mixer, x, cfg.n_heads,
                                               cfg.xlstm, cache, ws=ws)
        return xlstm_mod.mlstm_forward(mixer, x, cfg.n_heads, cfg.xlstm,
                                       return_state=(mode == "prefill"),
                                       seq=seq)
    if kind == "slstm":
        if mode == "decode":
            return xlstm_mod.slstm_decode_step(mixer, x, cfg.xlstm, cache,
                                               ws=ws)
        return xlstm_mod.slstm_forward(mixer, x, cfg.xlstm,
                                       return_state=(mode == "prefill"),
                                       seq=seq)
    return attn_mod.attention_forward(
        mixer, x, cfg, angles=angles, cache=cache, cache_pos=cache_pos,
        attn_impl=attn_impl, capacity=capacity if mode != "forward" else None,
        seq=seq, ws=ws)


def block_forward(block: Block, x, cfg, *, angles, mode, cache, cache_pos,
                  attn_impl, capacity=None, global_batch=None, seq=None,
                  ws=None):
    """Pre-norm residual block. Returns (x, new_cache, moe_aux).
    ``global_batch``: the batch x's rows belong to (``moe.moe_forward``);
    ``seq``: the mesh of a sequence-parallel residual, x the rank's block
    of T; ``ws``: the mesh of a weight-stationary decode, x every row at
    the rank's block of d."""
    if ws is not None:
        return _ws_block(block, x, cfg, angles=angles, cache=cache,
                         cache_pos=cache_pos, capacity=capacity, ws=ws)
    h = layers.rmsnorm(block.mixer_norm, x, cfg.norm_eps, seq=seq)
    out, new_cache = _mixer_forward(
        block, h, cfg, angles=angles, mode=mode, cache=cache,
        cache_pos=cache_pos, attn_impl=attn_impl, capacity=capacity,
        seq=seq)
    x = x + out
    aux = None
    if block.spec.ffn == "mlp":
        h2 = layers.rmsnorm(block.ffn_norm, x, cfg.norm_eps, seq=seq)
        x = x + layers.mlp(block.ffn, h2, seq=seq)
    elif block.spec.ffn == "moe":
        h2 = layers.rmsnorm(block.ffn_norm, x, cfg.norm_eps, seq=seq)
        if cfg.moe.impl == "a2a":
            out2, aux = moe_a2a.moe_forward_a2a(
                block.ffn, h2, cfg.moe, seq=seq, global_batch=global_batch)
        else:
            out2, aux = moe_mod.moe_forward(block.ffn, h2, cfg.moe,
                                            with_aux=mode != "decode",
                                            global_batch=global_batch,
                                            seq=seq)
        x = x + out2
    return x, new_cache, aux


def _ws_block(block: Block, x, cfg, *, angles, cache, cache_pos, capacity,
              ws):
    """A decode step's block under the weight-stationary layout: norms,
    the mixer, the MLP or the MoE on every row at the rank's block of d
    (``layers.rmsnorm_ws``, ``attention._decode``, the Mamba's and the
    xLSTM mixers' decode steps, ``layers.mlp_ws``, ``moe.moe_forward``);
    the only weights gathered are the recurrent mixers' that never touch
    the residual (``models/mamba.py``, ``models/xlstm.py``)."""
    h = layers.rmsnorm_ws(block.mixer_norm, x, cfg.norm_eps, ws)
    out, new_cache = _mixer_forward(
        block, h, cfg, angles=angles, mode="decode", cache=cache,
        cache_pos=cache_pos, attn_impl="reference", capacity=capacity,
        ws=ws)
    x = x + out
    if block.spec.ffn == "mlp":
        x = x + layers.mlp_ws(block.ffn, layers.rmsnorm_ws(
            block.ffn_norm, x, cfg.norm_eps, ws), ws)
    elif block.spec.ffn == "moe":
        out2, _ = moe_mod.moe_forward(
            block.ffn, layers.rmsnorm_ws(block.ffn_norm, x, cfg.norm_eps, ws),
            cfg.moe, with_aux=False, global_batch=x.shape[0], ws=ws)
        x = x + out2
    return x, new_cache, None


def _group_forward(blocks: nn.ModuleList, names: list[str], cfg, angles,
                   attn_impl, global_batch, seq, x, aux, *tensors):
    """One remat group: ``blocks`` run on ``tensors`` (their parameters, by
    ``names``), so a recompute uses the tensors the first run used even if
    the caller swapped the parameters for that run only (the training
    step's bf16 casts); ``aux`` carries the running MoE sum, added in
    layer order as without remat."""
    with layers.parameters_as(blocks, dict(zip(names, tensors))):
        for block in blocks:
            x, _, layer_aux = block_forward(
                block, x, cfg, angles=angles, mode="forward", cache=None,
                cache_pos=0, attn_impl=attn_impl, global_batch=global_batch,
                seq=seq)
            if layer_aux is not None:
                aux = aux + layer_aux
    return x, aux


def _remat_forward(stack, x, cfg, *, angles, attn_impl, global_batch, seq):
    n_pat = len(cfg.layer_pattern)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(0, len(stack), n_pat):
        blocks = stack[g:g + n_pat]
        names, tensors = zip(*blocks.named_parameters())
        run = functools.partial(_group_forward, blocks, list(names), cfg,
                                angles, attn_impl, global_batch, seq)
        x, aux = checkpoint(run, x, aux, *tensors, use_reentrant=False)
    return x, None, aux


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
    capacity: int | None = None,
    global_batch: int | None = None,
    seq=None,
    ws=None,
) -> tuple[torch.Tensor, list | None, torch.Tensor]:
    """Run the blocks in order.  Returns (x, new_cache_or_None, moe_aux),
    ``moe_aux`` the float32 sum of the MoE layers' load-balance losses in
    layer order (0 without MoE layers).

    ``prefill`` returns a new cache in the reference's layout, its
    attention caches of ``capacity`` (a sliding-window layer's of the
    window where that is less); ``decode`` writes into ``cache`` in
    place (attention keys and values at ``cache_pos``, the Mamba SSM
    state by the scan itself, the Mamba conv tail and the xLSTM states
    replaced) and returns it; on a sharded model ``capacity`` is then the
    capacity the cache was built with (``attention.attention_forward``).
    ``remat`` (the full-sequence forward only) checkpoints each group of
    P blocks.  ``global_batch``: the batch x's rows belong to on a
    sharded model (``parallel.data_rows``; None: their block over the
    data axes).  ``seq``: the mesh of a sequence-parallel residual (x
    the rank's block of T; train and prefill), as ``Model`` resolves it
    from the reference's ``act_pspec`` (``parallel.seq_mesh``); ``ws``:
    the mesh of a weight-stationary decode step (x every row of the
    batch at the rank's block of d, ``parallel.ws_mesh``).
    """
    if seq is not None and mode == "decode":
        raise ValueError("a decode step has one token: no sequence to cut")
    if ws is not None and mode != "decode":
        raise ValueError("the weight-stationary layout is a decode step's")
    if mode == "prefill" and capacity is None:
        raise ValueError("a prefill needs the cache capacity")
    if remat:
        if mode != "forward":
            raise ValueError("remat applies to the full-sequence forward, "
                             f"not to {mode!r}")
        return _remat_forward(stack, x, cfg, angles=angles,
                              attn_impl=attn_impl, global_batch=global_batch,
                              seq=seq)
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
            cache_pos=cache_pos, attn_impl=attn_impl, capacity=capacity,
            global_batch=global_batch, seq=seq, ws=ws)
        if layer_aux is not None:
            aux = aux + layer_aux
        if mode == "prefill":
            built[i].append(c_out)
        elif mode == "decode" and block.spec.mixer != "attn":
            # a leaf the mixer wrote in place comes back as the cache's own
            # tensor (the Mamba SSM state); every other leaf is copied in
            for dst, src in zip(c_in, c_out):
                if src is not dst:
                    dst.copy_(src)
    if mode == "prefill":
        new_cache = [type(cs[0])(*(torch.stack(leaves)
                                   for leaves in zip(*cs)))
                     for cs in built]
        return x, new_cache, aux
    if mode == "decode":
        return x, cache, aux
    return x, None, aux
