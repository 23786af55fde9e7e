"""Build the port's objects from the reference package's parameters.

The inputs are plain numpy arrays (``np.asarray`` of the reference's
arrays), so this module needs neither JAX nor the reference package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.transforms import QuantileMap, TransformBank
from repro_torch.experiments.fraud_world import Expert
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32), device=device)


def bank_from_numpy(betas, weights, src, ref, *, generation: int,
                    device: torch.device | str) -> TransformBank:
    """(T, K), (T, K), (T, N), (T, N) arrays -> a bank on ``device``."""
    return TransformBank(
        betas=_f32(betas, device), weights=_f32(weights, device),
        src_quantiles=_f32(src, device), ref_quantiles=_f32(ref, device),
        generation=generation)


def quantile_map_from_numpy(src, ref, device: torch.device | str
                            ) -> QuantileMap:
    """(N,), (N,) arrays -> a ``QuantileMap`` on ``device``."""
    return QuantileMap(src_quantiles=_f32(src, device),
                       ref_quantiles=_f32(ref, device))


def expert_from_numpy(name: str, beta: float, w, b: float,
                      feature_mask) -> Expert:
    """A FraudWorld expert from its weights (kept in float64, as trained)."""
    return Expert(name=name, beta=float(beta),
                  w=np.array(w, np.float64), b=float(b),
                  feature_mask=np.array(feature_mask, np.float64))


def _copy(dst: torch.Tensor, src, *, transpose: bool = False) -> None:
    a = np.asarray(src)
    if transpose:
        a = a.T
    dst.copy_(torch.tensor(np.ascontiguousarray(a)))


def model_from_numpy(cfg: ModelConfig, params, *, device: torch.device | str,
                     dtype: torch.dtype = torch.float32) -> Model:
    """The reference's ``Model(cfg).init(...)`` parameters, every leaf a
    numpy array (``jax.tree.map(np.asarray, params)``) -> the port's
    ``Model`` with those weights on ``device`` in ``dtype``.

    The reference stacks each pattern position's leaves over a leading
    ``n_groups`` axis; layer ``g * P + i`` of the port is group g of
    position i.  Linear weights are (in, out) there and (out, in) here;
    the MoE experts' and the mLSTM's head-wise weights have one layout on
    both sides.
    """
    model = Model(cfg, device=device, dtype=dtype, seed=None)
    _copy(model.embed.table, params["embed"]["table"])
    _copy(model.final_norm.scale, params["final_norm"]["scale"])
    if model.lm_head is not None:
        _copy(model.lm_head.weight, params["lm_head"]["w"], transpose=True)
    if model.score_head is not None:
        _copy(model.score_head.weight, params["score_head"]["w"],
              transpose=True)
        _copy(model.score_head.bias, params["score_head"]["b"])
    n_pat = len(cfg.layer_pattern)
    for layer, block in enumerate(model.stack):
        g, i = divmod(layer, n_pat)
        src = params["stack"][i]
        _copy(block.mixer_norm.scale, src["mixer_norm"]["scale"][g])
        _MIXERS[block.spec.mixer](block.mixer, src["mixer"], g)
        if block.ffn is not None:
            _copy(block.ffn_norm.scale, src["ffn_norm"]["scale"][g])
            _FFNS[block.spec.ffn](block.ffn, src["ffn"], g)
    return model


def _copy_linear(dst, src, g) -> None:
    """A reference linear (``w`` (in, out), optional ``b``) of group g."""
    _copy(dst.weight, src["w"][g], transpose=True)
    if dst.bias is not None:
        _copy(dst.bias, src["b"][g])


def _copy_mlp(dst, src, g) -> None:
    for name in ("gate", "up", "down"):
        _copy_linear(getattr(dst, name), src[name], g)


def _copy_attention(dst, src, g) -> None:
    for name in ("wq", "wk", "wv", "wo"):
        _copy_linear(getattr(dst, name), src[name], g)
    if dst.q_norm is not None:
        _copy(dst.q_norm, src["q_norm"][g])
        _copy(dst.k_norm, src["k_norm"][g])


def _copy_mlstm(dst, src, g) -> None:
    # the head-wise (H, hd, hd) blocks keep their layout
    for name in ("wq", "wk", "wv"):
        _copy(getattr(dst, name), src[name][g])
    for name in ("up", "w_if", "down"):
        _copy_linear(getattr(dst, name), src[name], g)


def _copy_slstm(dst, src, g) -> None:
    for name in ("w_in", "w_rec", "up", "down"):
        _copy_linear(getattr(dst, name), src[name], g)


def _copy_moe(dst, src, g) -> None:
    # the experts' (E, d, f) / (E, f, d) weights are the same on both sides
    _copy_linear(dst.router, src["router"], g)
    for name in ("gate", "up", "down"):
        _copy(getattr(dst, name), src[name][g])
    if dst.shared is not None:
        _copy_mlp(dst.shared, src["shared"], g)


_MIXERS = {"attn": _copy_attention, "mlstm": _copy_mlstm,
           "slstm": _copy_slstm}
_FFNS = {"mlp": _copy_mlp, "moe": _copy_moe}
