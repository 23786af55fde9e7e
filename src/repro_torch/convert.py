"""Build the port's objects from the reference package's parameters, and
back.

The inputs and outputs are plain numpy arrays (``np.asarray`` of the
reference's arrays), so this module needs neither JAX nor the reference
package.  Given a mesh, a rank gets its shards of the reference's tree
(``models/parallel.py``) and gives back the whole tree, gathered.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.transforms import QuantileMap, TransformBank
from repro_torch.experiments.fraud_world import Expert
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Linear
from repro_torch.launch.shardings import local_shard
from repro_torch.models import parallel
from repro_torch.models.model import Model
from repro_torch.training.optimizer import AdamWState


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


# ---------------------------------------------------------------------------
# The port's parameters (and gradients, moments) <-> the reference's tree
# ---------------------------------------------------------------------------

def _leaf_path(module: torch.nn.Module, name: str) -> tuple[tuple, bool]:
    """Where ``module``'s parameter ``name`` sits in the reference's tree of
    that module, and whether it is transposed there: a ``Linear``'s weight
    (out, in) is the reference's ``w`` (in, out) and its bias ``b``; every
    other leaf (norm scales, the MoE experts', the mLSTM's head-wise and
    the Mamba conv's and ``A_log``'s weights) keeps its name and layout."""
    *owner, attr = name.split(".")
    transpose = False
    if isinstance(module.get_submodule(".".join(owner)), Linear):
        attr, transpose = {"weight": ("w", True), "bias": ("b", False)}[attr]
    return (*owner, attr), transpose


def _ref_leaf(cfg: ModelConfig, model: Model, name: str):
    """(key path, group or None, transposed) of the model's parameter
    ``name``: layer ``g * P + i`` of the stack is group g of
    ``params["stack"][i]``, whose leaves carry a leading ``n_groups``
    axis."""
    path, transpose = _leaf_path(model, name)
    if path[0] == "stack":
        g, i = divmod(int(path[1]), len(cfg.layer_pattern))
        return ("stack", i, *path[2:]), g, transpose
    return path, None, transpose


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _set(tree, path, leaf) -> None:
    for key in path[:-1]:
        tree = tree[key] if isinstance(key, int) else tree.setdefault(key,
                                                                       {})
    tree[path[-1]] = leaf


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":     # numpy cannot hand it to torch
        return torch.tensor(a.astype(np.float32), device=device).to(
            torch.bfloat16)
    return torch.tensor(np.ascontiguousarray(a), device=device)


@torch.no_grad()
def _copy_module(dst: torch.nn.Module, src, g: int) -> None:
    """``dst``'s parameters from the reference's tree of that module,
    group g of each stacked leaf."""
    for name, p in dst.named_parameters():
        path, transpose = _leaf_path(dst, name)
        a = np.asarray(_get(src, path))[g]
        p.copy_(_tensor(a.T if transpose else a, p.device))


def tree_from_numpy(cfg: ModelConfig, model: Model, tree,
                    device: torch.device | str | None = None
                    ) -> dict[str, torch.Tensor]:
    """A reference tree shaped like the parameters (weights, gradients,
    moments) as tensors keyed by the port's parameter names, in each
    leaf's own dtype (bf16 kept), on ``device`` (default the model's); of
    a sharded model, this rank's blocks."""
    device = model.device if device is None else device
    par = parallel.of(model)
    out = {}
    for name in dict(model.named_parameters()):
        path, g, transpose = _ref_leaf(cfg, model, name)
        a = np.asarray(_get(tree, path))
        if g is not None:
            a = a[g]
        t = _tensor(a.T if transpose else a, device)
        if par is not None:
            t = local_shard(t, par.specs[name], par.mesh,
                            par.mesh.coords()).contiguous()
        out[name] = t
    return out


def model_from_numpy(cfg: ModelConfig, params, *, device: torch.device | str,
                     dtype: torch.dtype = torch.float32, mesh=None,
                     fsdp: bool = False) -> Model:
    """The reference's ``Model(cfg).init(...)`` parameters, every leaf a
    numpy array (``jax.tree.map(np.asarray, params)``) -> the port's
    ``Model`` with those weights on ``device`` in ``dtype``
    (:func:`tree_from_numpy`'s mapping); with ``mesh``, this rank's
    shards of it (``models/parallel.py::parallelize``)."""
    model = Model(cfg, device=device, dtype=dtype, seed=None)
    with torch.no_grad():
        for name, t in tree_from_numpy(cfg, model, params).items():
            model.get_parameter(name).copy_(t)
    if mesh is not None:
        parallel.parallelize(model, mesh, fsdp=fsdp)
    return model


def _host(t: torch.Tensor | None, like: torch.Tensor) -> np.ndarray:
    if t is None:                      # a gradient the loss does not reach
        t = torch.zeros_like(like)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def model_to_numpy(cfg: ModelConfig, model: Model,
                   values: dict[str, torch.Tensor | None] | None = None):
    """The inverse of :func:`model_from_numpy`: the reference's parameter
    tree (numpy leaves; the stack's leaves stacked over ``n_groups``;
    linear weights (in, out)) of the model's parameters, or of ``values``
    keyed by parameter name (gradients, AdamW moments; None counts as
    zeros, bf16 comes back as float32).  Of a sharded model, every rank
    calls it and each gets the whole tree, all-gathered."""
    params = dict(model.named_parameters())
    values = params if values is None else values
    par = parallel.of(model)
    if par is not None:
        values = {k: parallel.gather_full(
            torch.zeros_like(params[k]) if values.get(k) is None
            else values[k].detach(), par.specs[k], par.mesh)
            for k in params}
    tree: dict = {"stack": [{} for _ in cfg.layer_pattern]}
    stacked: dict[tuple, dict[int, np.ndarray]] = {}
    for name, p in params.items():
        path, g, transpose = _ref_leaf(cfg, model, name)
        a = _host(values.get(name), p)
        a = np.ascontiguousarray(a.T) if transpose else a
        if g is None:
            _set(tree, path, a)
        else:
            stacked.setdefault(path, {})[g] = a
    for path, by_group in stacked.items():
        _set(tree, path, np.stack([by_group[g] for g in sorted(by_group)]))
    return tree


def adamw_state_from_numpy(cfg: ModelConfig, model: Model, state
                           ) -> AdamWState:
    """The reference's ``AdamWState`` (``step``, ``mu``, ``nu``; numpy
    leaves, ``jax.tree.map(np.asarray, state)``) as the port's, keyed by
    the model's parameter names on its device."""
    return AdamWState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                          device=model.device),
        mu=tree_from_numpy(cfg, model, state.mu),
        nu=tree_from_numpy(cfg, model, state.nu))
