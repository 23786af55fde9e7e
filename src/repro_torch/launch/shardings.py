"""Parameter, batch and cache sharding rules for the production mesh.

The reference's name-based rules (``launch/shardings.py``), as plain
functions of its pytree path strings and shapes:

  * batch axes -> ("pod", "data") when divisible, else replicated;
  * matmul weights: column-parallel (output dim on "model") for QKV /
    gate / up-style projections, row-parallel (input dim) for O / down;
  * MoE expert weights: expert-parallel (the E axis on "model"); a dense
    MLP's weights stay column / row parallel, where the reference's rule
    shards the stacked layer axis of some (ROADMAP Queue 3);
  * embeddings vocab-sharded; norms, biases, the router and the score head
    replicated; the Mamba per-channel tensors on their channel dim;
  * with FSDP, the largest still-unsharded dim that divides on the data
    axes as well;
  * decode caches: batch on the data axes, the largest inner dim (the
    sequence of a KV cache) on "model".

:func:`param_pspecs` maps each of the port's parameters to its spec in the
port's own layout: a ``Linear`` weight is the transpose of the reference's
``w``, so its two entries swap, and the port's stack holds one module a
layer where the reference's leaves carry a leading ``n_groups`` axis, so
that entry goes.  :func:`shard_shape` and :func:`local_shard` give a rank's
shape and slice.
"""
from __future__ import annotations

import math
from typing import Any, Iterator

import torch

from repro_torch.launch import mesh as mesh_lib

# path substrings -> which dim (negative index) is column/row parallel
_COL_PARALLEL = (  # shard LAST dim on "model"
    "wq/", "wk/", "wv/", "gate/", "up/", "in_proj/", "w_in/", "w_rec/",
    "dt_proj/", "lm_head/",
)
_ROW_PARALLEL = (  # shard dim -2 on "model"
    "wo/", "down/", "out_proj/", "x_proj/",
)
_REPLICATED = (
    "norm", "score_head", "router/", "bias", "/b",
)


class PartitionSpec(tuple):
    """One entry a dim: None, an axis name, or a tuple of axis names (a
    tuple of one name is that name, as JAX's ``PartitionSpec`` reads)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


P = PartitionSpec


def path_str(path) -> str:
    """A key path as the reference's ``_path_str`` writes it."""
    return "/".join(str(k) for k in path) + "/"


def _div(dim: int, n: int) -> bool:
    return n > 0 and dim % n == 0


def param_pspec(path: str, shape: tuple[int, ...], model_size: int,
                *, fsdp_axes: tuple[str, ...] = (), fsdp_size: int = 1
                ) -> PartitionSpec:
    """Spec of one leaf of the reference's tree (``path`` its path string,
    ``shape`` its stacked shape)."""
    nd = len(shape)
    spec: list = [None] * nd

    def _fsdp_fill() -> None:
        if not fsdp_axes or nd < 2:
            return
        # shard the largest still-unsharded dim that divides
        for i in sorted(range(nd), key=lambda j: -shape[j]):
            if spec[i] is None and _div(shape[i], fsdp_size):
                spec[i] = fsdp_axes
                return

    def col(dim_idx: int) -> PartitionSpec:
        if _div(shape[dim_idx], model_size):
            spec[dim_idx] = "model"
        _fsdp_fill()
        return P(*spec)

    # MoE expert tensors .../ffn/{gate,up,down}, (G, E, d, ff) stacked:
    # the expert axis on "model" (expert parallelism).  A dense MLP's
    # stacked Linear weight (.../ffn/gate/w/, (G, d, ff)) has three dims
    # too; the reference's rule takes it for (E, d, ff) and shards its
    # group axis (ROADMAP Queue 3), the port's leaves it to col/row
    if "/ffn/" in path and any(
        k in path for k in ("gate/", "up/", "down/")
    ) and nd >= 3 and "shared" not in path and not path.endswith("/w/"):
        e_axis = nd - 3
        if _div(shape[e_axis], model_size):
            spec[e_axis] = "model"
            _fsdp_fill()
            return P(*spec)
        # fall through to col/row rules if experts don't divide

    if any(k in path for k in _REPLICATED):
        return P(*spec)
    if "embed/table" in path:
        v_axis = nd - 2
        if _div(shape[v_axis], model_size):
            spec[v_axis] = "model"
        _fsdp_fill()
        return P(*spec)
    for key in _COL_PARALLEL:
        if key in path:
            return col(nd - 1)
    for key in _ROW_PARALLEL:
        if key in path:
            return col(nd - 2) if nd >= 2 else P(*spec)
    # mamba per-channel tensors: A_log (G, d_in, N), D / dt_bias (G, d_in),
    # conv_w (G, K, d_in), conv_b (G, d_in)
    if "A_log" in path:
        return col(nd - 2)
    if any(k in path for k in ("conv_w", "conv_b", "dt_bias", "/D/")) or \
            path.endswith("/D/"):
        return col(nd - 1)
    _fsdp_fill()
    return P(*spec)


def param_pspecs(cfg, model: torch.nn.Module, mesh, *, fsdp: bool = False
                 ) -> dict[str, PartitionSpec]:
    """Each parameter of the port's ``model`` -> its spec in the port's
    layout (the reference's spec of the same leaf with the group entry
    dropped and a ``Linear`` weight's two entries swapped)."""
    from repro_torch import convert   # convert imports the models

    model_size = mesh_lib.model_axis_size(mesh)
    faxes = mesh_lib.data_axes(mesh) if fsdp else ()
    fsize = mesh_lib.data_axis_size(mesh) if fsdp else 1
    out = {}
    for name, p in model.named_parameters():
        path, g, transpose = convert._ref_leaf(cfg, model, name)
        shape = tuple(p.shape)[::-1] if transpose else tuple(p.shape)
        if g is not None:
            shape = (cfg.n_groups,) + shape
        spec = list(param_pspec(path_str(path), shape, model_size,
                                fsdp_axes=faxes, fsdp_size=fsize))
        if g is not None:
            if spec[0] is not None:
                raise ValueError(f"{name}: the rules shard the group axis "
                                 f"({spec}), which the port's stack lacks")
            spec = spec[1:]
        out[name] = P(*(spec[::-1] if transpose else spec))
    return out


def batch_pspec(batch: int, mesh, rest_dims: int) -> PartitionSpec:
    axes = mesh_lib.data_axes(mesh)
    n = mesh_lib.data_axis_size(mesh)
    if _div(batch, n) and n > 1:
        return P(axes, *([None] * rest_dims))
    return P(*([None] * (rest_dims + 1)))


def cache_pspec(path: str, shape: tuple[int, ...], batch: int, mesh
                ) -> PartitionSpec:
    """Decode-cache leaf spec.  KV caches (G, B, S, Hkv, D): batch on the
    data axes, the sequence on "model" (flash-decoding).  States: batch on
    the data axes, the largest inner dim on "model" when divisible."""
    model = mesh_lib.model_axis_size(mesh)
    daxes = mesh_lib.data_axes(mesh)
    dsize = mesh_lib.data_axis_size(mesh)
    nd = len(shape)
    spec: list = [None] * nd
    if nd >= 2 and _div(shape[1], dsize) and dsize > 1:
        spec[1] = daxes
    if ("/k/" in path or "/v/" in path or path.endswith("/k/")
            or path.endswith("/v/")) and nd == 5:
        if _div(shape[2], model):
            spec[2] = "model"          # sequence axis
        return P(*spec)
    # states: shard the largest remaining dim divisible by model
    if nd >= 3:
        inner = max(range(2, nd), key=lambda i: shape[i])
        if _div(shape[inner], model):
            spec[inner] = "model"
    return P(*spec)


def cache_pspecs(cache: list, batch: int, mesh) -> list:
    """The port's decode cache (one state tuple a pattern position, leaves
    stacked over ``n_groups``, the reference's layout) -> the same nest of
    specs; leaf ``f`` of position ``i`` has the path ``"i/f/"``."""
    return [type(state)(*(cache_pspec(f"{i}/{field}/", tuple(leaf.shape),
                                      batch, mesh)
                          for field, leaf in zip(state._fields, state)))
            for i, state in enumerate(cache)]


# ---------------------------------------------------------------------------
# a rank's shard
# ---------------------------------------------------------------------------

def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_shape(shape, spec: PartitionSpec, mesh) -> tuple[int, ...]:
    """Each dim divided by the ranks of the axes its entry names."""
    out = []
    for dim, entry in zip(tuple(shape), tuple(spec) + (None,) * len(shape)):
        n = math.prod(mesh.shape[a] for a in _axes(entry))
        if dim % n:
            raise ValueError(f"dim {dim} does not divide over {entry}")
        out.append(dim // n)
    return tuple(out)


def local_shard(tensor: torch.Tensor, spec: PartitionSpec, mesh,
                coords: dict[str, int]) -> torch.Tensor:
    """The block of ``tensor`` that the rank at ``coords`` holds: along a
    dim sharded over several axes, the block index runs over them
    row-major, the first axis the slowest (a view; differentiable)."""
    for dim, (size, entry) in enumerate(zip(
            shard_shape(tensor.shape, spec, mesh), spec)):
        idx = 0
        for a in _axes(entry):
            idx = idx * mesh.shape[a] + coords[a]
        if entry is not None:
            tensor = tensor.narrow(dim, idx * size, size)
    return tensor


def _pairs(tree: Any, specs: Any) -> Iterator[tuple[torch.Tensor,
                                                    PartitionSpec]]:
    if isinstance(tree, torch.Tensor):
        yield tree, specs
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _pairs(v, specs[k])
    elif isinstance(tree, (list, tuple)):
        for v, s in zip(tree, specs, strict=True):
            yield from _pairs(v, s)


def per_device_bytes(tree: Any, specs: Any, mesh) -> int:
    """Bytes one rank holds of every tensor in ``tree`` (a nest of dicts,
    lists and tuples) under the matching nest of ``specs``."""
    return sum(math.prod(shard_shape(t.shape, s, mesh)) * t.element_size()
               for t, s in _pairs(tree, specs))
