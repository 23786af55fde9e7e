"""Checkpointing: nested dicts and lists of tensors <-> flat .npz + json meta.

Layout:  <dir>/<step>/arrays.npz  +  <dir>/<step>/meta.json
(the reference package's ``training/checkpoint.py`` layout, byte-for-byte
in its keys, dtype map and metadata).  Leaves are addressed by '/'-joined
key paths: dict keys in sorted order, list and tuple positions by index,
as JAX flattens a pytree.  A leaf is a ``torch.Tensor`` or anything
``numpy.asarray`` takes; ``None`` is an empty subtree.  Dtypes numpy
cannot store (bfloat16) are stored as raw bits with their name in the
``dtypes`` map, so a checkpoint written by either package restores in the
other.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

try:
    import orjson
except ModuleNotFoundError:  # stdlib json fallback — same bytes-in/bytes-out
    orjson = None

Tree = Any

# raw-bit views of the dtypes numpy cannot store, by item size
_RAW = {1: np.uint8, 2: np.uint16, 4: np.uint32}


def _json_dumps(obj: Any) -> bytes:
    if orjson is not None:
        return orjson.dumps(obj)
    return json.dumps(obj).encode()


def _json_loads(data: bytes) -> Any:
    if orjson is not None:
        return orjson.loads(data)
    return json.loads(data.decode())


def _leaves(tree: Tree, prefix: tuple[str, ...] = ()):
    """(key path, leaf) pairs in JAX's flattening order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], prefix + (str(key),))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaves(sub, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _to_storable(leaf: Any) -> tuple[np.ndarray, str]:
    """A leaf as numpy npz can store, and the name of its dtype."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        leaf = leaf.numpy()
    arr = np.asarray(leaf)
    name = str(arr.dtype)
    if arr.dtype.kind == "V" or arr.dtype.name not in np.sctypeDict:
        arr = arr.view(_RAW[arr.dtype.itemsize])
    return arr, name


def save_checkpoint(directory: str, step: int, tree: Tree,
                    metadata: dict | None = None) -> str:
    path = os.path.join(directory, str(step))
    os.makedirs(path, exist_ok=True)
    dtypes: dict[str, str] = {}
    storable = {}
    for key, leaf in _leaves(tree):
        storable[key], dtypes[key] = _to_storable(leaf)
    np.savez(os.path.join(path, "arrays.npz"), **storable)
    meta = {"step": step, "dtypes": dtypes, **(metadata or {})}
    with open(os.path.join(path, "meta.json"), "wb") as f:
        f.write(_json_dumps(meta))
    return path


def _restore_leaf(arr: np.ndarray, stored_dtype: str | None, like: Any):
    """One stored array in the type, dtype and device of ``like``."""
    if isinstance(like, torch.Tensor):
        if stored_dtype == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            if stored_dtype and str(arr.dtype) != stored_dtype:
                arr = arr.view(np.dtype(stored_dtype))
            t = torch.from_numpy(np.array(arr))
        return t.to(device=like.device, dtype=like.dtype)
    like_dtype = np.asarray(like).dtype
    if stored_dtype and str(arr.dtype) != stored_dtype:
        arr = arr.view(np.dtype(stored_dtype))  # undo the raw-bit view
    return np.asarray(arr, dtype=like_dtype)


def _rebuild(like: Tree, leaves: dict[str, Any],
             prefix: tuple[str, ...] = ()) -> Tree:
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves, prefix + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves, prefix + (str(i),))
                          for i, v in enumerate(like))
    return leaves["/".join(prefix)]


def restore_checkpoint(directory: str, step: int, like: Tree) -> Tree:
    """Restore into the structure of ``like``: each leaf takes the type,
    dtype and (for a tensor) the device of ``like``'s leaf."""
    path = os.path.join(directory, str(step))
    with np.load(os.path.join(path, "arrays.npz")) as npz:
        arrays = dict(npz)
    dtypes = load_metadata(directory, step).get("dtypes", {})
    leaves = {}
    for key, leaf in _leaves(like):
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        leaves[key] = _restore_leaf(arrays[key], dtypes.get(key), leaf)
    return _rebuild(like, leaves)


def load_metadata(directory: str, step: int) -> dict:
    with open(os.path.join(directory, str(step), "meta.json"), "rb") as f:
        return _json_loads(f.read())


def load_arrays(directory: str, step: int) -> dict[str, np.ndarray]:
    """Raw numpy leaves of a checkpoint, keyed by '/'-joined key path.

    Float64 leaves (estimator reservoirs) keep their dtype.  Dtypes stored
    as raw bit views (bf16 etc.) are returned as stored; consult
    ``load_metadata()['dtypes']`` to undo."""
    with np.load(os.path.join(directory, str(step), "arrays.npz")) as npz:
        return dict(npz)


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d) for d in os.listdir(directory) if d.isdigit()]
    return max(steps) if steps else None
