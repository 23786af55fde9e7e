"""What the port's benchmarks of the paper's tables and figures share.

* :func:`stamp` — the keys every result of the port carries beside the
  reference's: the device, the card's name and power limit, the size and
  the kernel launches the run made.
* :func:`apply_quantile_map` — T^Q of a host score sample on the device
  through ``kernels/ops.py::quantile_map`` (the hand-written kernel on a
  CUDA tensor, the plain version on a CPU one), held against the plain
  version on the same tensors: its largest difference, the scores that
  sit exactly on a knot (which must map to the same bits), and the scores
  whose Fig. 4/6 bin differs between the two.
* :func:`differences` — where one result departs from another, key by
  key: how the tests hold the port to the reference and the card's run to
  the CPU's.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.benchmarks import cli
from repro_torch.core.transforms import QuantileMap
from repro_torch.device import to_numpy
from repro_torch.kernels import ops, ref

BIN_EDGES = np.linspace(0.0, 1.0, 11)   # the score bins of Figs. 4 and 6


def stamp(dev: torch.device, quick: bool, before: dict) -> dict:
    """Device, card, size and the launches made since ``before`` (a copy
    of ``ops.LAUNCHES``)."""
    cuda = dev.type == "cuda"
    return {
        "device": torch.cuda.get_device_name(dev) if cuda else str(dev),
        "nvidia_smi": cli.nvidia_smi() if cuda else None,
        "quick": quick,
        "launches": {k: ops.LAUNCHES[k] - before[k] for k in before}}


def score_bins(scores: np.ndarray) -> np.ndarray:
    """Each score's bin of :data:`BIN_EDGES`, as ``np.histogram`` counts it
    (the last bin holds 1.0; scores outside [0, 1] get -1 or 10)."""
    s = np.asarray(scores, np.float64)
    b = np.searchsorted(BIN_EDGES, s, side="right") - 1
    return np.where(s == BIN_EDGES[-1], len(BIN_EDGES) - 2, b)


def apply_quantile_map(qm: QuantileMap, scores: np.ndarray,
                       dev: torch.device) -> tuple[np.ndarray, dict]:
    """T^Q of ``scores`` (cast to float32, as the reference casts them) on
    ``dev`` in one ``ops.quantile_map`` call, with the map's tables moved to
    ``dev``.  Returns the mapped scores on the host and the check against
    ``kernels/ref.py::quantile_map`` on the same tensors."""
    x = torch.as_tensor(np.asarray(scores, np.float32), device=dev)
    src = qm.src_quantiles.to(dev)
    refq = qm.ref_quantiles.to(dev)
    got = ops.quantile_map(x, src, refq)
    plain = ref.quantile_map(x, src, refq)
    on_knot = torch.isin(x, src)
    out, want = to_numpy(got), to_numpy(plain)
    moved = score_bins(out) != score_bins(want)
    edge_gap = np.abs(out[moved, None].astype(np.float64)
                      - BIN_EDGES[None]).min(axis=1)
    return out, {
        "scores": int(x.numel()),
        "max_abs_err": float((got - plain).abs().max()),
        "on_knot_scores": int(on_knot.sum()),
        "on_knot_equal": bool(torch.equal(got[on_knot], plain[on_knot])),
        "bin_changes": int(moved.sum()),
        "bin_changes_max_edge_gap": float(edge_gap.max())
        if moved.any() else None}


def differences(want, got, *, rtol: float = 0.0, atol: float = 0.0,
                skip: frozenset = frozenset(), path: str = "") -> list[str]:
    """Where ``got`` departs from ``want``, walking ``want``'s keys (``got``
    may hold more): floats within ``atol + rtol * |want|`` (NaN equals NaN),
    everything else (ints, bools, strings, None, lengths) exactly.  Keys in
    ``skip`` (timings) are not compared."""
    if isinstance(want, dict):
        if not isinstance(got, dict):
            return [f"{path}: {got!r} is no mapping"]
        return [d for k, v in want.items() if k not in skip
                for d in ([f"{path}/{k}: missing"] if k not in got else
                          differences(v, got[k], rtol=rtol, atol=atol,
                                      skip=skip, path=f"{path}/{k}"))]
    if isinstance(want, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            return [f"{path}: {got!r} against {want!r}"]
        return [d for i, (a, b) in enumerate(zip(want, got))
                for d in differences(a, b, rtol=rtol, atol=atol, skip=skip,
                                     path=f"{path}[{i}]")]
    if isinstance(want, float) and isinstance(got, float):
        if math.isnan(want) and math.isnan(got):
            return []
        if abs(got - want) <= atol + rtol * abs(want):
            return []
    elif isinstance(want, bool) == isinstance(got, bool) and want == got:
        return []
    return [f"{path}: {got!r} against {want!r}"]
