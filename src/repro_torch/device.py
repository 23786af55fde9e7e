"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for another device:
``None`` means CUDA, and a machine without CUDA raises instead of quietly
running on the CPU.  Tests and CPU tools pass ``device="cpu"`` explicitly.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU explicitly")
        return torch.device("cuda")
    return torch.device(device)


def to_numpy(x) -> np.ndarray:
    """Host copy of a tensor (on any device) or of an array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
