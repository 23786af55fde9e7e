"""Per-tenant hotness tracking for the tiered bank store.

The tiered store (``serving/tiering.py``) keeps only the hottest tenants'
transform rows device-resident; everything else pages in from the host
store on demand.  "Hot" is defined here: an exponentially decayed access
count per tenant, decayed once per *dispatch window* (not per wall-clock
second — a tenant that dominates every recent window is hot regardless of
how fast windows arrive).

The tracker is array-backed and O(batch) per recorded window at ANY tenant
count: decay is applied lazily through one global scale factor (recording
``+1`` now writes ``1/scale`` into the raw count array, and ``scale``
shrinks by ``decay`` per tick), so a tick never touches the (possibly
10^6-wide) count vector.  The raw counts are renormalized only when the
scale underflows — an O(T) sweep every ~10^4 ticks at the default decay.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# renormalize the raw counts once the lazy scale factor drops below this —
# far above f64 underflow, so effective scores stay exact to ~1e-15
_RESCALE_FLOOR = 1e-100


@dataclasses.dataclass
class HotnessTracker:
    """Decayed per-key access counts over dispatch windows.

    ``decay`` is the per-window multiplier: after ``w`` windows with no
    access a key's score is ``score * decay**w``.  ``decay=1.0`` degrades
    to plain cumulative counts.  ``record`` takes the key vector of one
    dispatch window; ``tick`` marks a window boundary.  The tiered store
    calls ``record`` per dispatch and ``tick`` from its (explicit,
    control-plane) ``rebalance`` — scores therefore compare windows since
    the last rebalance against the decayed history before it.
    """

    num_keys: int
    decay: float = 0.98

    def __post_init__(self) -> None:
        if not 0.0 < self.decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {self.decay}")
        self._raw = np.zeros(self.num_keys, np.float64)
        self._scale = 1.0
        self._windows = 0

    # ------------------------------------------------------------- recording
    def record(self, keys: np.ndarray, weight: float = 1.0) -> None:
        """Count one dispatch window's accesses (duplicate keys add up)."""
        keys = np.asarray(keys, np.int64).ravel()
        if len(keys):
            np.add.at(self._raw, keys, weight / self._scale)

    def tick(self, windows: int = 1) -> None:
        """Advance ``windows`` dispatch-window boundaries (decay the past)."""
        if windows < 0:
            raise ValueError("windows must be >= 0")
        self._windows += windows
        self._scale *= self.decay ** windows
        if self._scale < _RESCALE_FLOOR:
            self._raw *= self._scale
            self._scale = 1.0

    # --------------------------------------------------------------- queries
    @property
    def windows(self) -> int:
        return self._windows

    def scores(self) -> np.ndarray:
        """Effective decayed counts, (num_keys,) — a fresh array."""
        return self._raw * self._scale

    def score(self, key: int) -> float:
        return float(self._raw[key] * self._scale)

    def top(self, n: int, mask: np.ndarray | None = None) -> np.ndarray:
        """The up-to-``n`` hottest keys with a nonzero score, hot-first.

        ``mask`` (optional, (num_keys,) bool) restricts eligibility — the
        tiered store passes its admitted set so un-admitted (cold-start)
        tenants can never claim a hot slot.
        """
        raw = self._raw if mask is None else np.where(mask, self._raw, 0.0)
        nz = np.flatnonzero(raw > 0.0)
        if len(nz) > n:
            part = nz[np.argpartition(-raw[nz], n - 1)[:n]]
        else:
            part = nz
        return part[np.argsort(-raw[part], kind="stable")]

    # ----------------------------------------------------------- persistence
    def snapshot(self) -> dict:
        """Portable state — adopted by a surged replica's fresh tracker so
        it starts with the victim's hot set instead of a cold one."""
        return {"num_keys": int(self.num_keys), "decay": float(self.decay),
                "scores": self.scores(), "windows": int(self._windows)}

    def adopt(self, snap: dict) -> None:
        """Overwrite this tracker's state with a snapshot's effective scores
        (sizes may differ — the common prefix is adopted)."""
        scores = np.asarray(snap["scores"], np.float64)
        n = min(len(scores), self.num_keys)
        self._raw[:] = 0.0
        self._raw[:n] = scores[:n]
        self._scale = 1.0
        self._windows = int(snap.get("windows", 0))
