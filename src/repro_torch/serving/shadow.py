"""Shadow-scoring sink — the paper's Data Lake for offline evaluation.

Shadow predictors are evaluated on live traffic; their responses are stored
here and never returned to the client (Sec. 2.5.1).  The sink doubles as the
source for offline T^Q fitting and pre-promotion validation (Sec. 3.1).
"""
from __future__ import annotations

import collections
from typing import Iterable

import numpy as np

from repro_torch.serving.types import ShadowRecord


class ShadowSink:
    def __init__(self) -> None:
        self._records: list[ShadowRecord] = []
        self._by_predictor: dict[str, list[ShadowRecord]] = collections.defaultdict(list)

    def write(self, record: ShadowRecord) -> None:
        self._records.append(record)
        self._by_predictor[record.predictor].append(record)

    def write_all(self, records: Iterable[ShadowRecord]) -> None:
        for r in records:
            self.write(r)

    def __len__(self) -> int:
        return len(self._records)

    def records(self, predictor: str | None = None) -> list[ShadowRecord]:
        if predictor is None:
            return list(self._records)
        return list(self._by_predictor.get(predictor, ()))

    def scores(self, predictor: str, tenant: str | None = None) -> np.ndarray:
        recs = self._by_predictor.get(predictor, ())
        return np.array([
            r.score for r in recs if tenant is None or r.tenant == tenant
        ])

    def raw_aggregated_scores(self, predictor: str,
                              tenant: str | None = None) -> np.ndarray:
        """Pre-T^Q aggregated scores — the input for fitting a refreshed T^Q."""
        recs = self._by_predictor.get(predictor, ())
        out = []
        for r in recs:
            if tenant is None or r.tenant == tenant:
                out.append(float(np.mean(r.raw_scores)) if r.raw_scores else r.score)
        return np.array(out)
