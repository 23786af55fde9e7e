"""Model pool with cross-predictor deduplication (paper Sec. 2.2.1).

A *model* here is a physical deployment unit (the paper's Triton container;
for us, a compiled JAX scoring executable + weights).  Predictors reference
models by name; the pool refcounts them so that

  * deploying predictor ``p2 = {m1, m2, m3}`` on top of ``p1 = {m1, m2}``
    provisions only ``m3`` (infrastructure dedup), and
  * decommissioning ``p1`` keeps ``m1``/``m2`` alive while ``p2`` needs them.

The pool also records provision/reuse counters so the dedup benefit is
observable (tested + surfaced in benchmarks).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

ScoreFn = Callable[..., Any]


class ModelNotDeployed(LookupError):
    pass


@dataclasses.dataclass
class ModelHandle:
    name: str
    score_fn: ScoreFn
    metadata: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    refcount: int = 0
    # resource accounting (abstract units, e.g. bytes of params or pod count)
    resource_cost: float = 1.0


class ModelPool:
    """Refcounted registry of deployed model executables."""

    def __init__(self) -> None:
        self._models: dict[str, ModelHandle] = {}
        self.provision_events = 0   # how many times a container was (re)created
        self.reuse_events = 0       # how many acquisitions hit an existing one

    # -- deployment ---------------------------------------------------------
    def deploy(self, name: str, score_fn: ScoreFn, *,
               metadata: Mapping[str, Any] | None = None,
               resource_cost: float = 1.0) -> ModelHandle:
        """Idempotent: re-deploying an existing name reuses the container."""
        if name in self._models:
            self.reuse_events += 1
            return self._models[name]
        handle = ModelHandle(name=name, score_fn=score_fn,
                             metadata=dict(metadata or {}),
                             resource_cost=resource_cost)
        self._models[name] = handle
        self.provision_events += 1
        return handle

    def acquire(self, name: str) -> ModelHandle:
        if name not in self._models:
            raise ModelNotDeployed(name)
        handle = self._models[name]
        handle.refcount += 1
        self.reuse_events += 1
        return handle

    def release(self, name: str) -> None:
        if name not in self._models:
            raise ModelNotDeployed(name)
        handle = self._models[name]
        handle.refcount = max(0, handle.refcount - 1)
        if handle.refcount == 0:
            # Decommission only when no predictor references the model.
            del self._models[name]

    # -- introspection ------------------------------------------------------
    def __contains__(self, name: str) -> bool:
        return name in self._models

    def get(self, name: str) -> ModelHandle:
        if name not in self._models:
            raise ModelNotDeployed(name)
        return self._models[name]

    def names(self) -> tuple[str, ...]:
        return tuple(self._models)

    def total_resource_cost(self) -> float:
        return sum(h.resource_cost for h in self._models.values())

    def marginal_cost_of(self, model_names: tuple[str, ...],
                         costs: Mapping[str, float]) -> float:
        """Resource cost of deploying a predictor over this pool: only the
        models not already present are provisioned (Sec. 2.2.1 benefit #1)."""
        return sum(costs.get(n, 1.0) for n in model_names if n not in self._models)
