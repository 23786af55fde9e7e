"""Client-side decision loop over transformed scores.

MUSE's whole calibration machinery exists so that a CLIENT can hold a fixed
business rule — "alert on the top ``a`` fraction of traffic, hard-block the
extreme tail" — while models retrain and T^Q maps refresh underneath it.
This module is that client: a per-tenant threshold harness over the
*transformed* (post-T^Q) scores, with the grace / cooldown / instant-block
semantics of production fraud-ops decision loops (cf. the IoT-guard
``decision_loop.py`` referenced in the ROADMAP):

  * **thresholds** — ``tau`` is the ``(1 - alert_rate)`` quantile of the
    shared reference distribution R, ``tau_block`` the ``(1 - block_rate)``
    quantile; both are fixed client-side constants precisely because T^Q
    keeps mapping every tenant's live distribution onto R;
  * **grace** — a tenant's first ``grace_events`` events only observe
    (no alerts): a freshly onboarded stream is still cold-starting its
    calibration and must not page an analyst on day zero;
  * **instant block** — a score at or above ``tau_block`` blocks
    immediately, grace or not (the one rule that never defers);
  * **cooldown** — after a block, ``cooldown_events`` subsequent events are
    suppressed to "allow": the fraud-ops analogue of alarm damping, so one
    burst cannot flood the review queue.

Every event produces a :class:`Decision` keyed by the originating request
id, carrying the full replay witness: the served score, the raw expert
scores, the ``bank_generation`` provenance stamp, both thresholds, and the
loop-state inputs (grace flag, cooldown counter) that the pure
:func:`decide` function consumed.  Feeding decisions to an
``audit.AuditLog`` makes the whole loop tamper-evident and bit-for-bit
replayable — see ``serving/audit.py`` for the chain + replay contract.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

from repro_torch.serving.types import ScoringRequest, ScoringResponse


@dataclasses.dataclass(frozen=True)
class DecisionPolicy:
    """Client-side thresholding knobs (all in reference-distribution terms)."""

    alert_rate: float = 0.02          # alert on the top ``a`` of R
    block_rate: float = 0.0005        # instant-block on the extreme tail
    grace_events: int = 0             # observe-only warmup per tenant
    cooldown_events: int = 0          # post-block alert damping

    def thresholds(self, ref_quantiles: np.ndarray
                   ) -> tuple[float, float]:
        """(tau, tau_block) — the (1-a) and (1-b) quantiles of R."""
        tq = np.asarray(ref_quantiles, np.float64)
        levels = np.linspace(0.0, 1.0, len(tq))
        tau = float(np.interp(1.0 - self.alert_rate, levels, tq))
        tau_block = float(np.interp(1.0 - self.block_rate, levels, tq))
        return tau, max(tau_block, tau)


def decide(score: float, threshold: float, block_threshold: float,
           in_grace: bool, cooldown: int) -> str:
    """The pure decision function: (score, thresholds, state) -> action.

    Deliberately free of any hidden state so an audit replay can recompute
    the action from an entry's recorded fields alone (the replay contract
    in ``serving/audit.py``).
    """
    if score >= block_threshold:
        return "block"                # instant block outranks grace/cooldown
    if in_grace or cooldown > 0:
        return "allow"
    if score >= threshold:
        return "alert"
    return "allow"


@dataclasses.dataclass(frozen=True)
class Decision:
    """One per-event client decision, keyed by request id.

    Carries everything ``audit.verify`` needs to reproduce it bit-for-bit:
    the raw expert scores + ``bank_generation`` reproduce ``score`` through
    the exact generation's transform pipeline, and (``threshold``,
    ``block_threshold``, ``grace``, ``cooldown``) reproduce ``action``
    through :func:`decide`.
    """

    request_id: int
    tenant: str
    predictor: str
    score: float
    raw_scores: tuple[float, ...]
    bank_generation: int
    threshold: float
    block_threshold: float
    action: str                       # "allow" | "alert" | "block"
    seq: int                          # per-tenant event sequence number
    grace: bool                       # tenant was in grace BEFORE this event
    cooldown: int                     # cooldown counter BEFORE this event


@dataclasses.dataclass
class _TenantState:
    seq: int = 0
    cooldown: int = 0
    events: int = 0
    alerts: int = 0
    blocks: int = 0


class DecisionLoop:
    """Per-tenant threshold harness over served :class:`ScoringResponse`s.

    ``process`` consumes one dispatched window (requests + their aligned
    responses), advances each tenant's state machine, and returns the
    per-event :class:`Decision`s in request order.  When an ``audit`` log
    is attached every decision is appended to the hash chain as it is made
    — the decision and its tamper-evident record are never out of sync.
    """

    def __init__(self, policy: DecisionPolicy, ref_quantiles: np.ndarray,
                 audit: "object | None" = None) -> None:
        self.policy = policy
        self.tau, self.tau_block = policy.thresholds(ref_quantiles)
        self.audit = audit
        self._tenants: dict[str, _TenantState] = {}

    # ------------------------------------------------------------------ state
    def state(self, tenant: str) -> _TenantState:
        st = self._tenants.get(tenant)
        if st is None:
            st = self._tenants[tenant] = _TenantState()
        return st

    def realized_rates(self) -> dict[str, dict[str, float]]:
        """Per-tenant alert/block rates over everything processed so far."""
        out = {}
        for t, st in self._tenants.items():
            n = max(st.events, 1)
            out[t] = {"events": st.events,
                      "alert_rate": st.alerts / n,
                      "block_rate": st.blocks / n}
        return out

    def reset_counters(self) -> None:
        """Zero the per-tenant alert/block counters (e.g. at a measurement
        window boundary) without touching grace/cooldown progression."""
        for st in self._tenants.values():
            st.events = st.alerts = st.blocks = 0

    # ---------------------------------------------------------------- process
    def process(self, requests: Sequence[ScoringRequest],
                responses: Iterable[ScoringResponse]) -> list[Decision]:
        decisions: list[Decision] = []
        for req, resp in zip(requests, responses):
            tenant = req.intent.tenant
            st = self.state(tenant)
            in_grace = st.seq < self.policy.grace_events
            cooldown = st.cooldown
            action = decide(resp.score, self.tau, self.tau_block,
                            in_grace, cooldown)
            d = Decision(
                request_id=resp.request_id, tenant=tenant,
                predictor=resp.predictor, score=resp.score,
                raw_scores=tuple(resp.raw_scores),
                bank_generation=resp.bank_generation,
                threshold=self.tau, block_threshold=self.tau_block,
                action=action, seq=st.seq, grace=in_grace,
                cooldown=cooldown)
            st.seq += 1
            st.events += 1
            if cooldown > 0:
                st.cooldown -= 1
            if action == "alert":
                st.alerts += 1
            elif action == "block":
                st.blocks += 1
                st.cooldown = self.policy.cooldown_events
            if self.audit is not None:
                self.audit.append(d)
            decisions.append(d)
        return decisions
