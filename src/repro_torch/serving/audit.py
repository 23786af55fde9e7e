"""Hash-chained, generation-stamped decision audit log.

Every client :class:`~repro_torch.serving.decision_loop.Decision` is
appended to a tamper-evident chain, and every entry is *replayable*: given
the exact ``bank_generation`` the decision was served under, ``verify``
reproduces both the transformed score and the client action bit-for-bit.
This is the OversightLogging contract (cf. the thesis repo's
``verify_audit.py``): an alert raised months ago can be proven to have
followed from exactly the parameters served at that moment — or shown to
have been tampered with.

Chain format
------------

Entry ``i`` is a pair ``(payload_i, digest_i)``:

  * ``payload_i`` — the decision record as CANONICAL JSON: all fields of
    ``Decision`` (``dataclasses.asdict``), serialized with sorted keys and
    compact separators.  Canonicalization makes the digest independent of
    field/insertion order — two logs of the same decisions chain
    identically regardless of how the records were assembled.
  * ``digest_i = sha256(digest_{i-1} || "\\n" || index_i || "\\n" ||
    payload_i)`` in hex, with ``digest_{-1} = sha256("muse-audit-v1")``
    (the genesis digest).  Binding the entry INDEX into the hash means a
    reordered or spliced log breaks the chain even if payload bytes are
    individually intact.

``head()`` is the latest digest.  Clients persist ``(head, length)``
out-of-band after each append batch; ``verify(expected_head=...,
expected_length=...)`` then also detects whole-tail truncation, which a
self-contained chain cannot (a truncated chain is internally consistent).

Replay contract
---------------

``verify(ledger=...)`` replays every entry against a
:class:`GenerationLedger` — an archive of the exact transform parameters
``(betas, weights, src_quantiles, ref_quantiles)`` each predictor served
under each ``bank_generation`` (recorded via ``record_server`` /
``record_replicas`` whenever a generation is first observed).  For each
entry it recomputes:

  1. **the score** — the recorded ``raw_scores`` row is pushed through the
     SAME banked kernel the data plane ran
     (:func:`repro_torch.kernels.ops.score_pipeline_banked`, single-row
     bank) for the entry's generation; the result must equal the recorded
     ``score`` EXACTLY (f32 bit-for-bit, with no exception — per-row
     compute is batch-independent, and the edge padding a mixed bank gave
     the row's shorter tables changes no bit: a score at or past every
     knot maps to exactly ``qr[-1]`` on the padded and the unpadded table
     alike, see ``core/transforms.py::_at_last_knot``).
     On a CUDA ledger that is the hand-written kernel
     (``csrc/score_pipeline_banked.cu``), on either of its paths for the
     served window and on the L1/L2 path for the one-row replay;
  2. **the action** — :func:`repro_torch.serving.decision_loop.decide`
     applied to the recorded (score, thresholds, grace, cooldown) state
     inputs must reproduce the recorded ``action``.

A generation missing from the ledger, or a ledger re-record that disagrees
with what was already archived for a (generation, predictor), is a
structured failure — never a silent skip.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Mapping

import numpy as np
import torch

from repro_torch.core.transforms import banked_score_pipeline
from repro_torch.device import resolve_device, to_numpy
from repro_torch.kernels import ops
from repro_torch.serving.decision_loop import Decision, decide

GENESIS = hashlib.sha256(b"muse-audit-v1").hexdigest()


def canonical_payload(record: Mapping | Decision) -> str:
    """Canonical JSON for one decision record (sorted keys, compact).

    The digest of an entry depends only on the record's VALUES — any
    field/insertion order produces the same bytes.
    """
    if isinstance(record, Decision):
        record = dataclasses.asdict(record)
    record = dict(record)
    if isinstance(record.get("raw_scores"), tuple):
        record["raw_scores"] = list(record["raw_scores"])
    return json.dumps(record, sort_keys=True, separators=(",", ":"))


def chain_digest(prev: str, index: int, payload: str) -> str:
    h = hashlib.sha256()
    h.update(prev.encode())
    h.update(b"\n")
    h.update(str(index).encode())
    h.update(b"\n")
    h.update(payload.encode())
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class AuditEntry:
    index: int
    payload: str                      # canonical JSON decision record
    digest: str                       # chain digest AFTER this entry


@dataclasses.dataclass(frozen=True)
class AuditFailure:
    index: int                        # -1 for whole-log failures
    kind: str                         # chain|index|json|score_mismatch|...
    detail: str


@dataclasses.dataclass(frozen=True)
class AuditVerification:
    ok: bool
    entries: int
    head: str
    replayed: int                     # entries score-replayed via the ledger
    failures: tuple[AuditFailure, ...]


class GenerationLedger:
    """Archive of the exact per-generation transform parameters served.

    Keyed by ``(bank_generation, predictor)``; each value is the
    ``(betas, weights, src_quantiles, ref_quantiles)`` float32 tuple a
    single-row bank is rebuilt from at replay time.  ``record`` REFUSES a
    conflicting re-record: two replicas claiming different parameters for
    the same generation is exactly the provenance violation the fleet's
    fenced publish protocol exists to prevent, and the audit layer must
    surface it, not paper over it.

    Replays run on ``device`` (``None``: the card, or it raises): each
    archived row is copied there once, as a one-row bank.
    """

    def __init__(self, device: torch.device | str | None = None) -> None:
        self.device = resolve_device(device)
        self._rows: dict[tuple[int, str],
                         tuple[np.ndarray, np.ndarray, np.ndarray,
                               np.ndarray]] = {}
        # (generation, predictor) -> the one-row bank on ``device``
        self._banks: dict[tuple[int, str], tuple[torch.Tensor, ...]] = {}

    def __len__(self) -> int:
        return len(self._rows)

    def generations(self) -> set[int]:
        return {g for g, _ in self._rows}

    def record(self, generation: int, predictor: str, betas, weights,
               src_quantiles, ref_quantiles) -> None:
        row = tuple(np.asarray(to_numpy(a), np.float32).reshape(-1)
                    for a in (betas, weights, src_quantiles, ref_quantiles))
        key = (generation, predictor)
        have = self._rows.get(key)
        if have is not None:
            if not all(np.array_equal(a, b) for a, b in zip(have, row)):
                raise ValueError(
                    f"ledger conflict: generation {generation} predictor "
                    f"{predictor!r} re-recorded with different parameters")
            return
        self._rows[key] = row

    def record_server(self, server: "object") -> int:
        """Archive every live predictor's pipeline under the server's
        CURRENT bank generation; returns that generation."""
        gen = server.bank_generation
        for name, pred in server.predictors.items():
            p = pred.pipeline
            self.record(gen, name, p.betas, p.weights, p.src_quantiles,
                        p.ref_quantiles)
        return gen

    def record_replicas(self, replica_set: "object") -> set[int]:
        """Archive every ready replica's served parameters; returns the set
        of generations recorded (divergent fleets record several)."""
        reps = getattr(replica_set, "ready_replicas", None)
        if reps is None:
            reps = list(getattr(replica_set, "replicas", replica_set))
        return {self.record_server(r.server) for r in reps}

    def params(self, generation: int, predictor: str):
        return self._rows.get((generation, predictor))

    def replay_score(self, entry_fields: Mapping, *, fused: bool = True
                     ) -> float:
        """Recompute the transformed score for one decoded entry.

        Rebuilds a single-row bank from the archived generation parameters
        and pushes the recorded raw scores through the same banked pipeline
        the data plane ran.  Raises ``KeyError`` if the generation was
        never archived.
        """
        key = (int(entry_fields["bank_generation"]),
               str(entry_fields["predictor"]))
        row = self._rows.get(key)
        if row is None:
            raise KeyError(f"generation {key[0]} predictor {key[1]!r} "
                           f"not in ledger")
        bank = self._banks.get(key)
        if bank is None:
            bank = self._banks[key] = tuple(
                torch.from_numpy(a[None]).to(self.device) for a in row)
        raws = np.asarray(entry_fields["raw_scores"], np.float32)[None]
        impl = ops.score_pipeline_banked if fused else banked_score_pipeline
        out = impl(torch.from_numpy(raws).to(self.device),
                   torch.zeros((1,), dtype=torch.int32, device=self.device),
                   *bank)
        return float(to_numpy(out)[0])


class AuditLog:
    """Append-only hash chain of client decisions (format above)."""

    def __init__(self) -> None:
        self.entries: list[AuditEntry] = []
        self._head = GENESIS

    def __len__(self) -> int:
        return len(self.entries)

    def head(self) -> str:
        return self._head

    def append(self, decision: Decision | Mapping) -> AuditEntry:
        payload = canonical_payload(decision)
        index = len(self.entries)
        digest = chain_digest(self._head, index, payload)
        entry = AuditEntry(index=index, payload=payload, digest=digest)
        self.entries.append(entry)
        self._head = digest
        return entry

    # ------------------------------------------------------------------ verify
    def verify(self, ledger: GenerationLedger | None = None, *,
               expected_head: str | None = None,
               expected_length: int | None = None,
               fused: bool = True) -> AuditVerification:
        """Walk the chain; optionally replay every entry against ``ledger``.

        Chain pass: recompute every digest from the payload bytes — a
        single flipped byte anywhere (payload or stored digest) fails the
        entry where the chain diverges.  ``expected_head`` /
        ``expected_length`` (persisted out-of-band by the client) addition-
        ally detect truncation.  Replay pass (when a ledger is given):
        score and action must reproduce exactly per the module contract.
        """
        failures: list[AuditFailure] = []
        prev = GENESIS
        replayed = 0
        for i, entry in enumerate(self.entries):
            if entry.index != i:
                failures.append(AuditFailure(i, "index",
                                             f"stored index {entry.index}"))
            digest = chain_digest(prev, i, entry.payload)
            if digest != entry.digest:
                failures.append(AuditFailure(
                    i, "chain", "recomputed digest differs from stored"))
                prev = entry.digest    # resync to localize later tampering
                continue
            prev = digest
            try:
                fields = json.loads(entry.payload)
            except ValueError as e:
                failures.append(AuditFailure(i, "json", str(e)))
                continue
            try:
                action = decide(float(fields["score"]),
                                float(fields["threshold"]),
                                float(fields["block_threshold"]),
                                bool(fields["grace"]),
                                int(fields["cooldown"]))
                if action != fields["action"]:
                    failures.append(AuditFailure(
                        i, "action_mismatch",
                        f"recorded {fields['action']!r}, replayed "
                        f"{action!r}"))
            except (KeyError, TypeError, ValueError) as e:
                failures.append(AuditFailure(i, "json",
                                             f"malformed record: {e}"))
                continue
            if ledger is not None:
                try:
                    score = ledger.replay_score(fields, fused=fused)
                except KeyError as e:
                    failures.append(AuditFailure(i, "unknown_generation",
                                                 str(e)))
                    continue
                replayed += 1
                if score != float(fields["score"]):
                    failures.append(AuditFailure(
                        i, "score_mismatch",
                        f"recorded {fields['score']!r}, replayed {score!r} "
                        f"under generation {fields['bank_generation']}"))
        if expected_length is not None and len(self.entries) != expected_length:
            failures.append(AuditFailure(
                -1, "truncated",
                f"{len(self.entries)} entries, expected {expected_length}"))
        if expected_head is not None and prev != expected_head:
            failures.append(AuditFailure(
                -1, "head_mismatch",
                f"head {prev[:16]}..., expected {expected_head[:16]}..."))
        return AuditVerification(
            ok=not failures, entries=len(self.entries), head=prev,
            replayed=replayed, failures=tuple(failures))
