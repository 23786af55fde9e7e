"""Client decisions and the audit log of the port, against the JAX package.

* The chain: canonical payloads, digests and ``head()`` equal the
  reference's for identical ``Decision`` records; tampering, reordering and
  truncation (against ``expected_head`` / ``expected_length``) are each
  detected.
* The client: ``decide`` and ``DecisionPolicy.thresholds`` are exact
  against the reference, and ``DecisionLoop`` makes the reference's
  decisions from the same responses.
* Replay: a CPU log served across three generations (cold prior, a
  published refit with a different knot count, a fast-forward) replays
  with zero failures through the plain banked version (``fused=False``)
  and through ``ops`` (``fused=True``, the plain version on a CPU
  tensor), including rows whose tables the served bank edge-padded.
* ``AttackCampaign`` samples, waves and schedules are bitwise the
  reference's for the same seed.
"""
import dataclasses
import itertools
import json

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.experiments.fraud_world import AttackCampaign as JCampaign
from repro.serving import audit as jaudit
from repro.serving import decision_loop as jloop
from repro.serving import types as jtypes
from repro.core import routing as jrouting
from repro_torch.core.predictor import PredictorSpec
from repro_torch.core.routing import Condition, Intent, RoutingTable, ScoringRule
from repro_torch.core.transforms import QuantileMap
from repro_torch.experiments.fraud_world import AttackCampaign
from repro_torch.kernels import ops
from repro_torch.serving import audit
from repro_torch.serving.audit import AuditLog, GenerationLedger
from repro_torch.serving.decision_loop import (Decision, DecisionLoop,
                                               DecisionPolicy, decide)
from repro_torch.serving.server import MuseServer, ServerConfig
from repro_torch.serving.types import ScoringRequest

DIM = 8
REF = np.linspace(0.0, 1.0, 64) ** 2


def _record(rng, seq: int, gen: int = 1) -> Decision:
    score = float(np.float32(rng.uniform(0, 1)))
    tau, block = float(rng.uniform(0.3, 0.9)), float(rng.uniform(0.9, 1.0))
    grace, cool = bool(rng.integers(0, 2)), int(rng.integers(0, 3))
    return Decision(
        request_id=seq, tenant=f"t{seq % 3}", predictor="p0", score=score,
        raw_scores=tuple(float(np.float32(v)) for v in rng.uniform(0, 1, 3)),
        bank_generation=gen, threshold=tau, block_threshold=block,
        action=decide(score, tau, block, grace, cool), seq=seq, grace=grace,
        cooldown=cool)


def _jrecord(d: Decision):
    return jloop.Decision(**dataclasses.asdict(d))


class TestChainAgainstTheReference:
    @given(st.integers(0, 10_000), st.integers(1, 30))
    @settings(max_examples=10)
    def test_digests_and_head_equal(self, seed, n):
        rng = np.random.default_rng(seed)
        records = [_record(rng, i) for i in range(n)]
        log, jlog = AuditLog(), jaudit.AuditLog()
        for d in records:
            e, je = log.append(d), jlog.append(_jrecord(d))
            assert e.payload == je.payload == jaudit.canonical_payload(
                _jrecord(d)) == audit.canonical_payload(d)
            assert e.digest == je.digest
        assert log.head() == jlog.head() != audit.GENESIS
        assert audit.GENESIS == jaudit.GENESIS
        v = log.verify(expected_head=jlog.head(), expected_length=n)
        assert v.ok and v.head == jlog.head()

    def test_chain_digest_equal(self):
        assert audit.chain_digest("ab", 7, "{}") == \
            jaudit.chain_digest("ab", 7, "{}")

    @pytest.mark.parametrize("entry", [0, 4, 9])
    def test_tamper_detected_at_its_index(self, entry):
        rng = np.random.default_rng(entry)
        log = AuditLog()
        for i in range(10):
            log.append(_record(rng, i))
        e = log.entries[entry]
        pos = len(e.payload) // 2
        flipped = chr((ord(e.payload[pos]) + 1) % 128)
        log.entries[entry] = dataclasses.replace(
            e, payload=e.payload[:pos] + flipped + e.payload[pos + 1:])
        v = log.verify()
        assert not v.ok
        assert [f.index for f in v.failures if f.kind == "chain"] == [entry]

    def test_reorder_detected(self):
        rng = np.random.default_rng(3)
        log = AuditLog()
        for i in range(6):
            log.append(_record(rng, i))
        log.entries[2], log.entries[3] = log.entries[3], log.entries[2]
        v = log.verify()
        assert not v.ok
        assert any(f.kind in ("chain", "index") for f in v.failures)

    @pytest.mark.parametrize("n_drop", [1, 4])
    def test_truncation_detected(self, n_drop):
        rng = np.random.default_rng(n_drop)
        log = AuditLog()
        for i in range(9):
            log.append(_record(rng, i))
        head, length = log.head(), len(log)
        del log.entries[-n_drop:]
        assert log.verify().ok
        v = log.verify(expected_head=head, expected_length=length)
        assert {f.kind for f in v.failures} == {"truncated", "head_mismatch"}


class TestClientAgainstTheReference:
    @given(st.floats(0.0, 1.0), st.floats(0.2, 0.9), st.booleans(),
           st.integers(0, 3))
    @settings(max_examples=20)
    def test_decide_exact(self, score, tau, grace, cool):
        for block in (0.95, tau):
            assert decide(score, tau, block, grace, cool) == \
                jloop.decide(score, tau, block, grace, cool)

    @pytest.mark.parametrize("a,b", [(0.02, 0.0005), (0.1, 0.02),
                                     (0.5, 0.5)])
    def test_thresholds_exact(self, a, b):
        for ref in (REF, np.linspace(0, 1, 256), np.sort(
                np.random.default_rng(0).uniform(0, 1, 97))):
            assert DecisionPolicy(a, b).thresholds(ref) == \
                jloop.DecisionPolicy(a, b).thresholds(ref)

    def test_decision_loop_matches_the_reference(self):
        rng = np.random.default_rng(5)
        policy = dict(alert_rate=0.1, block_rate=0.02, grace_events=3,
                      cooldown_events=2)
        loop = DecisionLoop(DecisionPolicy(**policy), REF, audit=AuditLog())
        jl = jloop.DecisionLoop(jloop.DecisionPolicy(**policy), REF,
                                audit=jaudit.AuditLog())
        for w in range(4):
            tenants = [f"t{i}" for i in rng.integers(0, 3, 40)]
            scores = rng.uniform(0, 1, 40).astype(np.float32).tolist()
            reqs = [ScoringRequest(Intent(tenant=t), np.zeros(2, np.float32),
                                   request_id=100 * w + i)
                    for i, t in enumerate(tenants)]
            jreqs = [jtypes.ScoringRequest(jrouting.Intent(tenant=t),
                                           np.zeros(2, np.float32),
                                           request_id=100 * w + i)
                     for i, t in enumerate(tenants)]
            resps = [_resp(s, 100 * w + i) for i, s in enumerate(scores)]
            got = loop.process(reqs, resps)
            want = jl.process(jreqs, resps)
            assert [dataclasses.asdict(d) for d in got] == \
                [dataclasses.asdict(d) for d in want]
        assert loop.realized_rates() == jl.realized_rates()
        assert loop.audit.head() == jl.audit.head()


def _resp(score: float, rid: int, gen: int = 1):
    return jtypes.ScoringResponse(
        request_id=rid, score=score, predictor="p0", routing_version="v1",
        latency_ms=0.1, raw_scores=(score,), bank_generation=gen)


def _linear_model(seed: int):
    w = np.random.default_rng(seed).normal(0, 1, DIM).astype(np.float32)
    return lambda x: 1.0 / (1.0 + np.exp(-(np.asarray(x, np.float32) @ w)))


FACTORIES = {f"m{i}": (lambda i=i: _linear_model(i)) for i in (1, 2)}


def _served_log(n_tenants: int = 3, per_window: int = 24):
    """Three generations on one CPU server: every predictor on a 32-knot
    prior, then p0 refit to 64 knots (the bank pads p1 and p2 to 64), then
    an empty fenced publish; each tenant's decisions audited."""
    rules = tuple(ScoringRule(Condition(tenants=(f"t{i}",)), f"p{i}")
                  for i in range(n_tenants))
    server = MuseServer(RoutingTable(rules, version="v1"),
                        ServerConfig(track_quantiles=False), device="cpu")
    prior = QuantileMap.fit(np.random.default_rng(1).beta(2, 5, 4000), REF,
                            np.linspace(0, 1, 64))
    prior = QuantileMap(prior.src_quantiles[::2].contiguous(),
                        prior.ref_quantiles[::2].contiguous())
    for i in range(n_tenants):
        server.deploy(PredictorSpec(f"p{i}", ("m1", "m2"), (0.2, 0.4),
                                    (1.0, 1.0), prior), FACTORIES)
    log, ledger = AuditLog(), GenerationLedger(device="cpu")
    loop = DecisionLoop(DecisionPolicy(alert_rate=0.1, block_rate=0.02,
                                       cooldown_events=2), REF, audit=log)
    rng = np.random.default_rng(9)
    rid = itertools.count()

    def serve(n_windows):
        for _ in range(n_windows):
            reqs = [ScoringRequest(Intent(tenant=f"t{i % n_tenants}"),
                                   rng.normal(0, 1, DIM).astype(np.float32),
                                   request_id=next(rid))
                    for i in range(per_window)]
            loop.process(reqs, server.score_batch(reqs))

    ledger.record_server(server)
    serve(2)
    server.publish_quantile_maps({"p0": QuantileMap.fit(
        rng.beta(2, 5, 3000), REF)})
    ledger.record_server(server)
    serve(2)
    server.publish_quantile_maps({}, generation=7)
    ledger.record_server(server)
    serve(2)
    return log, ledger, server


class TestReplay:
    @pytest.mark.parametrize("fused", [False, True])
    def test_three_generation_log_replays_bitwise(self, fused):
        log, ledger, server = _served_log()
        assert ledger.generations() == {0, 1, 7}
        gens = {json.loads(e.payload)["bank_generation"] for e in log.entries}
        assert gens == {0, 1, 7}
        # the served bank padded p1's and p2's 32-knot tables to 64 knots
        (entry,) = server._banks.values()
        assert entry.bank.num_quantiles == 64
        assert ledger.params(7, "p1")[2].shape == (32,)
        before = dict(ops.LAUNCHES)
        v = log.verify(ledger, expected_head=log.head(),
                       expected_length=len(log), fused=fused)
        assert v.ok, v.failures[:3]
        assert v.replayed == len(log) == 144
        assert ops.LAUNCHES == before          # a CPU ledger launches nothing

    def test_score_tamper_caught_by_replay(self):
        log, ledger, _ = _served_log()
        fields = json.loads(log.entries[7].payload)
        fields["score"] = fields["score"] + 1e-3
        forged = AuditLog()
        forged.append(fields)
        v = forged.verify(ledger, fused=False)
        assert any(f.kind in ("score_mismatch", "action_mismatch")
                   for f in v.failures)

    def test_unknown_generation_and_ledger_conflict(self):
        log, ledger, _ = _served_log()
        fields = json.loads(log.entries[3].payload)
        fields["bank_generation"] = 999
        forged = AuditLog()
        forged.append(fields)
        v = forged.verify(ledger)
        assert [f.kind for f in v.failures] == ["unknown_generation"]
        betas, weights, src, ref = ledger.params(7, "p0")
        with pytest.raises(ValueError, match="ledger conflict"):
            ledger.record(7, "p0", betas + 1.0, weights, src, ref)
        ledger.record(7, "p0", betas, weights, src, ref)   # same: accepted

    def test_replay_equals_the_reference_ledger(self):
        """The reference's ledger, given the same archived rows, replays
        every entry to the same score through its plain banked version
        (within the reference's f32 tolerance: the packages' sums differ in
        the last bits)."""
        log, ledger, _ = _served_log()
        jledger = jaudit.GenerationLedger()
        for (gen, pred), row in ledger._rows.items():
            jledger.record(gen, pred, *row)
        for e in log.entries[::5]:
            fields = json.loads(e.payload)
            assert jledger.replay_score(fields, fused=False) == \
                pytest.approx(ledger.replay_score(fields), abs=2e-5)


class TestAttackCampaignAgainstTheReference:
    @pytest.mark.parametrize("seed", [0, 11])
    def test_samples_waves_and_schedule_bitwise(self, seed):
        names = ("bankA", "bankB", "bankC")
        got = AttackCampaign.build(names, n_days=8, n_waves=2, seed=seed,
                                   dim=DIM)
        want = JCampaign.build(names, n_days=8, n_waves=2, seed=seed,
                               dim=DIM)
        assert [dataclasses.asdict(w) for w in got.waves] == \
            [dataclasses.asdict(w) for w in want.waves]
        assert [dataclasses.asdict(d) for d in got.schedule()] == \
            [dataclasses.asdict(d) for d in want.schedule()]
        for t in names:
            assert np.array_equal(got._direction(t), want._direction(t))
            for day in range(8):
                x, y = got.sample(t, day, 300)
                jx, jy = want.sample(t, day, 300)
                assert x.dtype == jx.dtype == np.float32
                assert np.array_equal(x, jx) and np.array_equal(y, jy)

    def test_sampling_is_order_independent(self):
        names = ("bankA", "bankB")
        a = AttackCampaign.build(names, n_days=6, seed=3, dim=DIM)
        b = AttackCampaign.build(names, n_days=6, seed=3, dim=DIM)
        for t in reversed(names):
            b.sample(t, 4, 64)
        assert np.array_equal(a.sample("bankA", 2, 128)[0],
                              b.sample("bankA", 2, 128)[0])
