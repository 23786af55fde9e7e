"""Intent-based routing (paper Sec. 2.5, Fig. 2).

Clients express a *scoring intent* — request metadata such as tenant id,
geography, schema, payment channel — never a model name.  The routing table
maps intents to predictors:

  * ``scoring_rules``: evaluated **sequentially**, first match wins, resolves
    to exactly one *live* predictor (its score is returned to the client).
  * ``shadow_rules``: evaluated **in parallel**, every match fires, each
    resolves to one or more *shadow* predictors whose responses are logged to
    the data lake sink but never returned.

The table is an immutable value object: "transparent model switching" is
publishing a new table version and letting the rollout controller swap it —
there is no in-place mutation, mirroring the paper's stateless design.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence


@dataclasses.dataclass(frozen=True)
class Intent:
    """Request metadata carried by every scoring call."""

    tenant: str
    geography: str = ""
    schema: str = ""
    channel: str = ""
    extra: Mapping[str, str] = dataclasses.field(default_factory=dict)

    def get(self, field: str) -> str:
        if field in ("tenant", "geography", "schema", "channel"):
            return getattr(self, field)
        return self.extra.get(field, "")


@dataclasses.dataclass(frozen=True)
class Condition:
    """Conjunctive match over intent fields; empty lists match anything.

    Matches Fig. 2 semantics: ``condition: {}`` is a catch-all; each present
    field is an OR-list; fields combine with AND.
    """

    tenants: tuple[str, ...] = ()
    geographies: tuple[str, ...] = ()
    schemas: tuple[str, ...] = ()
    channels: tuple[str, ...] = ()
    extra: Mapping[str, tuple[str, ...]] = dataclasses.field(default_factory=dict)

    def matches(self, intent: Intent) -> bool:
        checks = [
            (self.tenants, intent.tenant),
            (self.geographies, intent.geography),
            (self.schemas, intent.schema),
            (self.channels, intent.channel),
        ]
        for allowed, value in checks:
            if allowed and value not in allowed:
                return False
        for field, allowed in self.extra.items():
            if allowed and intent.get(field) not in allowed:
                return False
        return True

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "Condition":
        known = {"tenants", "geographies", "schemas", "channels"}
        extra = {k: tuple(v) for k, v in d.items() if k not in known}
        return Condition(
            tenants=tuple(d.get("tenants", ())),
            geographies=tuple(d.get("geographies", ())),
            schemas=tuple(d.get("schemas", ())),
            channels=tuple(d.get("channels", ())),
            extra=extra,
        )


@dataclasses.dataclass(frozen=True)
class ScoringRule:
    condition: Condition
    target_predictor: str
    description: str = ""


@dataclasses.dataclass(frozen=True)
class ShadowRule:
    condition: Condition
    target_predictors: tuple[str, ...]
    description: str = ""


@dataclasses.dataclass(frozen=True)
class Resolution:
    live: str
    shadows: tuple[str, ...]
    rule_description: str = ""


class NoMatchingRule(LookupError):
    pass


@dataclasses.dataclass(frozen=True)
class RoutingTable:
    """Immutable, versioned routing configuration."""

    scoring_rules: tuple[ScoringRule, ...]
    shadow_rules: tuple[ShadowRule, ...] = ()
    version: str = "v0"

    def resolve(self, intent: Intent) -> Resolution:
        live: str | None = None
        desc = ""
        for rule in self.scoring_rules:  # sequential, first match wins
            if rule.condition.matches(intent):
                live = rule.target_predictor
                desc = rule.description
                break
        if live is None:
            raise NoMatchingRule(
                f"no scoring rule matches intent {intent} (table {self.version})"
            )
        shadows: list[str] = []
        for rule in self.shadow_rules:  # parallel, all matches fire
            if rule.condition.matches(intent):
                for name in rule.target_predictors:
                    if name != live and name not in shadows:
                        shadows.append(name)
        return Resolution(live=live, shadows=tuple(shadows), rule_description=desc)

    def referenced_predictors(self) -> tuple[str, ...]:
        names: list[str] = []
        for r in self.scoring_rules:
            if r.target_predictor not in names:
                names.append(r.target_predictor)
        for s in self.shadow_rules:
            for n in s.target_predictors:
                if n not in names:
                    names.append(n)
        return tuple(names)

    def with_rule_update(self, old_predictor: str, new_predictor: str,
                         version: str) -> "RoutingTable":
        """Transparent model switching: retarget rules, bump version."""
        new_scoring = tuple(
            dataclasses.replace(r, target_predictor=new_predictor)
            if r.target_predictor == old_predictor
            else r
            for r in self.scoring_rules
        )
        return dataclasses.replace(self, scoring_rules=new_scoring, version=version)

    @staticmethod
    def from_dict(cfg: Mapping[str, Any], version: str = "v0") -> "RoutingTable":
        """Parse the Fig.-2-style declarative config."""
        routing = cfg.get("routing", cfg)
        scoring = tuple(
            ScoringRule(
                condition=Condition.from_dict(r.get("condition", {})),
                target_predictor=r["targetPredictorName"],
                description=r.get("description", ""),
            )
            for r in routing.get("scoringRules", ())
        )
        shadow = tuple(
            ShadowRule(
                condition=Condition.from_dict(r.get("condition", {})),
                target_predictors=tuple(r["targetPredictorNames"]),
                description=r.get("description", ""),
            )
            for r in routing.get("shadowRules", ())
        )
        return RoutingTable(scoring_rules=scoring, shadow_rules=shadow, version=version)
