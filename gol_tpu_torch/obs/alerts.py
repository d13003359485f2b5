"""Declarative threshold alerting over the aggregated fleet signals — the
counterpart of `gol_tpu/obs/alerts.py`.

Rules fire on the signal dict the registry-side aggregator
(obs/export.py `FleetTelemetry`) computes at every router sweep — the
same rollups published as `gol_fed_agg_*` — with firing→resolved
hysteresis so a flapping signal cannot strobe the alert surface:

    inactive --breach--> pending --breach for `for_s`--> firing
    firing   --clear continuously for `clear_s`-->       inactive

A breach that clears while pending quietly resets (no event). A
firing rule that dips below threshold starts a clear timer; any
breach inside `clear_s` cancels it (flap suppression). Transitions
are fully observable: `gol_alerts_active{rule}` (0/1),
`gol_alerts_fired_total{rule}`, a flight-recorder event, and an
audit-log record per transition (via the callback the router wires).

Built-in rules (thresholds env-tunable):

    member-death        members_dead > 0            (immediate)
    staleness-ceiling   staleness_p99_ms > GOL_ALERT_STALENESS_MS
    queue-depth         queue_depth > GOL_ALERT_QUEUE_DEPTH
    resident-imbalance  imbalance_ratio > GOL_ALERT_IMBALANCE
                        (needs >= 2 members reporting)

Extra rules ride GOL_ALERT_RULES, a JSON list:

    [{"name": "cups-floor", "signal": "cups", "op": "<",
      "threshold": 1e6, "for_s": 10, "clear_s": 30}]

A rule whose signal is absent from the evaluation dict is skipped in
place — state and timers hold — so a member dropping a snapshot
family cannot fake a resolve. Stdlib-only.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional

from gol_tpu_torch.obs import catalog as obs
from gol_tpu_torch.obs.log import log as obs_log

__all__ = ["AlertRule", "AlertManager", "builtin_rules", "rules_from_env"]

ENV_RULES = "GOL_ALERT_RULES"
ENV_STALENESS = "GOL_ALERT_STALENESS_MS"
ENV_QUEUE = "GOL_ALERT_QUEUE_DEPTH"
ENV_IMBALANCE = "GOL_ALERT_IMBALANCE"
ENV_FOR = "GOL_ALERT_FOR_S"
ENV_CLEAR = "GOL_ALERT_CLEAR_S"

DEFAULT_STALENESS_MS = 30_000.0
DEFAULT_QUEUE_DEPTH = 64.0
DEFAULT_IMBALANCE = 3.0
DEFAULT_FOR_S = 1.0
DEFAULT_CLEAR_S = 5.0

_OPS: Dict[str, Callable[[float, float], bool]] = {
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
}

# States of the per-rule hysteresis machine.
INACTIVE, PENDING, FIRING = "inactive", "pending", "firing"


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class AlertRule:
    """One threshold rule. `requires` names signals that must be
    present (and truthy-nonzero) for the rule to evaluate at all —
    resident-imbalance uses it to stay quiet on 0/1-member fleets."""

    __slots__ = ("name", "signal", "op", "threshold", "for_s",
                 "clear_s", "requires")

    def __init__(self, name: str, signal: str, op: str = ">",
                 threshold: float = 0.0, for_s: float = 0.0,
                 clear_s: Optional[float] = None,
                 requires: tuple = ()) -> None:
        if op not in _OPS:
            raise ValueError(f"alert rule {name!r}: bad op {op!r}")
        self.name = str(name)
        self.signal = str(signal)
        self.op = op
        self.threshold = float(threshold)
        self.for_s = max(float(for_s), 0.0)
        self.clear_s = (_env_float(ENV_CLEAR, DEFAULT_CLEAR_S)
                        if clear_s is None else max(float(clear_s), 0.0))
        self.requires = tuple(requires)

    def breached(self, value: float) -> bool:
        return _OPS[self.op](float(value), self.threshold)

    def doc(self) -> dict:
        return {"name": self.name, "signal": self.signal, "op": self.op,
                "threshold": self.threshold, "for_s": self.for_s,
                "clear_s": self.clear_s}


def builtin_rules() -> List[AlertRule]:
    for_s = _env_float(ENV_FOR, DEFAULT_FOR_S)
    return [
        # A death verdict is already debounced by GOL_FED_DEAD_AFTER;
        # alerting adds zero extra latency on top of it.
        AlertRule("member-death", "members_dead", ">", 0.0, for_s=0.0),
        AlertRule("staleness-ceiling", "staleness_p99_ms", ">",
                  _env_float(ENV_STALENESS, DEFAULT_STALENESS_MS),
                  for_s=for_s),
        AlertRule("queue-depth", "queue_depth", ">",
                  _env_float(ENV_QUEUE, DEFAULT_QUEUE_DEPTH),
                  for_s=for_s),
        AlertRule("resident-imbalance", "imbalance_ratio", ">",
                  _env_float(ENV_IMBALANCE, DEFAULT_IMBALANCE),
                  for_s=for_s, requires=("members_multi",)),
    ]


def rules_from_env() -> List[AlertRule]:
    raw = os.environ.get(ENV_RULES, "").strip()
    if not raw:
        return []
    try:
        specs = json.loads(raw)
        return [AlertRule(
            name=s["name"], signal=s["signal"],
            op=s.get("op", ">"), threshold=s.get("threshold", 0.0),
            for_s=s.get("for_s", 0.0), clear_s=s.get("clear_s"),
        ) for s in specs]
    except (ValueError, KeyError, TypeError) as e:
        obs_log("alerts.bad_rules", level="warning", error=repr(e))
        return []


class _RuleState:
    __slots__ = ("state", "since", "clear_since", "value")

    def __init__(self) -> None:
        self.state = INACTIVE
        self.since = 0.0        # breach start (pending) / fire time
        self.clear_since = 0.0  # 0 = no clear window open
        self.value = 0.0


class AlertManager:
    """Evaluates the rule set against one signals dict per sweep.

    Single-threaded by contract (the router's sweep loop); the
    transition sink (`on_transition(rule, event, value, now)`) is
    where the router hangs its audit-log append."""

    def __init__(self, rules: Optional[List[AlertRule]] = None,
                 on_transition=None) -> None:
        self.rules = (builtin_rules() + rules_from_env()
                      if rules is None else list(rules))
        self.on_transition = on_transition
        self._state = {r.name: _RuleState() for r in self.rules}
        self._seed_metrics()

    def _seed_metrics(self) -> None:
        for r in self.rules:
            obs.ALERTS_ACTIVE.labels(rule=r.name).set(0)
            obs.ALERTS_FIRED.labels(rule=r.name)

    # --------------------------------------------------------- evaluate

    def evaluate(self, signals: dict,
                 now: Optional[float] = None) -> list:
        """One sweep. Returns the transitions that happened:
        [{"rule", "event": "fired"|"resolved", "value"}, ...]."""
        if now is None:
            now = time.time()
        transitions = []
        for rule in self.rules:
            st = self._state[rule.name]
            if any(not signals.get(req) for req in rule.requires):
                continue
            value = signals.get(rule.signal)
            if value is None:
                continue  # no data: hold state, no timer progress
            value = float(value)
            st.value = value
            breach = rule.breached(value)
            if st.state == INACTIVE and breach:
                # Enter pending; a for_s of 0 promotes to firing in the
                # same sweep (now - since == 0 satisfies >= 0).
                st.since = now
                st.state = PENDING
            if st.state == PENDING:
                if not breach:
                    st.state = INACTIVE
                elif now - st.since >= rule.for_s:
                    st.state = FIRING
                    st.since = now
                    st.clear_since = 0.0
                    self._transition(rule, "fired", value, now)
                    transitions.append({"rule": rule.name,
                                        "event": "fired",
                                        "value": value})
            elif st.state == FIRING:
                if breach:
                    st.clear_since = 0.0  # flap: cancel the clear window
                else:
                    if st.clear_since == 0.0:
                        st.clear_since = now
                    if now - st.clear_since >= rule.clear_s:
                        st.state = INACTIVE
                        st.clear_since = 0.0
                        self._transition(rule, "resolved", value, now)
                        transitions.append({"rule": rule.name,
                                            "event": "resolved",
                                            "value": value})
        return transitions

    def _transition(self, rule: AlertRule, event: str, value: float,
                    now: float) -> None:
        obs.ALERTS_ACTIVE.labels(rule=rule.name).set(
            1 if event == "fired" else 0)
        if event == "fired":
            obs.ALERTS_FIRED.labels(rule=rule.name).inc()
        obs_log(f"alert.{event}", level="warning", rule=rule.name,
                signal=rule.signal, value=value, threshold=rule.threshold)
        if self.on_transition is not None:
            try:
                self.on_transition(rule, event, value, now)
            except Exception:
                pass

    # ------------------------------------------------------------ reads

    def active(self) -> dict:
        return {name: {"since": st.since, "value": st.value}
                for name, st in self._state.items()
                if st.state == FIRING}

    def doc(self) -> dict:
        return {
            "rules": [r.doc() for r in self.rules],
            "active": self.active(),
            "states": {name: st.state
                       for name, st in self._state.items()},
        }
