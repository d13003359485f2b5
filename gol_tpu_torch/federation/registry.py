"""Federation member registry: who is alive, and since when — the
counterpart of `gol_tpu/federation/registry.py`.

Each fleet server registers with the router over the wire protocol
(`RegisterMember`) carrying its advertised address, capacity, device
geometry, and a MONOTONICALLY increasing heartbeat sequence number. The
registry stamps every accepted beat with its own monotonic clock (member
clocks are never compared), and a sequence that does not advance is
ignored, so a delayed duplicate cannot resurrect a quieter member.

Death is declared by the router's sweep: a live member whose last stamp
is older than `GOL_FED_DEAD_AFTER` seconds moves to "dead", increments
`gol_fed_failovers_total`, and is returned to the caller so the router
can adopt its runs. A dead member that registers again (a restarted
process) moves back to live with a fresh sequence epoch.

Gauges: `gol_fed_members{state}` tracks the census on every change;
`gol_fed_heartbeat_age_ms{q}` publishes heartbeat-age quantiles across
live members at each sweep. `/healthz` serves `members_doc()` through
the module-level active-registry pointer (reference-swapped, so the HTTP
thread never takes the registry lock).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from gol_tpu_torch.obs import catalog as obs
from gol_tpu_torch.obs import slo as obs_slo
from gol_tpu_torch.utils.envcfg import env_float

HEARTBEAT_ENV = "GOL_FED_HEARTBEAT"
HEARTBEAT_DEFAULT_S = 0.5
DEAD_AFTER_ENV = "GOL_FED_DEAD_AFTER"
DEAD_AFTER_DEFAULT_S = 2.0


def heartbeat_interval_s() -> float:
    return max(0.05, env_float(HEARTBEAT_ENV, HEARTBEAT_DEFAULT_S))


def dead_after_s() -> float:
    """Heartbeat-lapse death threshold; never below one heartbeat."""
    return max(heartbeat_interval_s(),
               env_float(DEAD_AFTER_ENV, DEAD_AFTER_DEFAULT_S))


class Member:
    """One registered fleet server, as the router sees it."""

    __slots__ = ("member_id", "address", "capacity", "mesh", "state",
                 "hb_seq", "hb_stamp_s", "registered_s", "died_s")

    def __init__(self, member_id: str, address: str,
                 capacity: int = 0, mesh: Optional[dict] = None) -> None:
        self.member_id = member_id
        self.address = address
        self.capacity = int(capacity)
        self.mesh = mesh
        self.state = "live"
        self.hb_seq = -1
        self.hb_stamp_s = time.monotonic()
        self.registered_s = time.time()
        self.died_s: Optional[float] = None

    def doc(self, now: Optional[float] = None) -> dict:
        now = time.monotonic() if now is None else now
        return {
            "member_id": self.member_id,
            "address": self.address,
            "capacity": self.capacity,
            "mesh": self.mesh,
            "state": self.state,
            "hb_seq": self.hb_seq,
            "hb_age_ms": round((now - self.hb_stamp_s) * 1e3, 1),
        }


class MemberRegistry:
    """Thread-safe membership view + heartbeat sweep."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._members: Dict[str, Member] = {}
        # Reference-swapped /healthz document (readers never lock).
        self._doc: dict = {"members": [], "live": 0, "dead": 0}

    # -- registration / heartbeat (wire-facing) -----------------------

    def register(self, member_id: str, address: str, seq: int,
                 capacity: int = 0,
                 mesh: Optional[dict] = None) -> dict:
        """Register-or-heartbeat: the first beat creates the member, later
        ones advance its stamp iff `seq` advanced. Returns the ack dict
        ({"live": N} rides the reply so members can log the census they
        joined)."""
        now = time.monotonic()
        with self._lock:
            m = self._members.get(member_id)
            joined = m is None
            if joined:
                m = Member(member_id, address, capacity=capacity,
                           mesh=mesh)
                self._members[member_id] = m
            was_dead = m.state == "dead"
            if was_dead:
                # Restarted process: fresh sequence epoch, back to live.
                m.state = "live"
                m.died_s = None
                m.hb_seq = -1
            m.address = address
            if capacity:
                m.capacity = int(capacity)
            if mesh is not None:
                m.mesh = mesh
            accepted = int(seq) > m.hb_seq
            if accepted:
                m.hb_seq = int(seq)
                m.hb_stamp_s = now
            live = sum(1 for x in self._members.values()
                       if x.state == "live")
        self._publish()
        return {"registered": True, "accepted": accepted,
                "joined": joined, "rejoined": was_dead, "live": live}

    # -- queries ------------------------------------------------------

    def live_members(self) -> List[Member]:
        with self._lock:
            return [m for m in self._members.values()
                    if m.state == "live"]

    def live_ids(self) -> List[str]:
        return [m.member_id for m in self.live_members()]

    def get(self, member_id: str) -> Optional[Member]:
        with self._lock:
            return self._members.get(member_id)

    def members_doc(self) -> dict:
        """The cached /healthz member table (lock-free read)."""
        return self._doc

    # -- sweep --------------------------------------------------------

    def sweep(self, now: Optional[float] = None) -> List[Member]:
        """Declare death for live members whose heartbeat lapsed; returns
        the NEWLY dead members (the router adopts their runs). Also
        publishes the census gauges and heartbeat-age quantiles."""
        now = time.monotonic() if now is None else now
        cutoff = dead_after_s()
        newly_dead: List[Member] = []
        ages: List[float] = []
        with self._lock:
            for m in self._members.values():
                if m.state != "live":
                    continue
                age = now - m.hb_stamp_s
                if age > cutoff:
                    m.state = "dead"
                    m.died_s = time.time()
                    newly_dead.append(m)
                else:
                    ages.append(age)
        for _ in newly_dead:
            obs.FED_FAILOVERS.inc()
        if ages:
            for q, v in zip(obs.SLO_QUANTILES,
                            obs_slo.exact_percentiles(
                                ages, (0.50, 0.95, 0.99))):
                obs.FED_HEARTBEAT_AGE_MS.labels(q=q).set(
                    round(v * 1e3, 3))
        self._publish()
        return newly_dead

    def _publish(self) -> None:
        now = time.monotonic()
        with self._lock:
            docs = [m.doc(now) for m in self._members.values()]
        live = sum(1 for d in docs if d["state"] == "live")
        dead = len(docs) - live
        obs.FED_MEMBERS.labels(state="live").set(live)
        obs.FED_MEMBERS.labels(state="dead").set(dead)
        self._doc = {"members": sorted(docs,
                                       key=lambda d: d["member_id"]),
                     "live": live, "dead": dead}


# -- /healthz hook: the process's active registry ---------------------

_active: Optional[MemberRegistry] = None


def set_active(reg: Optional[MemberRegistry]) -> None:
    global _active
    _active = reg


def active_doc() -> Optional[dict]:
    """The active registry's member table, or None when this process runs
    no router (so /healthz adds no federation key)."""
    reg = _active
    return None if reg is None else reg.members_doc()
