"""Rendezvous (highest-random-weight) placement for the router tier — the
counterpart of `gol_tpu/federation/hrw.py`, with the same score, so both
packages' routers place every run on the same member.

Each (member, run_id) pair gets a deterministic 64-bit score from a
SHA-256 digest; a run lives on the live member with the highest score.
Removing one member of N moves ONLY the runs that member owned, and
adding one moves only the ~1/(N+1) of runs whose new score beats their
old owner's: failover adoption stays proportional to the dead member's
share of the fleet.

Scores are keyed on member_id (the member's advertised address), so
every router instance, and a restarted router with an empty placement
map, computes identical placements from the same membership view.
"""

from __future__ import annotations

import hashlib
from typing import Iterable, List, Optional


def score(member_id: str, run_id: str) -> int:
    """Deterministic 64-bit rendezvous weight for one (member, run)."""
    digest = hashlib.sha256(f"{member_id}|{run_id}".encode()).digest()
    return int.from_bytes(digest[:8], "big")


def rank(run_id: str, member_ids: Iterable[str]) -> List[str]:
    """Members ordered by descending rendezvous score for `run_id`. The
    head is the placement; the tail is the failover order (ties broken by
    member_id so the order is total)."""
    return sorted(set(member_ids),
                  key=lambda m: (score(m, run_id), m), reverse=True)


def place(run_id: str, member_ids: Iterable[str]) -> Optional[str]:
    """The highest-scoring member for `run_id`, or None if empty."""
    members = set(member_ids)
    if not members:
        return None
    return max(members, key=lambda m: (score(m, run_id), m))
