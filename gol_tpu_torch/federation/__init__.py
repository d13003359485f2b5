"""Fleet federation: membership, router tier, member failover — the
counterpart of `gol_tpu/federation/`, interoperable with it over the wire
(either package's members register with either package's router, and
both place every run on the same member).

`registry` — the router's member registry (heartbeat-stamped census);
`hrw` — rendezvous placement on run_id; `router` — the proxy tier with
HRW CreateRun placement, ListRuns fan-out, a transparent byte relay, a
router-side req_id dedupe window, PinRun, the fleet telemetry queries
and dead-member run adoption through `FleetEngine.adopt_run`; `agent` —
the member-side heartbeat thread (`server.py --federate`).
"""

from gol_tpu_torch.federation.agent import FederationAgent  # noqa: F401
from gol_tpu_torch.federation.hrw import place, rank, score  # noqa: F401
from gol_tpu_torch.federation.registry import (  # noqa: F401
    MemberRegistry,
    dead_after_s,
    heartbeat_interval_s,
)
from gol_tpu_torch.federation.router import FederationRouter  # noqa: F401
