"""Member-side federation agent: register + heartbeat to the router — the
counterpart of `gol_tpu/federation/agent.py`.

A daemon thread each federated fleet server starts (`server.py
--federate ROUTER_ADDR`). Every `GOL_FED_HEARTBEAT` seconds it sends a
`RegisterMember` message over the ordinary wire protocol carrying the
member's advertised address, capacity, device geometry, a strictly
increasing sequence number and, when there is one, a telemetry snapshot
(`obs/export.SnapshotExporter`: the member's families and its queued
audit events, committed once the router acknowledged the beat). The
router's registry is the only party that stamps time.

Failures are soft: a beat that cannot reach the router is logged and
dropped (the NEXT beat is the retry), and the member keeps serving its
runs either way; a snapshot that fails to build never costs the beat.
One request per connection, like every other wire RPC.
"""

from __future__ import annotations

import socket
import threading
from typing import Optional

from gol_tpu_torch import wire
from gol_tpu_torch.federation.registry import heartbeat_interval_s
from gol_tpu_torch.obs.export import SnapshotExporter
from gol_tpu_torch.obs.log import log as obs_log


class FederationAgent:
    """Heartbeat loop from one member to one router."""

    def __init__(self, router_addr: str, address: str,
                 capacity: int = 0, mesh: Optional[dict] = None,
                 timeout: float = 5.0) -> None:
        host, _, port = router_addr.rpartition(":")
        self._router = (host or "127.0.0.1", int(port))
        self.address = address          # advertised; doubles as member_id
        self.capacity = int(capacity)
        self.mesh = mesh
        self._timeout = float(timeout)
        self._seq = 0
        self._exporter = SnapshotExporter()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def beat_once(self) -> Optional[dict]:
        """One RegisterMember round trip; None if the router was
        unreachable (the loop just waits for the next beat)."""
        self._seq += 1
        header = {
            "method": "RegisterMember",
            "member_id": self.address,
            "address": self.address,
            "capacity": self.capacity,
            "seq": self._seq,
        }
        if self.mesh is not None:
            header["mesh"] = self.mesh
        try:
            # Telemetry rides the beat already paid for; a snapshot
            # failure must never cost the heartbeat.
            snap = self._exporter.build()
            if snap is not None:
                header["snap"] = snap
        except Exception as e:  # noqa: BLE001 — beat > snapshot
            obs_log("fed.snapshot_failed", level="warning",
                    member=self.address,
                    error=f"{type(e).__name__}: {e}")
        try:
            with socket.create_connection(
                    self._router, timeout=self._timeout) as sock:
                sock.settimeout(self._timeout)
                wire.enable_nodelay(sock)
                wire.send_msg(sock, header)
                resp, _ = wire.recv_msg(sock)
            try:
                self._exporter.commit(resp)
            except Exception:  # noqa: BLE001
                pass
            return resp
        except (OSError, ConnectionError, wire.WireProtocolError) as e:
            obs_log("fed.heartbeat_failed", level="warning",
                    member=self.address,
                    error=f"{type(e).__name__}: {e}")
            return None

    def _run(self) -> None:
        first = True
        while not self._stop.is_set():
            resp = self.beat_once()
            if first and resp is not None:
                obs_log("fed.registered", member=self.address,
                        live=resp.get("live"))
                first = False
            self._stop.wait(heartbeat_interval_s())

    def start(self) -> "FederationAgent":
        self._thread = threading.Thread(
            target=self._run, name="gol-fed-agent", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
