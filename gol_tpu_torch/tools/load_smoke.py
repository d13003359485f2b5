"""load-smoke: a small concurrent load generator for a fleet server.

    python -m gol_tpu_torch.tools.load_smoke [--address HOST:PORT]
        [--clients N] [--cycles M] [--board S] [--timeout SECONDS]
        [--viewers N] [--view-cells C] [--hold SECONDS] [--device DEV]

Drives N client threads against a live wire server, each looping the
serving cycle CreateRun -> AttachRun -> GetView -> CFput (pause) ->
DestroyRun and recording the client-observed wall latency of every call,
per method (time.monotonic around each round trip: connect + request +
server queue wait + handler + reply).

`--viewers N` first parks N mostly-idle Subscribe spectators of one
watched run in a `ViewerPool`, which drains (and discards, without
decoding) the pushed epoch-stream bytes on one selectors thread, so the
cycle latencies are measured with the broadcast tier live.

With `--address` it drives any reachable server over the wire protocol,
the JAX package's included. Without it, it starts the port's own
`FleetEngine` (one 64² bucket, two-turn quanta, 8 slots) and
`EngineServer` on `--device` (default CUDA; `cpu` runs without a card)
on an ephemeral loopback port.

Stdout carries one JSON summary line (`address`, `wall_s`, `clients`,
`cycles`, `methods`, `errors`, and `viewers` with `--viewers`), then
the `load-smoke:` verdict lines (failures go to stderr). Exit 0 when
every cycle completed and every viewer stayed alive and received bytes,
1 otherwise. The arguments, the summary's keys, the `load-smoke:` lines
and the exit codes are those of the JAX package's `tools/load_smoke.py`;
`CYCLE_METHODS`, `run_load`, `ViewerPool`, `open_viewers` and
`summarize` are its importable API. The server-side split of the same
window (handler and accept-queue wait per method) is the caller's to
read: `obs.slo.reset()` before the load, `obs.slo.rpc_snapshot()` after
it, in the server's process.
"""

from __future__ import annotations

import argparse
import json
import selectors
import socket
import sys
import threading
import time
from typing import Dict, List, Optional

from gol_tpu_torch.client import RemoteEngine
from gol_tpu_torch.engine import FLAG_PAUSE
from gol_tpu_torch.obs import slo

# The cycle's methods, in call order (also the report ordering).
CYCLE_METHODS = ("CreateRun", "AttachRun", "GetView", "CFput",
                 "DestroyRun")


def _worker(address: str, worker_id: int, cycles: int, board: int,
            view_cells: int, timeout: float,
            samples: Dict[str, List[float]], errors: List[str],
            lock: threading.Lock) -> None:
    eng = RemoteEngine(address, timeout=timeout)
    local: Dict[str, List[float]] = {m: [] for m in CYCLE_METHODS}
    for cycle in range(cycles):
        try:
            t0 = time.monotonic()
            rec = eng.create_run(board, board)
            local["CreateRun"].append(time.monotonic() - t0)
            rid = rec["run_id"]

            t0 = time.monotonic()
            bound = eng.attach_run(rid)
            local["AttachRun"].append(time.monotonic() - t0)

            t0 = time.monotonic()
            bound.get_view(view_cells)
            local["GetView"].append(time.monotonic() - t0)

            t0 = time.monotonic()
            bound.cf_put(FLAG_PAUSE)
            local["CFput"].append(time.monotonic() - t0)

            t0 = time.monotonic()
            eng.destroy_run(rid)
            local["DestroyRun"].append(time.monotonic() - t0)
        except Exception as e:  # noqa: BLE001 — report, don't crash
            with lock:
                errors.append(
                    f"worker {worker_id} cycle {cycle}: "
                    f"{type(e).__name__}: {e}")
            return
    with lock:
        for m, vals in local.items():
            samples.setdefault(m, []).extend(vals)


def run_load(address: str, *, clients: int = 4, cycles: int = 8,
             board: int = 64, view_cells: int = 4096,
             timeout: float = 30.0) -> dict:
    """Drive `clients` concurrent cycle loops against `address`.

    Returns {"samples": {method: [seconds, ...]}, "errors": [...],
    "clients": N, "cycles": M, "wall_s": total}. A worker stops its
    remaining cycles on the first error (recorded in "errors"), so a
    clean run has exactly clients*cycles samples per method.
    """
    samples: Dict[str, List[float]] = {}
    errors: List[str] = []
    lock = threading.Lock()
    threads = [
        threading.Thread(
            target=_worker,
            args=(address, i, cycles, board, view_cells, timeout,
                  samples, errors, lock),
            name=f"gol-load-{i}", daemon=True)
        for i in range(clients)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout * cycles * len(CYCLE_METHODS))
    return {"samples": samples, "errors": errors, "clients": clients,
            "cycles": cycles, "wall_s": round(time.monotonic() - t0, 3)}


class ViewerPool:
    """N parked Subscribe spectators on one selectors thread.

    Each added `ViewSubscription`'s socket is drained byte-wise (recv and
    discard, no decode), so the subscribers look idle to the server: the
    gateway keeps pushing, the kernel buffers never fill, and the client
    process spends almost no CPU a viewer. Byte and EOF counts are the
    only accounting."""

    def __init__(self) -> None:
        self._sel = selectors.DefaultSelector()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, None)
        self._lock = threading.Lock()
        self._pending: List = []
        self._subs: Dict[int, object] = {}
        self.bytes_received = 0
        self.closed_count = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="gol-viewer-pool", daemon=True)
        self._thread.start()

    def add(self, sub) -> None:
        """Park one ViewSubscription (ownership transfers here)."""
        with self._lock:
            self._pending.append(sub)
        self._poke()

    def alive(self) -> int:
        with self._lock:
            return len(self._subs) + len(self._pending)

    def stats(self) -> dict:
        with self._lock:
            return {"alive": len(self._subs) + len(self._pending),
                    "closed": self.closed_count,
                    "bytes": self.bytes_received}

    def close(self) -> None:
        self._stop.set()
        self._poke()
        self._thread.join(timeout=5.0)

    def _poke(self) -> None:
        try:
            self._wake_w.send(b"\x01")
        except OSError:
            pass

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                events = self._sel.select(timeout=0.5)
            except OSError:
                break
            for key, _ in events:
                if key.data is None:
                    try:
                        while self._wake_r.recv(4096):
                            pass
                    except OSError:
                        pass
                    continue
                self._drain(key.data)
            with self._lock:
                pending, self._pending = self._pending, []
            for sub in pending:
                try:
                    sub._sock.setblocking(False)
                    self._sel.register(
                        sub._sock, selectors.EVENT_READ, sub)
                except (OSError, ValueError):
                    self._dead(sub, registered=False)
                    continue
                with self._lock:
                    self._subs[sub._sock.fileno()] = sub
        # Teardown: hang every spectator up.
        for sub in list(self._subs.values()):
            self._dead(sub)
        with self._lock:
            for sub in self._pending:
                sub.close()
            self._pending = []
        for s in (self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass
        try:
            self._sel.close()
        except OSError:
            pass

    def _drain(self, sub) -> None:
        try:
            while True:
                data = sub._sock.recv(1 << 16)
                if not data:
                    self._dead(sub)
                    return
                with self._lock:
                    self.bytes_received += len(data)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._dead(sub)

    def _dead(self, sub, registered: bool = True) -> None:
        if registered:
            try:
                self._sel.unregister(sub._sock)
            except (KeyError, ValueError, OSError):
                pass
        with self._lock:
            self._subs.pop(sub._sock.fileno(), None)
            self.closed_count += 1
        sub.close()


def open_viewers(address: str, *, viewers: int, run_id: Optional[str],
                 view_cells: int = 4096, timeout: float = 30.0,
                 threads: int = 8):
    """Open `viewers` Subscribe upgrades bound to `run_id` and park
    them in a ViewerPool. Returns (pool, errors) — errors is the list
    of subscribe failures (each opener thread stops at its first)."""
    pool = ViewerPool()
    errors: List[str] = []
    lock = threading.Lock()
    counter = [0]

    def opener() -> None:
        eng = RemoteEngine(address, timeout=timeout, run_id=run_id)
        while True:
            with lock:
                if counter[0] >= viewers or errors:
                    return
                counter[0] += 1
            try:
                pool.add(eng.subscribe(view_cells, timeout=timeout))
            except Exception as e:  # noqa: BLE001 — report, don't crash
                with lock:
                    errors.append(f"subscribe: {type(e).__name__}: {e}")
                return

    workers = [threading.Thread(target=opener, daemon=True,
                                name=f"gol-viewer-open-{i}")
               for i in range(max(1, min(threads, viewers)))]
    for t in workers:
        t.start()
    for t in workers:
        t.join(timeout=timeout * 4)
    return pool, errors


def summarize(samples: Dict[str, List[float]]) -> Dict[str, dict]:
    """{method: {count, p50_ms, p99_ms, max_ms}} via exact percentiles
    (small populations: no need for the streaming estimator)."""
    out: Dict[str, dict] = {}
    for method in CYCLE_METHODS:
        vals = samples.get(method) or []
        if not vals:
            continue
        p50, p99 = slo.exact_percentiles(vals, (0.50, 0.99))
        out[method] = {"count": len(vals),
                       "p50_ms": round(p50 * 1e3, 3),
                       "p99_ms": round(p99 * 1e3, 3),
                       "max_ms": round(max(vals) * 1e3, 3)}
    return out


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        description="concurrent create/attach/view/flag/destroy load "
                    "against a fleet server")
    ap.add_argument("--address", default="",
                    help="host:port of a running server (default: "
                         "start a private in-process fleet server)")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--cycles", type=int, default=8,
                    help="cycles per client (default 8)")
    ap.add_argument("--board", type=int, default=64,
                    help="square board side per run (default 64)")
    ap.add_argument("--timeout", type=float, default=30.0)
    ap.add_argument("--viewers", type=int, default=0,
                    help="also park N mostly-idle broadcast subscribers "
                         "on one watched run for --hold seconds "
                         "(default 0 = none)")
    ap.add_argument("--view-cells", type=int, default=4096,
                    help="max_cells of the viewers' subscribed view")
    ap.add_argument("--hold", type=float, default=2.0,
                    help="seconds to hold the viewer population open")
    ap.add_argument("--device", default="cuda",
                    help="device of the private fleet server when no "
                         "--address is given (default cuda)")
    args = ap.parse_args(argv)

    server = engine = None
    address = args.address
    if not address:
        from gol_tpu_torch.fleet.engine import FleetEngine
        from gol_tpu_torch.server import EngineServer

        engine = FleetEngine(bucket_sizes=(64,), chunk_turns=2,
                             slot_base=8, device=args.device)
        server = EngineServer(port=0, host="127.0.0.1", engine=engine)
        server.start_background()
        address = f"127.0.0.1:{server.port}"
    pool = None
    ctl = watched = None
    viewer_errors: List[str] = []
    viewer_stats: Optional[dict] = None
    try:
        if args.viewers > 0:
            # Park the spectators on one watched run BEFORE the cycle
            # load starts, so the control-plane latencies below are
            # measured with the broadcast tier live.
            ctl = RemoteEngine(address, timeout=args.timeout)
            watched = ctl.create_run(args.board, args.board)["run_id"]
            pool, viewer_errors = open_viewers(
                address, viewers=args.viewers, run_id=watched,
                view_cells=args.view_cells, timeout=args.timeout)
        result = run_load(address, clients=args.clients,
                          cycles=args.cycles, board=args.board,
                          timeout=args.timeout)
        if pool is not None and not viewer_errors:
            time.sleep(max(0.0, args.hold))
            viewer_stats = pool.stats()
    finally:
        if pool is not None:
            pool.close()
        if ctl is not None and watched is not None:
            try:
                ctl.destroy_run(watched)
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        if engine is not None:
            engine.kill_prog()
        if server is not None:
            server.shutdown()
    table = summarize(result["samples"])
    summary = {"address": address, "wall_s": result["wall_s"],
               "clients": result["clients"],
               "cycles": result["cycles"], "methods": table,
               "errors": result["errors"]}
    if args.viewers > 0:
        summary["viewers"] = {"requested": args.viewers,
                              "hold_s": args.hold,
                              "stats": viewer_stats,
                              "errors": viewer_errors}
    print(json.dumps(summary, sort_keys=True))
    if result["errors"]:
        for e in result["errors"]:
            print(f"load-smoke: FAIL: {e}", file=sys.stderr)
        return 1
    missing = [m for m in CYCLE_METHODS if m not in table]
    if missing:
        print(f"load-smoke: FAIL: no samples for {missing}",
              file=sys.stderr)
        return 1
    if args.viewers > 0:
        for e in viewer_errors:
            print(f"load-smoke: FAIL: viewer: {e}", file=sys.stderr)
        if viewer_errors:
            return 1
        assert viewer_stats is not None
        if viewer_stats["closed"] or \
                viewer_stats["alive"] != args.viewers:
            print(f"load-smoke: FAIL: viewers dropped: {viewer_stats}",
                  file=sys.stderr)
            return 1
        if viewer_stats["bytes"] <= 0:
            print("load-smoke: FAIL: viewers received zero pushed "
                  "bytes", file=sys.stderr)
            return 1
        print(f"load-smoke: viewers OK — {args.viewers} subscriber(s) "
              f"held {args.hold}s, {viewer_stats['bytes']} pushed "
              "bytes drained")
    print(f"load-smoke: OK — {args.clients} client(s) x "
          f"{args.cycles} cycle(s) in {result['wall_s']}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
