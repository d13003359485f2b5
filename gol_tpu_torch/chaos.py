"""Deterministic wire-level fault injection (the `GOL_CHAOS` contract) —
the counterpart of `gol_tpu/chaos.py` for the hooks that `wire.send_msg`,
`wire.recv_msg` and the client's dial sites call, and of the fleet's
popcount poison (`take_poison`, which the fleet loop reads as its
quarantine witness) and the federation and migration triggers
(`take_kill_member`, `take_migrate_fail`).

Off by default: when `GOL_CHAOS` is unset every hook is one env lookup.
Config is a comma-separated key=value string, e.g.::

    GOL_CHAOS=drop=0.01,delay_ms=5,truncate=0.005,corrupt=0.002,seed=7

Keys (probabilities are per message, drawn from ONE seeded RNG, so a
given seed yields the same fault sequence on every run, in either
package):

- ``drop=p``      close the socket instead of sending/receiving.
- ``truncate=p``  send a partial header, then close (send side only).
- ``corrupt=p``   zero one byte inside the JSON header region so the
                  peer raises WireProtocolError (send side only).
- ``delay=p`` / ``delay_ms=N``
                  sleep N ms before the operation. ``delay_ms`` alone
                  implies ``delay=0.01``.
- ``stall=p`` / ``stall_ms=N``
                  long sleep (default 1000 ms) — outlasts typical
                  client read timeouts.
- ``refuse=p``    dial-time refusal: the client-side connect raises
                  ConnectionRefusedError before the socket connects.
- ``kill_member=<addr|idx>[@s|@migrating]``
                  arm the federation process-kill hook:
                  `take_kill_member(addr, idx, elapsed_s)` fires exactly
                  once per process when the harness polling it reports
                  elapsed seconds >= s (omitted s draws a seeded time in
                  [0.5, 1.5) s) for the member whose address or index
                  matches. ``@migrating`` defers the trigger until the
                  harness reports a Rescale in flight on that member
                  (`migrating=True`), killing the coordinator mid-cutover.
                  Chaos decides WHICH member and WHEN; the harness that
                  owns the subprocess delivers the SIGKILL.
- ``migrate_fail=<phase>``
                  arm the migration-phase fault: `take_migrate_fail(p)`
                  fires exactly once per process when the Rescale
                  coordinator enters the named phase (quiesce /
                  checkpoint / transfer / resume / redirect), forcing
                  that phase to fail so the rollback path runs.
- ``seed=N``      RNG seed (default 0).
- ``poison=<run_id>[@<turn>]``
                  arm the fleet poison hook: `take_poison(run_id, turn)`
                  fires exactly once per process when the named run
                  reaches the given turn, letting the fleet loop
                  fabricate an implausible popcount (a real one can
                  never exceed the slot's bits, so the quarantine
                  detector needs a deliberate trigger to be testable).

Every injection is metered as ``gol_chaos_injected_total{kind}``.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Optional

from gol_tpu_torch.obs import catalog as obs

ENV = "GOL_CHAOS"

_INJECTED = {k: obs.CHAOS_INJECTED.labels(kind=k) for k in obs.CHAOS_KINDS}


def _parse(spec: str) -> dict:
    """key=value pairs as numbers; keys this module does not know, and
    values that are not numbers, are skipped."""
    cfg: dict = {}
    for part in spec.split(","):
        key, sep, val = part.partition("=")
        if not sep:
            continue
        if key.strip() in ("poison", "kill_member", "migrate_fail"):
            cfg[key.strip()] = val.strip()
            continue
        try:
            cfg[key.strip()] = (int(val) if key.strip() == "seed"
                                else float(val))
        except ValueError:
            pass
    return cfg


class ChaosInjector:
    """One seeded fault plan, shared by every connection in the process."""

    def __init__(self, spec: str):
        self.spec = spec
        cfg = _parse(spec)
        self.drop = float(cfg.get("drop", 0.0))
        self.truncate = float(cfg.get("truncate", 0.0))
        self.corrupt = float(cfg.get("corrupt", 0.0))
        self.delay_ms = float(cfg.get("delay_ms", 0.0))
        self.delay = float(cfg.get("delay",
                                   0.01 if self.delay_ms > 0 else 0.0))
        self.stall = float(cfg.get("stall", 0.0))
        self.stall_ms = float(cfg.get("stall_ms", 1000.0))
        self.refuse = float(cfg.get("refuse", 0.0))
        self._rng = random.Random(int(cfg.get("seed", 0)))
        self._lock = threading.Lock()
        # kill_member=<addr|idx>[@s|@migrating]: one-shot member kill.
        self._kill_target: Optional[str] = None
        self._kill_at_s = 0.0
        self._kill_fired = False
        self._kill_on_migrating = False
        km = cfg.get("kill_member")
        if km:
            target, _, at = km.partition("@")
            self._kill_target = target.strip()
            if at == "migrating":
                # Fire while a Rescale cutover is in flight, whenever
                # that happens: the harness reports the condition.
                self._kill_on_migrating = True
            elif at:
                try:
                    self._kill_at_s = float(at)
                except ValueError:
                    self._kill_at_s = 0.0
            else:
                # Seeded default: same spec, same kill time, every run.
                self._kill_at_s = 0.5 + self._rng.random()
        # migrate_fail=<phase>: one-shot forced Rescale phase failure.
        self._migrate_phase: Optional[str] = cfg.get("migrate_fail") or None
        self._migrate_fired = False
        # poison=<run_id>[@<turn>]: one-shot fleet popcount poison.
        self._poison_run: Optional[str] = None
        self._poison_turn = 0
        self._poison_fired = False
        poison = cfg.get("poison")
        if poison:
            rid, _, turn = poison.partition("@")
            self._poison_run = rid
            try:
                self._poison_turn = int(turn) if turn else 0
            except ValueError:
                self._poison_turn = 0

    def _plan(self, kinds) -> Optional[str]:
        """One uniform draw walked over the cumulative per-kind
        probabilities; None means the message passes clean."""
        with self._lock:
            r = self._rng.random()
        acc = 0.0
        for kind, p in kinds:
            acc += p
            if r < acc:
                return kind
        return None

    def on_send(self, sock, head: bytes) -> bytes:
        """Called by wire.send_msg with the framed header bytes (4-byte
        length prefix + JSON). Returns the (possibly corrupted) header,
        sleeps, or closes the socket and raises ConnectionError."""
        kind = self._plan((("drop", self.drop),
                           ("truncate", self.truncate),
                           ("corrupt", self.corrupt),
                           ("delay", self.delay),
                           ("stall", self.stall)))
        if kind is None:
            return head
        _INJECTED[kind].inc()
        if kind == "drop":
            _close_quiet(sock)
            raise ConnectionError("chaos: dropped send")
        if kind == "truncate":
            # Partial header, then hard close: the peer sees a
            # mid-message EOF, the sender a ConnectionError.
            try:
                sock.sendall(head[:max(1, len(head) // 2)])
            except OSError:
                pass
            _close_quiet(sock)
            raise ConnectionError("chaos: truncated send")
        if kind == "corrupt":
            # Zero one byte inside the JSON region (never the length
            # prefix): guaranteed-invalid JSON for the peer.
            buf = bytearray(head)
            with self._lock:
                i = self._rng.randrange(4, len(buf)) if len(buf) > 4 else 0
            if i >= 4:
                buf[i] = 0x00
            return bytes(buf)
        time.sleep((self.stall_ms if kind == "stall" else self.delay_ms)
                   / 1000.0)
        return head

    def on_recv(self, sock) -> None:
        """Called at the top of wire.recv_msg. Truncate/corrupt are
        send-shaped faults; the recv side draws only drop/delay/stall."""
        kind = self._plan((("drop", self.drop),
                           ("delay", self.delay),
                           ("stall", self.stall)))
        if kind is None:
            return
        _INJECTED[kind].inc()
        if kind == "drop":
            _close_quiet(sock)
            raise ConnectionError("chaos: dropped recv")
        time.sleep((self.stall_ms if kind == "stall" else self.delay_ms)
                   / 1000.0)

    def on_dial(self, addr) -> None:
        """Called by client dial sites before connect(). The refuse draw
        happens only when armed, so specs without `refuse` keep their
        fault sequences."""
        if self.refuse <= 0.0:
            return
        with self._lock:
            r = self._rng.random()
        if r < self.refuse:
            _INJECTED["refuse"].inc()
            raise ConnectionRefusedError(f"chaos: refused dial to {addr}")

    def take_kill_member(self, addr: str, idx: int, elapsed_s: float,
                         migrating: bool = False) -> bool:
        """True exactly once, when the armed member (by address or index)
        is polled at or after the armed elapsed time, or, for an
        `@migrating` spec, while the harness reports a migration in
        flight on it."""
        if self._kill_target is None or self._kill_fired:
            return False
        if self._kill_on_migrating:
            if not migrating:
                return False
        elif elapsed_s < self._kill_at_s:
            return False
        if self._kill_target not in (addr, str(idx)):
            return False
        with self._lock:
            if self._kill_fired:
                return False
            self._kill_fired = True
        _INJECTED["kill_member"].inc()
        return True

    def take_migrate_fail(self, phase: str) -> bool:
        """True exactly once, when the Rescale coordinator enters the
        armed phase name."""
        if self._migrate_phase is None or self._migrate_fired:
            return False
        if phase != self._migrate_phase:
            return False
        with self._lock:
            if self._migrate_fired:
                return False
            self._migrate_fired = True
        _INJECTED["migrate_fail"].inc()
        return True

    def take_poison(self, run_id: str, turn: int) -> bool:
        """True exactly once, when the armed run reaches the armed turn."""
        if self._poison_run is None or self._poison_fired:
            return False
        if run_id != self._poison_run or turn < self._poison_turn:
            return False
        with self._lock:
            if self._poison_fired:
                return False
            self._poison_fired = True
        return True


def _close_quiet(sock) -> None:
    try:
        sock.close()
    except OSError:
        pass


_BUILD_LOCK = threading.Lock()
_STATE: Optional[ChaosInjector] = None


def injector() -> Optional[ChaosInjector]:
    """The process-wide injector for the current GOL_CHAOS value, or None
    when chaos is off. Rebuilt, with a fresh RNG and poison state,
    whenever the env value changes."""
    raw = os.environ.get(ENV, "")
    if not raw:
        return None
    global _STATE
    st = _STATE
    if st is not None and st.spec == raw:
        return st
    with _BUILD_LOCK:
        st = _STATE
        if st is None or st.spec != raw:
            _STATE = st = ChaosInjector(raw)
    return st


# -- the hook surface (single call, no-op when chaos is off) ----------

def send_hook(sock, head: bytes) -> bytes:
    inj = injector()
    return head if inj is None else inj.on_send(sock, head)


def recv_hook(sock) -> None:
    inj = injector()
    if inj is not None:
        inj.on_recv(sock)


def take_poison(run_id: str, turn: int) -> bool:
    inj = injector()
    return False if inj is None else inj.take_poison(run_id, turn)


def dial_hook(addr) -> None:
    inj = injector()
    if inj is not None:
        inj.on_dial(addr)


def take_kill_member(addr: str, idx: int, elapsed_s: float,
                     migrating: bool = False) -> bool:
    inj = injector()
    if inj is None:
        return False
    return inj.take_kill_member(addr, idx, elapsed_s, migrating=migrating)


def take_migrate_fail(phase: str) -> bool:
    inj = injector()
    return False if inj is None else inj.take_migrate_fail(phase)
