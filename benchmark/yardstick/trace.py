"""The traced run: `torch.profiler` around the measured window, the
harness's own spans, and the reading of the Chrome trace it exports.

Spans are `record_function` ranges on the harness's thread, so they sit
on the trace's clock beside the device's operations. Without a trace
they cost nothing.
"""

from __future__ import annotations

import contextlib
import json
import os

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
SPAN_PREFIX = "bench."


class Tracer:
    """Opens spans; with `enabled`, runs the profiler between `start`
    and `stop` and exports its trace to `path`."""

    def __init__(self, enabled: bool, path: str, cuda: bool) -> None:
        self.enabled = enabled
        self.path = path
        self.cuda = cuda
        self._prof = None
        self._open: dict = {}

    def start(self) -> None:
        if not self.enabled:
            return
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()

    def stop(self) -> None:
        if self._prof is None:
            return
        for name in list(self._open):
            self.end(name)
        self._prof.__exit__(None, None, None)
        self._prof.export_chrome_trace(self.path)
        self._prof = None

    @property
    def exported(self) -> bool:
        return self.enabled and os.path.exists(self.path)

    def begin(self, name: str) -> None:
        """Open the span `name` (one open span of a name at a time)."""
        if self._prof is None:
            return
        import torch

        rf = torch.profiler.record_function(SPAN_PREFIX + name)
        rf.__enter__()
        self._open[name] = rf

    def end(self, name: str) -> None:
        rf = self._open.pop(name, None)
        if rf is not None:
            rf.__exit__(None, None, None)

    @contextlib.contextmanager
    def span(self, name: str):
        self.begin(name)
        try:
            yield
        finally:
            self.end(name)


class Trace:
    """The exported trace, in seconds on the trace's clock: `device`
    (start, end, name) of every kernel, copy and fill, `kernels` of the
    kernels alone; `host` (start, end, name) of every host-side event;
    `calls` the (start, end, thread) of each CUDA runtime or driver call
    by name; `spans` the harness's spans by name."""

    def __init__(self, path: str) -> None:
        with open(path) as f:
            doc = json.load(f)
        events = doc["traceEvents"] if isinstance(doc, dict) else doc
        self.device, self.host, self.spans = [], [], {}
        self.kernels, self.calls = [], {}
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat", "")
            s = float(e["ts"]) * 1e-6
            iv = (s, s + float(e["dur"]) * 1e-6, e.get("name", ""))
            if cat in DEVICE_CATS:
                self.device.append(iv)
                if cat == "kernel":
                    self.kernels.append(iv)
            elif cat in HOST_CATS:
                self.host.append(iv)
                if cat in ("cuda_runtime", "cuda_driver"):
                    self.calls.setdefault(iv[2], []).append(
                        (iv[0], iv[1], e.get("tid")))
                if cat == "user_annotation" and iv[2].startswith(SPAN_PREFIX):
                    self.spans.setdefault(iv[2][len(SPAN_PREFIX):],
                                          []).append(iv[:2])
        for v in self.spans.values():
            v.sort()
        for v in self.calls.values():
            v.sort(key=lambda c: c[:2])

    def window(self, name: str) -> tuple:
        """(start, end) of the one span `name`."""
        (w,) = self.spans[name]
        return w

    def device_in(self, lo: float, hi: float) -> list:
        """Device operations that overlap [lo, hi], clipped to it."""
        return [(max(s, lo), min(e, hi), n) for s, e, n in self.device
                if e > lo and s < hi]

    def host_at(self, t: float):
        """Name of the innermost host event open at time t, the window's
        own span left out, or None."""
        best = None
        for s, e, n in self.host:
            if n == SPAN_PREFIX + "window":
                continue
            if s <= t < e and (best is None or e - s < best[1] - best[0]):
                best = (s, e, n)
        return None if best is None else best[2]
