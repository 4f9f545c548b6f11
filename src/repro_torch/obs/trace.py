"""Ring-buffered span tracer emitting Chrome/Perfetto ``trace_event`` JSON
(ported from `repro.obs.trace`).

Spans wrap the serving stack's host-side control flow — scheduler tick →
chunk step / decode step / verify → mpGeMM dispatch — with free-form ``args``
(the mpGeMM spans carry (M, N, K, impl, fusion, tile), so a slow tick is
attributable to the kernel shapes and launch plans it ran). Events land in a
bounded deque (oldest dropped, drop count kept), so an always-on tracer in a
long serve can never grow without bound.

Timestamps come from ``time.perf_counter()`` rebased to the tracer's start,
in microseconds (the trace_event unit). Output is the JSON *object* format
(``{"traceEvents": [...]}``) which both ``chrome://tracing`` and
https://ui.perfetto.dev load directly.

How the port's spans relate to the JAX package's: every mpGeMM call made
on the host records its own span (one per BitLinear per eager forward).
On the card the engine's per-tick steps are captured once per shape as
CUDA graphs (`serve.graphs`), so their spans fire at capture and not at
replay, as JAX's jitted steps record one per compiled shape at trace time;
admission and every eager run record one per call. A span's duration is
the host's cost of issuing the call: CUDA launches are asynchronous, so it
is not the kernel's device time. The step spans carry the wall time of
every step, which ends in a host sync: they are the per-tick record.
"""
from __future__ import annotations

import json
import time
from collections import deque


class _Span:
    """Mutable in-flight span; ``args`` may be extended before exit."""

    __slots__ = ("tracer", "name", "args", "t0")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self.tracer = tracer
        self.name = name
        self.args = args
        self.t0 = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.tracer.complete(self.name, self.t0, args=self.args)
        return False


class _NullSpan:
    """Shared no-op span: zero allocation on the disabled path. Its ``args``
    is a throwaway dict so `sp.args[...] = v` stays legal (and discarded)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @property
    def args(self) -> dict:
        return {}


_NULL_SPAN = _NullSpan()


class Tracer:
    def __init__(self, capacity: int = 65536, enabled: bool = True,
                 pid: int = 0, tid: int = 0):
        self.enabled = enabled
        self.capacity = capacity
        self.pid = pid
        self.tid = tid
        self.events: deque[dict] = deque(maxlen=capacity)
        self.emitted = 0            # lifetime count (dropped = emitted - len)
        self._t0 = time.perf_counter()

    # -- recording -------------------------------------------------------
    def _ts(self, t: float) -> float:
        return (t - self._t0) * 1e6

    def span(self, name: str, **args):
        """Context manager recording a complete ('X') event on exit."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, args)

    def complete(self, name: str, t0: float, t1: float | None = None,
                 args: dict | None = None) -> None:
        """Record a complete event for work measured externally
        ([t0, t1 or now] in perf_counter seconds)."""
        if not self.enabled:
            return
        t1 = time.perf_counter() if t1 is None else t1
        self.emitted += 1
        self.events.append({
            "name": name, "ph": "X", "pid": self.pid, "tid": self.tid,
            "ts": self._ts(t0), "dur": max((t1 - t0) * 1e6, 0.0),
            "args": dict(args or {}),
        })

    def instant(self, name: str, **args) -> None:
        if not self.enabled:
            return
        self.emitted += 1
        self.events.append({
            "name": name, "ph": "i", "s": "t", "pid": self.pid,
            "tid": self.tid, "ts": self._ts(time.perf_counter()),
            "args": args,
        })

    @property
    def dropped(self) -> int:
        return self.emitted - len(self.events)

    # -- export ----------------------------------------------------------
    def to_json(self) -> dict:
        return {
            "traceEvents": list(self.events),
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped},
        }

    def write(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)
        return path
