"""Fault tolerance: preemption guard, straggler monitor, bounded restarts
(a copy of `repro.dist.fault_tolerance`, standard library only)."""
from __future__ import annotations

import dataclasses
import itertools
import signal
import statistics
import time
from typing import Callable, Sequence


class PreemptionGuard:
    """Cooperative preemption flag.

    The trainer polls ``.requested`` each step and checkpoints + exits when
    set. With ``install=True`` the guard hooks SIGTERM/SIGINT (the preemption
    notice on most schedulers); tests set ``.requested`` directly.
    """

    def __init__(self, install: bool = False, signals=(signal.SIGTERM, signal.SIGINT)):
        self.requested = False
        if install:
            for s in signals:
                signal.signal(s, self._handler)

    def _handler(self, signum, frame):  # pragma: no cover - signal path
        self.requested = True


@dataclasses.dataclass
class StragglerEvent:
    step: int
    host: int
    ratio: float  # host step time / median step time


class StragglerMonitor:
    """Flags hosts that run persistently slower than the fleet median.

    A host whose step time exceeds ``threshold × median`` for ``patience``
    consecutive steps raises a :class:`StragglerEvent` (appended to
    ``.events`` and passed to ``on_straggler``). Needs ≥ 2 hosts to compare;
    single-host runs record nothing.
    """

    def __init__(
        self,
        n_hosts: int,
        threshold: float = 2.0,
        patience: int = 2,
        on_straggler: Callable[[StragglerEvent], None] | None = None,
    ):
        self.n_hosts = n_hosts
        self.threshold = threshold
        self.patience = patience
        self.on_straggler = on_straggler
        self.events: list[StragglerEvent] = []
        self._strikes = [0] * n_hosts

    def record(self, step: int, times: Sequence[float]) -> None:
        if self.n_hosts < 2 or len(times) != self.n_hosts:
            return
        med = max(statistics.median(times), 1e-12)
        for host, t in enumerate(times):
            ratio = t / med
            if ratio > self.threshold:
                self._strikes[host] += 1
            else:
                self._strikes[host] = 0
            if self._strikes[host] >= self.patience:
                ev = StragglerEvent(step=step, host=host, ratio=ratio)
                self.events.append(ev)
                if self.on_straggler is not None:
                    self.on_straggler(ev)


def run_with_restarts(
    fn: Callable[[int], None],
    max_restarts: int = 3,
    sleep: Callable[[float], None] = time.sleep,
    retryable: tuple[type[BaseException], ...] = (RuntimeError, OSError),
) -> int:
    """Run ``fn(attempt)`` with bounded restart supervision.

    Retries only *fault-shaped* errors (``retryable``; bugs like ValueError
    propagate immediately) with exponential backoff, giving up by re-raising
    once ``max_restarts`` restarts are exhausted. Returns the attempt index
    that succeeded.
    """
    for attempt in itertools.count():
        try:
            fn(attempt)
            return attempt
        except retryable:
            if attempt >= max_restarts:
                raise
            sleep(min(2.0 ** attempt, 60.0))
    raise AssertionError("unreachable")  # pragma: no cover
