"""Continuous-batching scheduler: FCFS admission + one batched engine step
per tick (ported from `repro.serve.scheduler`, whole-prompt admission).

Each tick admits at most one request (each admission is a blocking B=1
prefill), then runs the batched decode step. Per-request latency and
throughput accounting is built in.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Iterable

import torch

from .engine import Engine, Request

#: engine counters ServeStats mirrors; run_to_completion snapshots them so a
#: scheduler reused across runs reports per-run deltas, not lifetime totals
_ENGINE_COUNTERS = ("prefill_tokens", "prefill_pad_tokens", "decode_tokens", "decode_steps")


@dataclasses.dataclass
class ServeStats:
    wall_s: float = 0.0
    prefill_tokens: int = 0         # real prompt tokens (padding excluded)
    prefill_pad_tokens: int = 0     # bucket padding, reported separately
    decode_tokens: int = 0
    decode_steps: int = 0           # batched decode step invocations
    completed: int = 0
    rejected: int = 0               # failed admission (Request.error set)
    ttft_s: list = dataclasses.field(default_factory=list)

    @property
    def total_tokens(self) -> int:
        return self.prefill_tokens + self.decode_tokens

    @property
    def throughput_tok_s(self) -> float:
        return self.total_tokens / self.wall_s if self.wall_s else 0.0

    @property
    def decode_tok_s(self) -> float:
        return self.decode_tokens / self.wall_s if self.wall_s else 0.0

    @property
    def prefill_tok_s(self) -> float:
        return self.prefill_tokens / self.wall_s if self.wall_s else 0.0


class ContinuousBatchingScheduler:
    def __init__(self, engine: Engine):
        self.engine = engine
        self.queue: deque[Request] = deque()
        self.completed: list[Request] = []  # finished requests, in finish order
        self.rejected: list[Request] = []   # failed admission (req.error set)
        self._reported = {k: getattr(engine, k) for k in _ENGINE_COUNTERS}
        self._reported_done = 0
        self._reported_rejected = 0
        self._reported_ttft = 0

    def submit(self, reqs: Iterable[Request]):
        for r in reqs:
            r.t_submit = time.perf_counter()
            self.queue.append(r)

    def tick(self):
        """One scheduler iteration: at most one admission, then one batched
        decode step. A request that can never fit is rejected in place
        (`error` set, see `self.rejected`) and the next queued request is
        tried in the same tick."""
        while self.queue:
            head = self.queue[0]
            try:
                if not self.engine.add(head):
                    break              # no free slot — head stays queued
                self.queue.popleft()
                if head.done:          # satisfied by prefill alone
                    self.completed.append(head)
                break                  # one blocking admission per tick
            except ValueError as e:
                head.error = str(e)
                self.rejected.append(head)
                self.queue.popleft()
        before = list(self.engine.slot_req.values())
        if self.engine.has_work:
            self.engine.step()
        for r in before:
            if r.done:
                self.completed.append(r)

    def run_to_completion(self, max_ticks: int = 100_000) -> ServeStats:
        """Drain the queue (<= max_ticks); → ServeStats for this run (deltas
        against what earlier calls already reported)."""
        t0 = time.perf_counter()
        base = {k: min(self._reported[k], getattr(self.engine, k)) for k in _ENGINE_COUNTERS}
        ticks = 0
        while (self.queue or self.engine.has_work) and ticks < max_ticks:
            self.tick()
            ticks += 1
        if self.engine.device.type == "cuda":
            torch.cuda.synchronize(self.engine.device)
        wall = time.perf_counter() - t0
        all_reqs: list[Request] = (
            self.completed + list(self.engine.slot_req.values()) + list(self.queue)
        )
        self._reported = {k: getattr(self.engine, k) for k in _ENGINE_COUNTERS}
        done = sum(r.done for r in all_reqs)
        ttft_events = sorted(
            (r.t_first_token, r.t_first_token - r.t_submit)
            for r in all_reqs if r.t_first_token
        )
        stats = ServeStats(
            wall_s=wall,
            completed=done - self._reported_done,
            rejected=len(self.rejected) - self._reported_rejected,
            ttft_s=[d for _, d in ttft_events[self._reported_ttft:]],
            **{k: self._reported[k] - base[k] for k in _ENGINE_COUNTERS},
        )
        self._reported_done = done
        self._reported_rejected = len(self.rejected)
        self._reported_ttft = len(ttft_events)
        return stats
