"""Continuous-batching scheduler: FCFS admission + one batched engine step
per tick (ported from `repro.serve.scheduler`).

Whole-prompt engines admit at most one request per tick (each admission is
a blocking B=1 prefill) before the batched step. Chunked engines admit every
queued request that gets a slot (admission only claims it) and the engine's
token budget paces the chunks; TTFT is then taken when a request's last
chunk lands. Ticks with nothing prefilling or decoding skip the step.
Per-request latency and throughput accounting is built in.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Iterable

import torch

from .engine import (
    Engine,
    Request,
    spec_acceptance_rate,
    spec_mean_k,
    spec_nodes_per_step,
    spec_skip_rate,
    spec_tokens_per_step,
)

#: engine counters ServeStats mirrors; run_to_completion snapshots them so a
#: scheduler reused across runs reports per-run deltas, not lifetime totals
_ENGINE_COUNTERS = (
    "prefill_tokens", "prefill_pad_tokens", "decode_tokens", "decode_steps",
    "chunk_steps", "spec_steps", "spec_slot_steps", "spec_skipped_steps",
    "drafted_tokens", "accepted_tokens", "verified_nodes",
)


@dataclasses.dataclass
class ServeStats:
    wall_s: float = 0.0
    prefill_tokens: int = 0         # real prompt tokens (padding excluded)
    prefill_pad_tokens: int = 0     # bucket/chunk padding, reported separately
    decode_tokens: int = 0
    decode_steps: int = 0           # batched decode/verify step invocations
    chunk_steps: int = 0            # batched mixed chunk-step invocations
    completed: int = 0
    rejected: int = 0               # failed admission (Request.error set)
    ttft_s: list = dataclasses.field(default_factory=list)
    # speculative decoding (zero when the engine runs without spec=)
    spec_steps: int = 0             # batched verify steps
    spec_slot_steps: int = 0        # per-slot verify steps (Σ active slots)
    spec_skipped_steps: int = 0     # slot steps that skipped drafting (k_eff=0)
    drafted_tokens: int = 0
    accepted_tokens: int = 0
    verified_nodes: int = 0         # candidate tokens verified (Σ per slot)

    @property
    def total_tokens(self) -> int:
        return self.prefill_tokens + self.decode_tokens

    @property
    def acceptance_rate(self) -> float:
        return spec_acceptance_rate(self.accepted_tokens, self.drafted_tokens)

    @property
    def decode_tokens_per_step(self) -> float:
        return spec_tokens_per_step(self.decode_tokens, self.spec_slot_steps)

    @property
    def skip_rate(self) -> float:
        """Fraction of slot verify steps the adaptive policy left undrafted."""
        return spec_skip_rate(self.spec_skipped_steps, self.spec_slot_steps)

    @property
    def mean_draft_k(self) -> float:
        """Mean k_eff over the slot steps that did draft (k when fixed)."""
        return spec_mean_k(self.drafted_tokens, self.spec_slot_steps, self.spec_skipped_steps)

    @property
    def nodes_per_step(self) -> float:
        """Mean candidate tokens per slot verify row (k+1 chain, the tree's
        node count under trees)."""
        return spec_nodes_per_step(self.verified_nodes, self.spec_slot_steps)

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
        """One scheduler iteration: admissions, then one batched engine step.
        Whole-prompt engines admit at most one request (a blocking prefill);
        chunked engines admit every queued request that gets a slot. A
        request that can never fit is rejected in place (`error` set, see
        `self.rejected`) and the next queued request is tried in the same
        tick."""
        multi = bool(self.engine.prefill_chunk)
        while self.queue:
            head = self.queue[0]
            try:
                if not self.engine.add(head):
                    break              # no free slot — head stays queued
                self.queue.popleft()
                if head.done:          # satisfied by prefill alone
                    self.completed.append(head)
                if not multi:
                    break              # one blocking admission per tick
            except ValueError as e:
                head.error = str(e)
                self.rejected.append(head)
                self.queue.popleft()
        before = list(self.engine.slot_req.values()) + list(self.engine.prefilling.values())
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
            self.completed + list(self.engine.slot_req.values())
            + list(self.engine.prefilling.values()) + list(self.queue)
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
