"""repro_torch.obs — serving/kernel observability: metrics registry +
tracer (ported from `repro.obs`; the same metric names, buckets and
exports, so one dashboard or bench reader serves both packages).

The layer is **off by default and free when off**: `Engine(obs=None)` gets
the shared null `Obs` whose every method early-returns (no events, no metric
objects, no allocation on the step path), so the hot loop pays one attribute
check per step and the mpGeMM dispatch one `current()` call. Enabling it
costs host-side bookkeeping only: nothing here touches a tensor, launches
device work or waits for the device.

Wiring (see docs/observability.md for the metric vocabulary):

  * ``Engine(obs=ObsConfig(...))`` — the engine records TTFT/TPOT histograms,
    per-step wall-time histograms and spans, and per-step effective-M samples
    (the parallel-token count the Vec-LUT mpGeMM kernels actually saw — the
    paper's central variable);
  * ``ContinuousBatchingScheduler`` — per-tick spans + queue-depth /
    slot-occupancy / page-pool gauges synced to engine state every tick;
  * ``kernels/ops.ternary_matmul`` and ``ternary_matmul_batched`` — one
    mpGeMM dispatch span per call, annotated with (M, N, K, impl, fusion,
    tile: the launch plan of each packed segment). The port runs eagerly, so
    this is a per-call span where the JAX package's jitted steps record one
    per compiled shape; its duration is the host's cost of issuing the
    launches, not their device time (see `trace`);
  * ``record_kernel_sample`` — per-(shape, impl) timing samples + achieved
    GB/s / GFLOP/s gauges (bytes/FLOPs from roofline.analysis.mpgemm_cost),
    fed by whoever measured the kernel (chip_smoke.py);
  * ``launch.serve --metrics-out/--trace-out/--stats-interval`` — exports and
    registry-backed periodic stats lines.

Kernel-side hooks discover the active instance through ``install()`` /
``current()`` (module global): the kernels cannot take an `obs` parameter
without changing every call signature, and at most one engine per process is
being observed in practice. ``install(None)`` detaches.
"""
from __future__ import annotations

import dataclasses
import time

from repro_torch.roofline.analysis import mpgemm_cost

from .metrics import (
    M_BUCKETS,
    STEP_BUCKETS,
    TPOT_BUCKETS,
    TTFT_BUCKETS,
    MetricsRegistry,
)
from .trace import _NULL_SPAN, Tracer

__all__ = [
    "ObsConfig", "Obs", "NULL_OBS", "install", "current",
    "MetricsRegistry", "Tracer",
]


@dataclasses.dataclass
class ObsConfig:
    """Observability knobs. `enabled=False` yields the shared null instance
    (identical to passing no config at all)."""
    enabled: bool = True
    trace: bool = True                  # record trace_event spans
    trace_capacity: int = 65536         # ring size; oldest events dropped
    series_capacity: int = 4096         # per-tick sample ring size
    metrics_out: str | None = None      # finalize(): JSON metrics dump path
    trace_out: str | None = None        # finalize(): trace JSON path


class Obs:
    """Facade owning one MetricsRegistry + one Tracer, with the serving
    metric surface pre-named in one place so engine/scheduler/launch can
    never diverge on naming."""

    def __init__(self, config: ObsConfig | None = None):
        self.config = config or ObsConfig()
        self.enabled = self.config.enabled
        self.registry = MetricsRegistry()
        self.tracer = Tracer(
            capacity=self.config.trace_capacity,
            enabled=self.enabled and self.config.trace,
        )
        if not self.enabled:
            return
        r = self.registry
        cap = self.config.series_capacity
        # gauges synced tick-by-tick to engine/scheduler state
        self.g_waiting = r.gauge(
            "repro:num_requests_waiting", "requests queued, not yet admitted")
        self.g_running = r.gauge(
            "repro:num_requests_running", "slots in DECODING state")
        self.g_prefilling = r.gauge(
            "repro:num_requests_prefilling", "slots in PREFILLING state")
        self.g_slots_free = r.gauge(
            "repro:num_slots_free", "slots in FREE state")
        # request lifecycle counters (synced from scheduler/engine totals)
        self.c_completed = r.counter(
            "repro:request_success_total", "requests finished with output")
        self.c_rejected = r.counter(
            "repro:request_rejected_total", "admission rejections (won't fit)")
        self.c_prompt_tok = r.counter(
            "repro:prompt_tokens_total", "real prompt tokens prefilled")
        self.c_gen_tok = r.counter(
            "repro:generation_tokens_total", "tokens emitted by decode/verify")
        self.c_drafted = r.counter(
            "repro:spec_num_draft_tokens_total", "draft tokens proposed")
        self.c_accepted = r.counter(
            "repro:spec_num_accepted_tokens_total", "draft tokens accepted")
        # latency histograms
        self.h_ttft = r.histogram(
            "repro:time_to_first_token_seconds",
            "submit → first generated token", buckets=TTFT_BUCKETS)
        self.h_tpot = r.histogram(
            "repro:time_per_output_token_seconds",
            "mean inter-token latency per finished request",
            buckets=TPOT_BUCKETS)
        # paged-KV pool + radix prefix sharing (flat zero on unpaged engines)
        self.g_pages_free = r.gauge(
            "repro:kv_pages_free", "allocatable KV pages currently free")
        self.g_pages_total = r.gauge(
            "repro:kv_pages_total", "allocatable KV pages (null page excluded)")
        self.g_pages_shared = r.gauge(
            "repro:kv_pages_shared",
            "device-resident pages held by the radix prefix index")
        self.g_pages_offloaded = r.gauge(
            "repro:kv_pages_offloaded", "prefix pages parked in host RAM")
        self.c_prefix_hit_tok = r.counter(
            "repro:prefix_hit_tokens_total",
            "prompt tokens admitted straight off shared prefix pages")
        self.c_prefix_hit_req = r.counter(
            "repro:prefix_hit_requests_total",
            "admissions that matched at least one shared prefix page")
        self.c_pages_out = r.counter(
            "repro:kv_pages_paged_out_total", "cold pages moved to host RAM")
        self.c_pages_in = r.counter(
            "repro:kv_pages_paged_in_total", "host pages restored on a hit")
        self.c_pages_dropped = r.counter(
            "repro:kv_pages_dropped_total",
            "cold prefix pages evicted outright (offload tier full/off)")
        # per-tick batch composition: the M the mpGeMM kernels actually saw
        self.s_eff_m = r.series(
            "repro:tick_effective_m",
            "real parallel tokens through the batched step, per tick",
            capacity=cap)
        self.h_eff_m = r.histogram(
            "repro:mpgemm_batch_tokens",
            "real parallel tokens (M) per batched step", buckets=M_BUCKETS)

    # -- engine step instrumentation ------------------------------------
    def now(self) -> float:
        return time.perf_counter()

    def span(self, name: str, **args):
        if not self.enabled:
            return _NULL_SPAN
        return self.tracer.span(name, **args)

    def step_event(self, kind: str, t0: float, m_real: int, m_padded: int,
                   **extra) -> None:
        """One batched engine step ran over `m_real` real parallel tokens
        (`m_padded` including pad rows) in [t0, now]."""
        if not self.enabled:
            return
        t1 = time.perf_counter()
        self.registry.histogram(
            "repro:engine_step_seconds", "batched step wall time",
            labels={"kind": kind}, buckets=STEP_BUCKETS,
        ).observe(t1 - t0)
        self.s_eff_m.record(m_real)
        self.h_eff_m.observe(m_real)
        self.tracer.complete(
            f"engine_step/{kind}", t0, t1,
            args=dict(m_real=int(m_real), m_padded=int(m_padded), **extra),
        )

    def observe_ttft(self, seconds: float) -> None:
        if self.enabled:
            self.h_ttft.observe(seconds)

    def observe_tpot(self, seconds: float) -> None:
        if self.enabled:
            self.h_tpot.observe(seconds)

    def on_tick(self, engine, queue_depth: int, completed: int,
                rejected: int) -> None:
        """End-of-tick sync: queue/slot gauges + engine counter mirrors (the
        engine's plain attributes stay the source of truth; the registry is
        the export surface, so nothing is double-counted)."""
        if not self.enabled:
            return
        self.g_waiting.set(queue_depth)
        self.g_running.set(int(engine.active.sum()))
        self.g_prefilling.set(len(engine.prefilling))
        self.g_slots_free.set(sum(engine.slot_free))
        self.c_completed.sync_to(completed)
        self.c_rejected.sync_to(rejected)
        self.c_prompt_tok.sync_to(engine.prefill_tokens)
        self.c_gen_tok.sync_to(engine.decode_tokens)
        self.c_drafted.sync_to(engine.drafted_tokens)
        self.c_accepted.sync_to(engine.accepted_tokens)
        pager = getattr(engine, "pager", None)
        if pager is not None:
            self.g_pages_free.set(pager.free_pages)
            self.g_pages_total.set(pager.total_pages)
            self.g_pages_shared.set(pager.shared_pages)
            self.g_pages_offloaded.set(pager.offloaded_pages)
            self.c_prefix_hit_tok.sync_to(pager.prefix_hit_tokens)
            self.c_prefix_hit_req.sync_to(pager.prefix_hit_requests)
            self.c_pages_out.sync_to(pager.pages_paged_out)
            self.c_pages_in.sync_to(pager.pages_paged_in)
            self.c_pages_dropped.sync_to(pager.pages_dropped)

    # -- kernel hooks (ops.py via install()/current()) -------------------
    def mpgemm_span(self, m_tokens: int, k: int, n_out: int, impl: str,
                    fusion: str, tiles=None):
        """Span around one mpGeMM call (eager: one per call). m_tokens is
        the paper's M (parallel tokens; per expert in a grouped call);
        n_out × k is the weight shape; `tiles` the launch plan of each
        packed segment, one entry per kernel launch."""
        if not self.enabled:
            return _NULL_SPAN
        self.registry.counter(
            "repro:mpgemm_dispatch_total",
            "mpGeMM dispatches (one per call)",
            labels={"impl": str(impl), "fusion": str(fusion)},
        ).inc()
        return self.tracer.span(
            "mpgemm_dispatch", m=int(m_tokens), k=int(k), n=int(n_out),
            impl=str(impl), fusion=str(fusion), tile=tiles,
        )

    def record_kernel_sample(self, *, g: int, impl: str, m: int, kg: int,
                             n: int, fused: bool, seconds: float) -> None:
        """One measured kernel timing (a benchmark's device time per launch):
        per-(shape, impl) series + achieved-bandwidth/compute gauges. Here
        (m, kg·g) is the weight shape and n the parallel-token count (the JAX
        autotuner's convention)."""
        if not self.enabled or seconds <= 0:
            return
        labels = {"impl": str(impl), "g": str(g), "shape": f"{m}x{kg * g}",
                  "m_tokens": str(n)}
        self.registry.series(
            "repro:mpgemm_kernel_seconds", "measured kernel wall seconds",
            labels=labels, capacity=self.config.series_capacity,
        ).record(seconds)
        flops, bytes_ = mpgemm_cost(m, kg * g, n, g, fused=fused)
        self.registry.gauge(
            "repro:mpgemm_achieved_gflops", "achieved GFLOP/s (last sample)",
            labels=labels).set(flops / seconds / 1e9)
        self.registry.gauge(
            "repro:mpgemm_achieved_gbps", "achieved HBM GB/s (last sample)",
            labels=labels).set(bytes_ / seconds / 1e9)

    # -- reporting -------------------------------------------------------
    def stats_line(self) -> str:
        """One compact human line from the registry (launch.serve's periodic
        logger) — every figure read back from the metric objects, not from
        ad-hoc engine/ServeStats fields."""
        if not self.enabled:
            return "obs disabled"
        parts = [
            f"wait={int(self.g_waiting.value)}",
            f"run={int(self.g_running.value)}",
            f"prefill={int(self.g_prefilling.value)}",
            f"free={int(self.g_slots_free.value)}",
            f"done={int(self.c_completed.value)}",
            f"tok={int(self.c_prompt_tok.value)}+{int(self.c_gen_tok.value)}",
        ]
        if self.h_ttft.count:
            parts.append(f"ttft_p50={1e3 * self.h_ttft.percentile(0.5):.1f}ms")
        if self.h_tpot.count:
            parts.append(f"tpot_p50={1e3 * self.h_tpot.percentile(0.5):.1f}ms")
        if self.s_eff_m.count:
            parts.append(f"eff_m={self.s_eff_m.mean:.1f}")
        if self.c_drafted.value:
            acc = self.c_accepted.value / self.c_drafted.value
            parts.append(f"accept={acc:.2f}")
        if self.g_pages_total.value:
            parts.append(
                f"pages={int(self.g_pages_free.value)}/"
                f"{int(self.g_pages_total.value)}"
            )
            if self.c_prefix_hit_tok.value:
                parts.append(f"prefix_hit={int(self.c_prefix_hit_tok.value)}")
        if self.c_rejected.value:
            parts.append(f"rejected={int(self.c_rejected.value)}")
        return " ".join(parts)

    def finalize(self) -> list[str]:
        """Write the configured exports; returns the paths written."""
        out = []
        if self.enabled and self.config.metrics_out:
            out.append(self.registry.dump(self.config.metrics_out))
        if self.enabled and self.config.trace_out:
            out.append(self.tracer.write(self.config.trace_out))
        return out


#: the shared always-off instance — `Engine(obs=None)` resolves to this
NULL_OBS = Obs(ObsConfig(enabled=False))

_current: Obs | None = None


def install(obs: Obs | None) -> None:
    """Publish `obs` to the kernel-side hooks (ops); None detaches."""
    global _current
    _current = obs if (obs is not None and obs.enabled) else None


def current() -> Obs | None:
    """The installed Obs, or None — kernel hooks must treat None as off."""
    return _current
