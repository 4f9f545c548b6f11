"""Metrics registry: counters, gauges, fixed-bucket histograms, sample series
(ported from `repro.obs.metrics`; the exports are byte for byte the same).

Pure stdlib (no torch import): the registry is host-side bookkeeping that the
serving stack updates at tick boundaries, so it must never add device work or
a host sync to the hot path. Metric names follow the vLLM serving vocabulary
with a ``repro:`` prefix (``repro:num_requests_waiting``,
``repro:time_to_first_token_seconds``, ...), the same names as the JAX
package's, so one dashboard or bench reader serves both; see
docs/observability.md for the full table.

Two export surfaces:

  * ``to_prometheus()`` — Prometheus text exposition format 0.0.4 (counters
    get a ``_total``-preserving TYPE line, histograms expand to
    ``_bucket{le=...}`` / ``_sum`` / ``_count``);
  * ``to_json()`` / ``dump(path)`` — a lossless JSON snapshot (histogram
    bucket counts, raw series samples) for offline analysis.

Histograms are fixed-bucket (cumulative-count semantics, like Prometheus);
``percentile(q)`` linearly interpolates within the winning bucket, which is
exact enough for TTFT/TPOT p50/p95/p99 reporting at the bucket resolutions
used here.
"""
from __future__ import annotations

import bisect
import json
import math
from collections import deque

#: default latency bucket edges (seconds) — vLLM's TTFT histogram ladder
TTFT_BUCKETS = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)
#: per-output-token latency ladder (decode steps are ms-scale)
TPOT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
)
#: engine-step wall-time ladder (same scale as TPOT but wider tail: a chunk
#: step over many slots legitimately runs long)
STEP_BUCKETS = TPOT_BUCKETS + (2.5, 5.0)
#: effective parallel-token (M) ladder — powers of two up to a big batch
M_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


def _fmt(v: float) -> str:
    """Prometheus float formatting: integers without the trailing .0."""
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def _label_str(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return "{" + inner + "}"


class Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = "", labels: dict | None = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})


class Counter(Metric):
    kind = "counter"

    def __init__(self, name, help="", labels=None):
        super().__init__(name, help, labels)
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {v})")
        self.value += v

    def sync_to(self, total: float) -> None:
        """Mirror an external monotone counter (the engine's live attributes
        are the source of truth; the registry copy can only move forward)."""
        if total > self.value:
            self.value = float(total)


class Gauge(Metric):
    kind = "gauge"

    def __init__(self, name, help="", labels=None):
        super().__init__(name, help, labels)
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Histogram(Metric):
    """Fixed-bucket histogram with Prometheus cumulative-bucket exposition
    and interpolated percentiles. Bucket edges are upper bounds; an implicit
    +Inf bucket catches the tail."""

    kind = "histogram"

    def __init__(self, name, help="", labels=None, buckets=TTFT_BUCKETS):
        super().__init__(name, help, labels)
        self.edges = tuple(sorted(float(b) for b in buckets))
        if not self.edges:
            raise ValueError(f"histogram {name} needs at least one bucket")
        self.counts = [0] * (len(self.edges) + 1)   # per-bucket (not cumulative)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.edges, float(v))] += 1
        self.sum += float(v)
        self.count += 1

    def cumulative(self) -> list[int]:
        out, acc = [], 0
        for c in self.counts:
            acc += c
            out.append(acc)
        return out

    def percentile(self, q: float) -> float:
        """Interpolated q-quantile (q in [0, 1]) from the bucket counts.
        Within the winning bucket the mass is assumed uniform; the +Inf
        bucket reports its lower edge (the histogram cannot see further)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        if self.count == 0:
            return 0.0
        rank = q * self.count
        acc = 0
        for i, c in enumerate(self.counts):
            if acc + c >= rank and c > 0:
                lo = self.edges[i - 1] if i > 0 else 0.0
                if i == len(self.edges):           # +Inf tail
                    return self.edges[-1]
                hi = self.edges[i]
                return lo + (hi - lo) * max(rank - acc, 0.0) / c
            acc += c
        return self.edges[-1]


class Series(Metric):
    """Bounded ring of raw samples (newest kept) + lifetime count/sum — for
    low-volume per-tick signals where the raw sequence matters (effective M
    per tick, kernel timing samples). JSON dump includes the samples."""

    kind = "series"

    def __init__(self, name, help="", labels=None, capacity: int = 4096):
        super().__init__(name, help, labels)
        self.samples: deque[float] = deque(maxlen=capacity)
        self.sum = 0.0
        self.count = 0

    def record(self, v: float) -> None:
        self.samples.append(float(v))
        self.sum += float(v)
        self.count += 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class MetricsRegistry:
    """get-or-create registry keyed on (name, sorted labels)."""

    def __init__(self):
        self._metrics: dict[tuple, Metric] = {}

    def _get(self, cls, name, help, labels, **kw) -> Metric:
        key = (name, tuple(sorted((labels or {}).items())))
        m = self._metrics.get(key)
        if m is None:
            m = cls(name, help, labels, **kw)
            self._metrics[key] = m
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name} already registered as {m.kind}, not {cls.kind}"
            )
        return m

    def counter(self, name, help="", labels=None) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name, help="", labels=None) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name, help="", labels=None, buckets=TTFT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    def series(self, name, help="", labels=None, capacity: int = 4096) -> Series:
        return self._get(Series, name, help, labels, capacity=capacity)

    def find(self, name: str, labels: dict | None = None) -> Metric | None:
        return self._metrics.get((name, tuple(sorted((labels or {}).items()))))

    def all(self) -> list[Metric]:
        return list(self._metrics.values())

    # -- export ----------------------------------------------------------
    def to_prometheus(self) -> str:
        lines: list[str] = []
        typed: set[str] = set()
        for m in self._metrics.values():
            if m.name not in typed:
                typed.add(m.name)
                if m.help:
                    lines.append(f"# HELP {m.name} {m.help}")
                # series exposes like an (uncapped-observation) summary
                kind = "summary" if m.kind == "series" else m.kind
                lines.append(f"# TYPE {m.name} {kind}")
            ls = _label_str(m.labels)
            if isinstance(m, Histogram):
                cum = m.cumulative()
                for edge, c in zip(m.edges + (math.inf,), cum):
                    le = dict(m.labels, le=_fmt(edge))
                    lines.append(f"{m.name}_bucket{_label_str(le)} {c}")
                lines.append(f"{m.name}_sum{ls} {_fmt(m.sum)}")
                lines.append(f"{m.name}_count{ls} {m.count}")
            elif isinstance(m, Series):
                lines.append(f"{m.name}_sum{ls} {_fmt(m.sum)}")
                lines.append(f"{m.name}_count{ls} {m.count}")
            else:
                lines.append(f"{m.name}{ls} {_fmt(m.value)}")
        return "\n".join(lines) + "\n"

    def to_json(self) -> dict:
        out: list[dict] = []
        for m in self._metrics.values():
            d: dict = dict(name=m.name, kind=m.kind, labels=m.labels)
            if isinstance(m, Histogram):
                d.update(
                    buckets=list(m.edges), counts=list(m.counts),
                    sum=m.sum, count=m.count,
                    p50=m.percentile(0.50), p95=m.percentile(0.95),
                    p99=m.percentile(0.99),
                )
            elif isinstance(m, Series):
                d.update(samples=list(m.samples), sum=m.sum, count=m.count,
                         mean=m.mean)
            else:
                d["value"] = m.value
            out.append(d)
        return {"metrics": out}

    def dump(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)
        return path
