"""repro_torch.obs against repro.obs: the metric and tracer cases of
tests/test_obs.py that need no JAX, run against the port; the exports of
both packages' registries for one seeded operation sequence (exact); the
port's engine with obs on against the JAX engine with obs on in chunked,
chain-speculative and paged serving (per-tick gauges, final counters,
effective-M samples, TTFT/TPOT counts, per-kind step events: equal); the
port's per-call mpGeMM dispatch spans; obs off; the launcher's flags.

The port runs its steps eagerly, so it records one `mpgemm_dispatch` span
per mpGeMM call, where the JAX engine's jitted steps record one per
compiled shape at trace time: the port's dispatch count is held to its own
rule (forwards x BitLinears per forward), never to JAX's."""
import json
import math
from collections import Counter

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import models as jm  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro import serve as js  # noqa: E402
from repro import spec as jspec  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.roofline import analysis as janalysis  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch import serve as ts  # noqa: E402
from repro_torch import spec as tspec  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import decoder  # noqa: E402
from repro_torch.models.common import PackedLinear  # noqa: E402
from repro_torch.obs import NULL_OBS, Obs, ObsConfig  # noqa: E402
from repro_torch.obs.metrics import (  # noqa: E402
    M_BUCKETS,
    STEP_BUCKETS,
    TPOT_BUCKETS,
    TTFT_BUCKETS,
    Counter as MCounter,
    Histogram,
    MetricsRegistry,
)
from repro_torch.obs.trace import _NULL_SPAN, Tracer  # noqa: E402
from repro_torch.roofline import analysis  # noqa: E402


@pytest.fixture(autouse=True)
def _detached():
    """Every test starts and ends with no Obs installed in either package
    (an enabled Obs installs itself for the mpGeMM dispatch hook)."""
    tobs.install(None)
    jobs.install(None)
    yield
    tobs.install(None)
    jobs.install(None)


# --------------------------------------------------------------------------
# The cases of tests/test_obs.py that need no JAX, against the port
# --------------------------------------------------------------------------
def test_histogram_bucket_assignment():
    h = Histogram("h", buckets=(1.0, 2.0, 5.0))
    for v in (0.5, 1.0, 1.5, 2.0, 4.0, 100.0):
        h.observe(v)
    # edges are upper bounds (bisect_left: v == edge lands in its bucket)
    assert h.counts == [2, 2, 1, 1]
    assert h.cumulative() == [2, 4, 5, 6]
    assert h.count == 6 and h.sum == pytest.approx(109.0)


def test_histogram_percentiles():
    h = Histogram("h", buckets=(1.0, 2.0, 4.0))
    for v in np.linspace(0.05, 0.95, 10):      # all mass in [0, 1)
        h.observe(float(v))
    assert h.percentile(0.5) == pytest.approx(0.5)
    assert h.percentile(1.0) == pytest.approx(1.0)
    tail = Histogram("t", buckets=(1.0, 2.0))
    assert tail.percentile(0.5) == 0.0           # no observations yet
    tail.observe(50.0)                           # +Inf tail: its lower edge
    assert tail.percentile(0.99) == 2.0
    with pytest.raises(ValueError):
        tail.percentile(1.5)


@pytest.mark.parametrize("name", ["TTFT", "TPOT", "STEP", "M"])
def test_ladders_sorted_and_equal_to_jax(name):
    ladder = {"TTFT": TTFT_BUCKETS, "TPOT": TPOT_BUCKETS, "STEP": STEP_BUCKETS,
              "M": M_BUCKETS}[name]
    assert list(ladder) == sorted(ladder)
    assert ladder == getattr(jmetrics, f"{name}_BUCKETS")


def test_counter_monotone_and_sync():
    c = MCounter("c")
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5
    with pytest.raises(ValueError):
        c.inc(-1)
    c.sync_to(10)
    c.sync_to(7)         # a stale snapshot must not roll the export back
    assert c.value == 10


def test_registry_get_or_create_and_kind_conflict():
    r = MetricsRegistry()
    a = r.counter("x", labels={"impl": "lookup"})
    assert a is r.counter("x", labels={"impl": "lookup"})
    c = r.counter("x", labels={"impl": "decode"})
    assert a is not c and r.find("x", {"impl": "decode"}) is c
    assert r.find("nope") is None
    with pytest.raises(TypeError):
        r.gauge("x", labels={"impl": "decode"})


def test_registry_exports():
    r = MetricsRegistry()
    r.counter("repro:req_total", "requests", {"kind": "a"}).inc(3)
    h = r.histogram("repro:lat_seconds", "latency", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    text = r.to_prometheus()
    assert "# TYPE repro:req_total counter" in text
    assert 'repro:req_total{kind="a"} 3' in text
    assert 'repro:lat_seconds_bucket{le="0.1"} 1' in text
    assert 'repro:lat_seconds_bucket{le="1"} 2' in text
    assert 'repro:lat_seconds_bucket{le="+Inf"} 3' in text
    r.gauge("g").set(2.0)
    s = r.series("s", capacity=2)
    for v in (1.0, 2.0, 3.0):
        s.record(v)
    by_name = {m["name"]: m for m in json.loads(json.dumps(r.to_json()))["metrics"]}
    assert by_name["g"]["value"] == 2.0
    assert by_name["s"]["samples"] == [2.0, 3.0]     # the ring keeps the newest
    assert by_name["s"]["count"] == 3 and by_name["s"]["mean"] == 2.0


def test_tracer_span_ring_and_export(tmp_path):
    tr = Tracer()
    with tr.span("work", m=4) as sp:
        sp.args["extra"] = 1
    ev = tr.events[-1]
    assert ev["name"] == "work" and ev["ph"] == "X" and ev["args"] == {"m": 4, "extra": 1}
    assert ev["dur"] >= 0.0 and ev["ts"] >= 0.0
    tr.complete("b", tr._t0, tr._t0 + 1e-3, args={"k": 1})
    blob = json.loads(open(tr.write(str(tmp_path / "trace.json"))).read())
    assert blob["displayTimeUnit"] == "ms"
    assert blob["traceEvents"][1]["dur"] == pytest.approx(1000.0)
    ring = Tracer(capacity=3)
    for i in range(5):
        ring.instant(f"e{i}")
    assert [e["name"] for e in ring.events] == ["e2", "e3", "e4"]
    assert ring.dropped == 2 and ring.to_json()["otherData"]["dropped_events"] == 2
    off = Tracer(enabled=False)
    assert off.span("x") is _NULL_SPAN
    off.complete("x", 0.0)
    off.instant("x")
    assert not off.events and off.emitted == 0


def test_null_obs_is_inert():
    assert not NULL_OBS.enabled
    assert NULL_OBS.span("x") is _NULL_SPAN
    assert NULL_OBS.mpgemm_span(1, 2, 3, "decode", "fused") is _NULL_SPAN
    NULL_OBS.step_event("decode", 0.0, m_real=1, m_padded=1)
    NULL_OBS.observe_ttft(1.0)
    NULL_OBS.observe_tpot(1.0)
    NULL_OBS.on_tick(None, queue_depth=0, completed=0, rejected=0)
    NULL_OBS.record_kernel_sample(g=4, impl="lookup", m=8, kg=2, n=1, fused=True, seconds=1e-3)
    assert not NULL_OBS.registry.all() and not NULL_OBS.tracer.events
    assert NULL_OBS.stats_line() == "obs disabled" and NULL_OBS.finalize() == []
    with _NULL_SPAN as sp:
        sp.args["k"] = "v"                     # legal, discarded
    assert sp.args == {}
    tobs.install(NULL_OBS)
    assert tobs.current() is None
    live = Obs(ObsConfig())
    tobs.install(live)
    assert tobs.current() is live
    tobs.install(None)
    assert tobs.current() is None


def test_obs_facade_step_event_and_span():
    o = Obs(ObsConfig())
    o.step_event("chunk", o.now(), m_real=24, m_padded=32, prefills=3)
    assert o.registry.find("repro:engine_step_seconds", {"kind": "chunk"}).count == 1
    assert list(o.s_eff_m.samples) == [24.0] and o.h_eff_m.count == 1
    ev = o.tracer.events[-1]
    assert ev["name"] == "engine_step/chunk"
    assert ev["args"] == {"m_real": 24, "m_padded": 32, "prefills": 3}
    with o.mpgemm_span(16, 2048, 512, impl="decode", fusion="fused", tiles=["g5 128x16 s1 k32"]):
        pass
    c = o.registry.find("repro:mpgemm_dispatch_total", {"impl": "decode", "fusion": "fused"})
    assert c.value == 1
    ev = o.tracer.events[-1]
    assert ev["name"] == "mpgemm_dispatch" and ev["args"]["tile"] == ["g5 128x16 s1 k32"]
    assert (ev["args"]["m"], ev["args"]["k"], ev["args"]["n"]) == (16, 2048, 512)


def test_obs_finalize_writes_exports(tmp_path):
    o = Obs(ObsConfig(metrics_out=str(tmp_path / "m.json"), trace_out=str(tmp_path / "t.json")))
    o.observe_ttft(0.02)
    with o.span("x"):
        pass
    paths = o.finalize()
    assert len(paths) == 2
    names = {x["name"] for x in json.loads(open(paths[0]).read())["metrics"]}
    assert "repro:time_to_first_token_seconds" in names
    assert json.loads(open(paths[1]).read())["traceEvents"][0]["name"] == "x"


# --------------------------------------------------------------------------
# Parity with repro.obs
# --------------------------------------------------------------------------
def _apply_ops(registry_cls, seed: int):
    """One seeded sequence of registry operations (labels, kinds, values)."""
    rng = np.random.default_rng(seed)
    r = registry_cls()
    for _ in range(300):
        name = f"repro:m{int(rng.integers(0, 6))}"
        kind = ("counter", "gauge", "histogram", "series")[int(name[-1]) % 4]
        labels = {"impl": str(rng.choice(["decode", "lookup"]))} if rng.random() < 0.5 else None
        v = float(rng.choice([0.0, 1.0, 2.5, 1e-4, 0.37, 123.0, 7e3]) * rng.random())
        if kind == "counter":
            c = r.counter(name, "a counter", labels)
            c.inc(v) if rng.random() < 0.5 else c.sync_to(v * 10)
        elif kind == "gauge":
            g = r.gauge(name, "a gauge", labels)
            g.set(v) if rng.random() < 0.5 else g.inc(v)
        elif kind == "histogram":
            r.histogram(name, "a histogram", labels, buckets=STEP_BUCKETS).observe(v)
        else:
            r.series(name, "", labels, capacity=16).record(v)
    return r


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_exports_equal_jax(seed):
    got, want = _apply_ops(MetricsRegistry, seed), _apply_ops(jmetrics.MetricsRegistry, seed)
    assert got.to_prometheus() == want.to_prometheus()
    assert json.dumps(got.to_json()) == json.dumps(want.to_json())


def _untimed(events):
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")} for e in events]


def test_obs_facade_equal_jax():
    """The same facade calls on both packages' Obs: equal registries (the
    dispatch counter's help says the port counts calls), equal trace events
    once the timestamps are removed, equal stats lines."""
    class _Engine:
        active = np.array([True, False, True])
        prefilling = {1: None}
        slot_free = [False, False, True]
        prefill_tokens, decode_tokens, drafted_tokens, accepted_tokens = 40, 12, 9, 6
        pager = None

    both = []
    for pkg in (tobs, jobs):
        o = pkg.Obs(pkg.ObsConfig())
        rng = np.random.default_rng(3)
        for i in range(20):
            o.step_event(("decode", "chunk", "verify")[i % 3], o.now() - float(rng.random()),
                         m_real=int(rng.integers(1, 64)), m_padded=64, k=4)
            o.observe_ttft(float(rng.random()))
            o.observe_tpot(float(rng.random()) / 50)
            with o.mpgemm_span(int(rng.integers(1, 9)), 960, 2560, "decode", "fused", tiles=None):
                pass
        o.on_tick(_Engine(), queue_depth=3, completed=5, rejected=1)
        both.append(o)
    got, want = both
    # the step histograms' observations are wall times measured apart, so
    # the timed metrics are compared by count; everything else exactly
    timed = {"repro:engine_step_seconds"}
    gj, wj = got.registry.to_json()["metrics"], want.registry.to_json()["metrics"]
    assert [m["name"] for m in gj] == [m["name"] for m in wj]
    for a, b in zip(gj, wj):
        if a["name"] in timed:
            assert a["count"] == b["count"] and a["labels"] == b["labels"]
        else:
            assert a == b, a["name"]
    help_line = "# HELP repro:mpgemm_dispatch_total"
    strip = lambda text: [ln for ln in text.splitlines()  # noqa: E731
                          if not ln.startswith(help_line) and "engine_step_seconds" not in ln]
    assert strip(got.registry.to_prometheus()) == strip(want.registry.to_prometheus())
    assert _untimed(got.tracer.events) == _untimed(want.tracer.events)
    assert got.stats_line() == want.stats_line()


@pytest.mark.parametrize("fused", [True, False])
def test_mpgemm_cost_equals_jax(fused):
    for m in (1, 320, 960, 2560, 8192):
        for k in (60, 960, 964, 2560, 5120):
            for n in (1, 4, 17, 256):
                for g in (4, 5):
                    assert analysis.mpgemm_cost(m, k, n, g, fused=fused) == \
                        janalysis.mpgemm_cost(m, k, n, g, fused=fused)


def test_record_kernel_sample_equals_jax():
    samples = [dict(g=5, impl="decode", m=2560, kg=192, n=4, fused=True, seconds=7.5e-6),
               dict(g=4, impl="lookup", m=512, kg=512, n=16, fused=False, seconds=1e-3),
               dict(g=5, impl="decode", m=2560, kg=192, n=4, fused=True, seconds=9e-6)]
    got, want = Obs(ObsConfig()), jobs.Obs(jobs.ObsConfig())
    for s in samples:
        got.record_kernel_sample(**s)
        want.record_kernel_sample(**s)
    names = ("repro:mpgemm_kernel_seconds", "repro:mpgemm_achieved_gflops",
             "repro:mpgemm_achieved_gbps")
    g = [m for m in got.registry.to_json()["metrics"] if m["name"] in names]
    w = [m for m in want.registry.to_json()["metrics"] if m["name"] in names]
    assert g == w and len(g) == 6
    labels = {"impl": "decode", "g": "5", "shape": "2560x960", "m_tokens": "4"}
    gbps = got.registry.find("repro:mpgemm_achieved_gbps", labels).value
    assert gbps == analysis.mpgemm_cost(2560, 960, 4, 5)[1] / 9e-6 / 1e9
    assert math.isfinite(gbps)


# --------------------------------------------------------------------------
# The engine with obs on against the JAX engine with obs on
# --------------------------------------------------------------------------
DTYPE = "float32"


@pytest.fixture(scope="module")
def served():
    jcfg = jget_config("smollm-360m", smoke=True).with_(dtype=DTYPE)
    tcfg = tget_config("smollm-360m", smoke=True).with_(dtype=DTYPE)
    params = jm.pack_params(jm.init_lm(jax.random.PRNGKey(0), jcfg), jcfg)
    return jcfg, tcfg, params, jax.tree.map(np.asarray, params)


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def _shared_prefix_prompts(vocab, seed=0):
    """TestPagedObs's prompts: one 16-token prefix (2 pages of 8) + 4
    unique tokens each."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, size=16).astype(np.int32)
    return [np.concatenate([shared, rng.integers(0, vocab, size=4).astype(np.int32)])
            for _ in range(3)]


def _run(pkg, eng, prompts, max_new):
    sched = pkg.ContinuousBatchingScheduler(eng)
    sched.submit(pkg.Request(rid=i, prompt=p.copy(), max_new_tokens=max_new)
                 for i, p in enumerate(prompts))
    return sched.run_to_completion()


def _observed(pkg, eng, prompts, max_new):
    """Serve `prompts` tick by tick; → (tokens, per-tick gauge tuples, obs)."""
    sched = pkg.ContinuousBatchingScheduler(eng)
    reqs = [pkg.Request(rid=i, prompt=p.copy(), max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    sched.submit(reqs)
    o, ticks = eng.obs, []
    while sched.queue or eng.has_work:
        sched.tick()
        ticks.append((o.g_waiting.value, o.g_running.value, o.g_prefilling.value,
                      o.g_slots_free.value))
    return [r.generated for r in reqs], ticks, o


_COUNTERS = ("c_completed", "c_rejected", "c_prompt_tok", "c_gen_tok", "c_drafted", "c_accepted",
             "c_prefix_hit_tok", "c_prefix_hit_req", "c_pages_out", "c_pages_in",
             "c_pages_dropped", "g_pages_free", "g_pages_total", "g_pages_shared",
             "g_pages_offloaded")

#: the three serving modes of the parity test: JAX TestEngineIntegration's
#: chunked run, chain speculation, and TestPagedObs's paged run
MODES = {
    "chunked": dict(kw=dict(prefill_chunk=4), slots=2, lens=(5, 9, 13, 19, 7), max_new=6),
    "chain": dict(kw=dict(spec=dict(k=3)), slots=3, lens=(5, 13, 20, 9), max_new=8),
    "paged": dict(kw=dict(paged_kv=8), slots=1, lens=None, max_new=4),
}


def _engines(served, mode):
    jcfg, tcfg, params, host = served
    m = MODES[mode]
    jkw, tkw = dict(m["kw"]), dict(m["kw"])
    if "spec" in jkw:
        jkw["spec"] = jspec.SpecConfig(**m["kw"]["spec"])
        tkw["spec"] = tspec.SpecConfig(**m["kw"]["spec"])
    if "paged_kv" in jkw:
        jkw["paged_kv"] = js.PagedKVConfig(page_size=m["kw"]["paged_kv"])
        tkw["paged_kv"] = ts.PagedKVConfig(page_size=m["kw"]["paged_kv"])
    common = dict(max_slots=m["slots"], max_len=64)
    jeng = js.Engine(params, jcfg, obs=jobs.ObsConfig(), **common, **jkw)
    teng = ts.Engine(bridge.lm_from_jax(host, tcfg, device="cpu"), tcfg, obs=ObsConfig(),
                     device="cpu", **common, **tkw)
    return jeng, teng


def _forward_log(monkeypatch):
    """Record each forward's token count N = B x S, through `lm_hidden`."""
    log = []
    lm_hidden = decoder.lm_hidden

    def counted(model, tokens, *a, **k):
        log.append(tokens.numel())
        return lm_hidden(model, tokens, *a, **k)

    monkeypatch.setattr(decoder, "lm_hidden", counted)
    return log


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_obs_equals_jax(served, mode, monkeypatch):
    m = MODES[mode]
    vocab = served[0].vocab
    prompts = (_shared_prefix_prompts(vocab) if m["lens"] is None
               else _prompts(vocab, m["lens"], seed=1))
    jeng, teng = _engines(served, mode)
    jtok, jticks, jo = _observed(js, jeng, prompts, m["max_new"])
    tobs.install(teng.obs)       # the JAX engine installed its own since
    forwards = _forward_log(monkeypatch)
    ttok, tticks, to = _observed(ts, teng, prompts, m["max_new"])
    assert ttok == jtok
    assert tticks == jticks and tticks[-1][3] == m["slots"]
    for name in _COUNTERS:
        assert getattr(to, name).value == getattr(jo, name).value, name
    assert list(to.s_eff_m.samples) == list(jo.s_eff_m.samples)
    assert to.h_ttft.count == jo.h_ttft.count == len(prompts)
    assert to.h_tpot.count == jo.h_tpot.count
    kinds = lambda o: Counter(e["name"] for e in o.tracer.events  # noqa: E731
                              if e["name"] == "scheduler_tick"
                              or e["name"].startswith("engine_step/"))
    assert kinds(to) == kinds(jo) and kinds(to)["scheduler_tick"] == len(tticks)
    if mode == "chunked":
        assert kinds(to)["engine_step/chunk"] > 0
    if mode == "chain":
        assert kinds(to)["engine_step/verify"] > 0 and to.c_drafted.value > 0
    if mode == "paged":
        assert to.c_prefix_hit_tok.value == teng.prefix_hit_tokens > 0
        assert to.c_prefix_hit_req.value == teng.prefix_hit_requests == 2
        assert to.g_pages_total.value == teng.pager.total_pages
        assert "pages=" in to.stats_line() and "prefix_hit=" in to.stats_line()
    # the port's own rule: one dispatch span per BitLinear per forward, with
    # the forward's token count as M and each linear's (K, M) as (k, n)
    pws = [lin.pw for lin in teng.params.modules() if isinstance(lin, PackedLinear)]
    lins = Counter((pw.K, pw.M) for pw in pws)
    by_shape = {(pw.K, pw.M): pw for pw in pws}
    spans = [e["args"] for e in to.tracer.events if e["name"] == "mpgemm_dispatch"]
    per = sum(lins.values())
    assert len(spans) == per * len(forwards)
    total = to.registry.find("repro:mpgemm_dispatch_total", {"impl": "decode", "fusion": "fused"})
    assert total.value == len(spans)
    for i, n in enumerate(forwards):
        fwd = spans[i * per:(i + 1) * per]
        assert all(s["m"] == n for s in fwd)
        assert Counter((s["k"], s["n"]) for s in fwd) == lins
        assert all(s["tile"] == ops.launch_tiles(by_shape[s["k"], s["n"]], n, "decode")
                   for s in fwd)


def test_dispatch_spans_nest_in_steps_and_ticks(served):
    """Whole-prompt serving: every dispatch span lies inside an engine step
    span, or (admission prefills) inside a scheduler tick."""
    _, tcfg, _, host = served
    eng = ts.Engine(bridge.lm_from_jax(host, tcfg, device="cpu"), tcfg, max_slots=2, max_len=64,
                    obs=ObsConfig(), device="cpu")
    _observed(ts, eng, _prompts(tcfg.vocab, (5, 9, 13)), 4)
    ev = list(eng.obs.tracer.events)
    inside = lambda c, p: p["ts"] <= c["ts"] and c["ts"] + c["dur"] <= p["ts"] + p["dur"] + 1e-3  # noqa: E731
    steps = [e for e in ev if e["name"].startswith("engine_step/")]
    ticks = [e for e in ev if e["name"] == "scheduler_tick"]
    spans = [e for e in ev if e["name"] == "mpgemm_dispatch"]
    in_step = [s for s in spans if any(inside(s, p) for p in steps)]
    rest = [s for s in spans if s not in in_step]
    assert all(any(inside(s, t) for t in ticks) for s in rest)
    per = sum(isinstance(m, PackedLinear) for m in eng.params.modules())
    assert len(rest) == 3 * per and len(in_step) == per * len(steps)


def test_grouped_dispatch_one_span_per_call():
    """llama4's smoke MoE layers: one span per grouped call, with the rows
    per expert as M and one tile (one grouped launch) per packed segment."""
    from repro_torch.models import init_cache, prefill
    from repro_torch.models.moe import capacity

    cfg = tget_config("llama4-scout-17b-a16e", smoke=True).with_(dtype=DTYPE)
    model = decoder.init_lm(cfg, torch.Generator().manual_seed(0), packed=True)
    tokens = torch.from_numpy(_prompts(cfg.vocab, (11,))[0][None, :])
    o = Obs(ObsConfig())
    tobs.install(o)
    prefill(model, tokens, init_cache(cfg, 1, 32, device="cpu"), cfg)
    spans = [e["args"] for e in o.tracer.events if e["name"] == "mpgemm_dispatch"]
    stacked = [lin for lin in model.modules()
               if isinstance(lin, PackedLinear) and lin.packed5.ndim == 3]
    single = [lin for lin in model.modules()
              if isinstance(lin, PackedLinear) and lin.packed5.ndim == 2]
    grouped = [s for s in spans if s["tile"] and s["tile"][0].startswith("e")]
    assert len(stacked) == 3 * cfg.n_layers and len(grouped) == len(stacked)
    assert len(spans) == len(single) + len(stacked)
    c = capacity(11, cfg)
    e = cfg.moe.n_experts
    for s in grouped:
        lin = next(lin for lin in stacked if (lin.pw.K, lin.pw.M) == (s["k"], s["n"]))
        assert s["m"] == c and s["tile"] == ops.launch_tiles(lin.pw, c, "decode", e)
    assert any(len(s["tile"]) == 2 for s in grouped)      # two segments, two launches
    assert all(s["m"] == 11 for s in spans if s not in grouped)


# --------------------------------------------------------------------------
# Off is free; the launcher
# --------------------------------------------------------------------------
def test_engine_without_obs_records_nothing(served, monkeypatch):
    _, tcfg, _, host = served
    eng = ts.Engine(bridge.lm_from_jax(host, tcfg, device="cpu"), tcfg, max_slots=2, max_len=64,
                    device="cpu")
    assert eng.obs is NULL_OBS and tobs.current() is None
    calls = []
    monkeypatch.setattr(ops, "launch_tiles", lambda *a, **k: calls.append(a))
    stats = _run(ts, eng, _prompts(tcfg.vocab, (5, 9, 13)), 3)
    assert stats.completed == 3
    assert not NULL_OBS.registry.all() and not NULL_OBS.tracer.events
    assert tobs.current() is None and not calls


def test_serve_cli_obs(tmp_path, capsys):
    from repro_torch.launch import serve as launch

    m, t = tmp_path / "m.json", tmp_path / "t.json"
    stats = launch.main(["--arch", "smollm-360m", "--smoke", "--device", "cpu", "--requests", "3",
                         "--slots", "2", "--max-new", "4", "--prompt-len", "20", "--max-len", "64",
                         "--stats-interval", "1e-9", "--metrics-out", str(m),
                         "--trace-out", str(t)])
    out = capsys.readouterr().out
    assert stats.completed == 3 and "[obs] " in out and "ttft_p50_ms=" in out
    assert f"wrote {m}" in out and f"wrote {t}" in out
    metrics = {x["name"]: x for x in json.loads(m.read_text())["metrics"]}
    assert metrics["repro:request_success_total"]["value"] == 3
    assert metrics["repro:time_to_first_token_seconds"]["count"] == 3
    names = Counter(e["name"] for e in json.loads(t.read_text())["traceEvents"])
    assert names["scheduler_tick"] and names["engine_step/decode"] and names["mpgemm_dispatch"]
    assert tobs.current() is None                 # main() detaches the hook
    with pytest.raises(SystemExit):
        launch.main(["--arch", "smollm-360m", "--smoke", "--device", "cpu", "--no-obs",
                     "--metrics-out", str(m)])
    assert "--no-obs conflicts" in capsys.readouterr().err
