"""repro_torch.serve.graphs: the serving steps' CUDA-graph capture with
donated caches (the counterpart of the JAX engine's ``jax.jit(...,
donate_argnums=(1,))``), its bookkeeping checked on the CPU.

A CUDA graph needs the card (`chip_smoke.py` holds graphed serving against
eager serving there). Here a stand-in capture (`stub_capture`) gives the
graph's semantics: the capture leaves no trace (the donated cache is
restored; `StepGraphs` takes the launch counts back), and each replay runs
the step again on the static inputs, writes its outputs into the static
ones and counts no launch of its own; `aliasing_capture` also places every
graph's static outputs in one storage, the worst a shared pool allows. Every cache kind is held to the
functional step: the donated leaves keep their storage and equal the
functional step's leaves tick by tick, through decode, chunk, verify,
compaction and rollback. Engines with graphed steps emit the eager
engines' tokens and counters (and the JAX engine's, on the dense smoke
model)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import models as jm  # noqa: E402
from repro import serve as js  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import lint as tlint  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch import serve as ts  # noqa: E402
from repro_torch import spec as tspec  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.kernels import LAUNCH_COUNTERS, autotune, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ternary_decode_gemm as tdg  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.serve import graphs as tg  # noqa: E402

SLOTS, MAX_LEN, PS = 3, 32, 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny ops: one intra-op thread each avoids oversubscribing the
    parallel test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# the stand-in capture
# --------------------------------------------------------------------------
def _copy_into(static, new):
    if isinstance(static, torch.Tensor):
        static.copy_(new)
    elif isinstance(static, (tuple, list)):
        for s, n in zip(static, new):
            _copy_into(s, n)


class StubGraph:
    """A replay runs the captured body again (a graph runs no Python: the
    launch counts its wrappers add are taken back) and writes its outputs
    into the static ones."""

    def __init__(self, body, out):
        self.body, self.out = body, out

    def replay(self):
        counters = list(LAUNCH_COUNTERS.values())
        before = [fn.launches for fn in counters]
        out = self.body()
        for fn, n in zip(counters, before):
            fn.launches = n
        _copy_into(self.out, out)


def stub_capture(tensors):
    """A capture that runs the body once for its outputs and restores
    every tensor of `tensors()` (the donated caches): nothing ran."""
    def capture(body, pool):
        saved = [t.clone() for t in tensors()]
        out = body()
        for t, s in zip(tensors(), saved):
            t.copy_(s)
        return StubGraph(body, out), out
    return capture


def _aliased(out, arena, offset):
    """`out` rebuilt as views of `arena` from byte `offset` on (16-byte
    aligned), its values copied. → (views, next offset)."""
    if isinstance(out, torch.Tensor):
        n = out.numel() * out.element_size()
        assert offset + n <= arena.numel(), "the test's arena is too small"
        view = arena[offset:offset + n].view(out.dtype).view(out.shape)
        view.copy_(out)
        return view, offset + -(-n // 16) * 16
    if isinstance(out, (tuple, list)):
        views = []
        for o in out:
            v, offset = _aliased(o, arena, offset)
            views.append(v)
        return type(out)(views), offset
    return out, offset


def aliasing_capture(tensors, arena_bytes=1 << 22):
    """`stub_capture`, with every graph's static outputs laid from the
    start of one shared storage: a replay of any key overwrites the
    outputs of every other key, as graphs sharing a pool may."""
    arena = torch.zeros(arena_bytes, dtype=torch.uint8)
    stub = stub_capture(tensors)

    def capture(body, pool):
        graph, out = stub(body, pool)
        graph.out, _ = _aliased(out, arena, 0)
        return graph, graph.out
    return capture


def leaves(*caches):
    return [leaf for cache in caches for layer in cache for leaf in layer.values()]


def stub_graphs(*caches, capture=stub_capture):
    return tg.StepGraphs("cpu", capture=capture(lambda: leaves(*caches)))


def staged(graphs, entry, inputs):
    """`inputs` filled into `graphs`' static buffers, as every caller
    stages a step's tensor inputs."""
    return tuple(graphs.upload(f"{entry}.{i}", t) if isinstance(t, torch.Tensor) else t
                 for i, t in enumerate(inputs))


def clone_cache(cache):
    return [{k: v.clone() for k, v in layer.items()} for layer in cache]


def assert_caches_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys(), i
        for key in g:
            assert torch.equal(g[key], w[key]), (i, key)


def assert_out_equal(got, want):
    if want is None:
        assert got is None
    elif isinstance(want, torch.Tensor):
        assert torch.equal(got, want)
    else:
        for g, w in zip(got, want):
            assert_out_equal(g, w)


# --------------------------------------------------------------------------
# every cache kind against the functional step
# --------------------------------------------------------------------------
ARCHS = {"dense": "smollm-360m", "paged": "smollm-360m", "mla": "deepseek-v3-671b",
         "ssm": "mamba2-1.3b", "ring": "gemma3-1b", "encdec": "whisper-medium"}
ROLLBACK = ("dense", "paged", "mla")
S_ENC, PROMPT = 16, 10


def _model(kind):
    cfg = tget_config(ARCHS[kind], smoke=True).with_(dtype="float32")
    gen = torch.Generator().manual_seed(0)
    init = tm.encdec_init if kind == "encdec" else tm.init_lm
    return tm.pack_params(init(cfg, gen), cfg), cfg


def _filled_cache(kind, model, cfg, rng):
    """A batch cache after a PROMPT-token prefill (the paged one through an
    identity-like block table; the enc-dec one with its cross K/V)."""
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, size=(SLOTS, PROMPT)).astype(np.int32))
    if kind == "paged":
        cap = MAX_LEN // PS
        cache = tm.init_cache(cfg, SLOTS, MAX_LEN, device="cpu", page_size=PS,
                              n_pages=SLOTS * cap + 1)
        tm.set_block_tables(cache, 1 + torch.arange(SLOTS * cap, dtype=torch.int32).view(SLOTS, cap))
    elif kind == "encdec":
        cache = tm.init_cache(cfg, SLOTS, MAX_LEN, enc_len=S_ENC, device="cpu")
        frames = torch.from_numpy(rng.standard_normal((SLOTS, S_ENC, cfg.d_model)).astype(np.float32))
        _, new = tsteps.make_prefill_step(cfg, device="cpu")(
            model, cache, {"tokens": tokens, "frames": frames})
        return tg.write_back(cache, new)
    else:
        cache = tm.init_cache(cfg, SLOTS, MAX_LEN, device="cpu")
    with torch.no_grad():
        _, new = tm.prefill(model, tokens, cache, cfg)
    return tg.write_back(cache, new)


def _ticks(kind, model, cfg, rng):
    """[(entry, fn, inputs, rollback idx or None)]: each entry three times or
    more (warm-up, capture, replays), the write positions rolled back after
    the multi-token steps as the engine does."""
    def toks(s):
        return torch.from_numpy(rng.integers(0, cfg.vocab, size=(SLOTS, s)).astype(np.int32))

    if kind == "encdec":
        dec = tsteps.make_decode_step(cfg, device="cpu")
        return [("decode", lambda p, c, t: dec(p, c, t), (toks(1),), None) for _ in range(4)]
    decode = (lambda p, c, t: tm.decode_step(p, t, c, cfg))
    out = [("decode", decode, (toks(1),), None) for _ in range(4)]
    if kind not in ROLLBACK:
        return out
    base = PROMPT + 4
    tree = tspec.build_tree(2, (2,))
    chunk = (lambda p, c, t, col: tm.verify_step(p, t, c, cfg, prefill_resume=True,
                                                 logit_cols=col))
    verify = (lambda p, c, t: tm.verify_step(p, t, c, cfg))
    tverify = (lambda p, c, t: tm.verify_step(p, t, c, cfg, tree=tree))
    compact = (lambda p, c, pos, sel, take: (None, tm.compact_tree_cache(c, pos, sel, take)))
    idx = torch.full((SLOTS,), base, dtype=torch.int64)
    for i in range(3):
        col = torch.from_numpy(rng.integers(0, 4, size=SLOTS).astype(np.int64))
        out.append(("chunk_verify", chunk, (toks(4), col), idx + 1 + i))
    for i in range(3):
        out.append(("verify", verify, (toks(3),), idx + 4 + i))
    n = tree.n_nodes
    pos = torch.full((SLOTS,), base + 7, dtype=torch.int64)
    for i in range(3):
        out.append(("tree_verify", tverify, (toks(n),), None))
        sel = torch.arange(n).repeat(SLOTS, 1)
        sel[:, 1] = torch.from_numpy(rng.integers(1, n, size=SLOTS))
        take = torch.from_numpy(rng.integers(0, 3, size=SLOTS).astype(np.int64))
        out.append(("compact", compact, (pos + i, sel, take), pos + i + take))
    return out


@pytest.mark.parametrize("kind", list(ARCHS))
def test_donated_steps_match_the_functional_step(kind):
    """Every tick through `StepGraphs` (warm-up, capture, replays) leaves the
    donated cache's leaves in their storage and equal to the functional
    step's (which rebinds its `idx`, and an SSM's `conv` and `state`), with
    equal outputs."""
    rng = np.random.default_rng(3)
    model, cfg = _model(kind)
    cache = _filled_cache(kind, model, cfg, rng)
    ref = clone_cache(cache)
    ptrs = tg.leaf_ptrs(cache)
    graphs = stub_graphs(cache)
    with torch.no_grad():
        for entry, fn, inputs, roll in _ticks(kind, model, cfg, rng):
            out, got = graphs(entry, fn, model, cache, *staged(graphs, entry, inputs))
            want, ref = fn(model, ref, *inputs)
            assert got is cache and tg.leaf_ptrs(cache) == ptrs, entry
            assert_out_equal(out, want)
            assert_caches_equal(cache, ref)
            if roll is not None:
                tm.rollback_cache(cache, roll)
                ref = tm.rollback_cache(ref, roll)
                assert tg.leaf_ptrs(cache) == ptrs
                assert_caches_equal(cache, ref)
    entries = {e for e, *_ in _ticks(kind, model, cfg, rng)}
    assert dict(graphs.captures) == {e: 1 for e in entries}
    assert all(graphs.replays[e] >= 1 for e in entries)


def test_write_back_copies_new_leaves_into_the_donated_ones():
    donated = [{"idx": torch.zeros(3, dtype=torch.int32), "k": torch.zeros(3, 4),
                "state": torch.zeros(3, 2)}]
    ptrs = tg.leaf_ptrs(donated)
    k = donated[0]["k"]
    k += 1                                   # a step writes the K/V in place
    new = [{"idx": donated[0]["idx"] + 5, "k": k, "state": torch.ones(3, 2) * 7}]
    assert tg.write_back(donated, new) is donated
    assert tg.leaf_ptrs(donated) == ptrs
    for key in new[0]:
        assert torch.equal(donated[0][key], new[0][key]), key
    with pytest.raises(ValueError, match="lacks"):
        tg.write_back(donated, [{"xk": torch.zeros(1)}])
    with pytest.raises(ValueError, match="came back"):
        tg.write_back(donated, [{"idx": torch.zeros(4, dtype=torch.int32)}])
    with pytest.raises(ValueError, match="layers"):
        tg.write_back(donated, [])


@pytest.mark.parametrize("routing", [dict(impl="lookup"), dict(fusion="unfused"),
                                     dict(impl="lookup", fusion="unfused")])
def test_graph_key_follows_routing_and_plan_generation(routing, monkeypatch, tmp_path):
    """The key holds the effective mpGeMM routing and the plan cache's
    generation: either changing is a new warm-up and capture."""
    monkeypatch.setattr(autotune, "_default_cache", autotune.PlanCache(str(tmp_path / "p.json")))
    cache = [{"idx": torch.zeros(2, dtype=torch.int32)}]
    graphs = stub_graphs(cache)

    def step(p, c, t):
        return t * 2, [dict(c[0], idx=c[0]["idx"] + 1)]

    x = (torch.ones(2),)
    base = graphs.key("decode", x)
    assert graphs.key("decode", (torch.ones(3),)) != base
    with ops.dispatch_override(**routing):
        assert graphs.key("decode", x) != base
    for _ in range(3):
        graphs("decode", step, None, cache, *x)
    with ops.dispatch_override(**routing):
        for _ in range(3):
            graphs("decode", step, None, cache, *x)
    assert graphs.captures["decode"] == 2
    autotune.default_cache().put("some-shape", {"bm": 64}, 1e-6)
    assert graphs.key("decode", x) != base
    for _ in range(2):
        graphs("decode", step, None, cache, *x)
    assert graphs.captures["decode"] == 3 and len(graphs.graphs) == 3
    assert int(cache[0]["idx"][0]) == 8


def test_launch_counts_are_replayed_exactly():
    """A replayed step counts the launches its capture recorded, once a
    replay: the totals equal those of the same calls made eagerly."""
    cache = [{"idx": torch.zeros(2, dtype=torch.int32)}]
    graphs = stub_graphs(cache)
    counted = (tdg.ternary_decode_gemm_fused, fa.flash_attention)
    saved = [fn.launches for fn in counted]

    def step(p, c, t):
        tdg.ternary_decode_gemm_fused.launches += 3
        fa.flash_attention.launches += 1
        return t + 1, [dict(c[0], idx=c[0]["idx"] + 1)]

    try:
        for fn in counted:
            fn.launches = 0
        for i in range(6):
            out, _ = graphs("decode", step, None, cache,
                            graphs.upload("x", torch.full((2,), float(i))))
            assert torch.equal(out, torch.full((2,), i + 1.0))
            assert tdg.ternary_decode_gemm_fused.launches == 3 * (i + 1)
            assert fa.flash_attention.launches == i + 1
        assert graphs.captures["decode"] == 1 and graphs.replays["decode"] == 5
        assert graphs.graphs[next(iter(graphs.graphs))].launches == {
            tdg.ternary_decode_gemm_fused: 3, fa.flash_attention: 1}
    finally:
        for fn, n in zip(counted, saved):
            fn.launches = n


@pytest.mark.parametrize("rebind", ["idx", "k"])
def test_a_rebound_leaf_fails_the_replay(rebind):
    cache = [{"idx": torch.zeros(2, dtype=torch.int32), "k": torch.zeros(2, 3)}]
    graphs = stub_graphs(cache)

    def step(p, c, t):
        c[0]["k"].add_(t[:, None])
        return None, [dict(c[0], idx=c[0]["idx"] + 1)]

    for _ in range(3):
        graphs("decode", step, None, cache, graphs.upload("x", torch.ones(2)))
    cache[0][rebind] = cache[0][rebind].clone()
    with pytest.raises(RuntimeError, match="storage differs"):
        graphs("decode", step, None, cache, graphs.upload("x", torch.ones(2)))


def test_an_unstaged_input_fails_the_replay():
    """A graph reads its inputs where it was captured: a replay given a
    tensor other than that buffer raises (the graph would read stale
    values); a staged one replays with the new values."""
    cache = [{"idx": torch.zeros(2, dtype=torch.int32)}]
    graphs = stub_graphs(cache)

    def step(p, c, t):
        return t * 2, [dict(c[0], idx=c[0]["idx"] + 1)]

    for i in range(3):
        out, _ = graphs("decode", step, None, cache, graphs.upload("x", torch.full((2,), i)))
        assert out.tolist() == [2 * i, 2 * i]
    with pytest.raises(RuntimeError, match="not the buffer"):
        graphs("decode", step, None, cache, torch.full((2,), 7))
    assert graphs.captures["decode"] == 1 and graphs.replays["decode"] == 2


def test_outputs_live_until_any_replay():
    """The graphs of one `StepGraphs` share a pool and replay in any order,
    so a replay of one key may overwrite another key's static outputs
    (here always: `aliasing_capture`). An output is valid until the next
    replay of any key, not only of its own."""
    cache = [{"idx": torch.zeros(2, dtype=torch.int32)}]
    graphs = stub_graphs(cache, capture=aliasing_capture)

    def step(scale):
        return lambda p, c, t: (t * scale, [dict(c[0], idx=c[0]["idx"] + 1)])

    x = graphs.upload("x", torch.ones(2))
    for _ in range(2):                          # the eager calls, the captures
        graphs("a", step(2.0), None, cache, x)
        graphs("b", step(3.0), None, cache, x)
    a, _ = graphs("a", step(2.0), None, cache, x)
    assert a.tolist() == [2.0, 2.0]
    graphs("b", step(3.0), None, cache, x)
    assert a.tolist() == [3.0, 3.0]             # overwritten by b's replay


def test_a_failed_capture_raises_and_counts_nothing():
    cache = [{"idx": torch.zeros(2, dtype=torch.int32)}]
    graphs = stub_graphs(cache)
    calls = [0]
    before = tdg.ternary_decode_gemm_fused.launches

    def step(p, c, t):
        calls[0] += 1
        tdg.ternary_decode_gemm_fused.launches += 1
        if calls[0] == 2:
            raise RuntimeError("operation not permitted when stream is capturing")
        return t, [c[0]]

    graphs("decode", step, None, cache, torch.ones(2))
    with pytest.raises(RuntimeError, match="capturing"):
        graphs("decode", step, None, cache, torch.ones(2))
    assert tdg.ternary_decode_gemm_fused.launches == before + 1
    assert not graphs.graphs and not graphs.captures
    tdg.ternary_decode_gemm_fused.launches = before


def test_cpu_never_captures_unless_given_a_capture():
    graphs = tg.StepGraphs("cpu")
    assert not graphs.enabled
    cache = [{"idx": torch.zeros(2, dtype=torch.int32)}]
    ptr = cache[0]["idx"].data_ptr()
    for _ in range(4):
        graphs("decode", lambda p, c, t: (t, [dict(c[0], idx=c[0]["idx"] + 1)]), None, cache,
               torch.ones(2))
    assert not graphs.captures and cache[0]["idx"].data_ptr() == ptr
    assert cache[0]["idx"].tolist() == [4, 4]
    assert not tg.StepGraphs("cpu", enabled=False, capture=stub_capture(list)).enabled


def test_rollback_writes_idx_in_place():
    cfg = tget_config("smollm-360m", smoke=True)
    cache = tm.init_cache(cfg, 3, 16, device="cpu")
    ptrs = tg.leaf_ptrs(cache)
    out = tm.rollback_cache(cache, torch.tensor([4, 5, 6]))
    assert out is cache and tg.leaf_ptrs(cache) == ptrs
    assert all(layer["idx"].tolist() == [4, 5, 6] for layer in cache)


# --------------------------------------------------------------------------
# engines: graphed (the stand-in) against eager
# --------------------------------------------------------------------------
def _graph_engine(eng, capture=stub_capture):
    """Give the engine (and its ModelDrafter) stand-in graphs."""
    drafter_cache = getattr(eng.drafter, "cache", None)
    caches = (eng.cache,) + ((drafter_cache,) if drafter_cache is not None else ())
    eng.graphs = stub_graphs(*caches, capture=capture)
    if hasattr(eng.drafter, "attach_graphs"):
        eng.drafter.attach_graphs(eng.graphs, prefix="drafter.")
    return eng


_STATS = ("prefill_tokens", "prefill_pad_tokens", "decode_tokens", "decode_steps",
          "chunk_steps", "spec_steps", "drafted_tokens", "accepted_tokens", "completed")
ENGINE_MODES = {
    "decode": ("smollm-360m", {}),
    "sampled": ("smollm-360m", dict(temperature=0.7)),
    "chunk_chain": ("smollm-360m", dict(prefill_chunk=8, spec=dict(k=2))),
    "tree": ("smollm-360m", dict(spec=dict(k=2, tree=(2,)))),
    "paged_chunk_tree": ("smollm-360m", dict(prefill_chunk=8, spec=dict(k=2, tree=(2,)),
                                             paged_kv=ts.PagedKVConfig(page_size=PS))),
    "model_drafter": ("smollm-360m", dict(spec=dict(k=2, drafter="model"))),
    "mla_chunk_chain": ("deepseek-v3-671b", dict(prefill_chunk=8, spec=dict(k=2))),
    "ssm": ("mamba2-1.3b", {}),
    "ring": ("gemma3-1b", {}),
}


def _serve(model, cfg, kw, prompts, graphed, capture=stub_capture):
    kw = dict(kw)
    if "spec" in kw:
        extra = dict(draft_params=model, draft_cfg=cfg) if kw["spec"].get("drafter") else {}
        kw["spec"] = tspec.SpecConfig(**kw["spec"], **extra)
    eng = ts.Engine(model, cfg, max_slots=SLOTS, max_len=MAX_LEN, seed=5, device="cpu", **kw)
    if graphed:
        _graph_engine(eng, capture)
    caches = (eng.cache,) + ((eng.drafter.cache,) if hasattr(eng.drafter, "cache") else ())
    ptrs = [tg.leaf_ptrs(c) for c in caches]
    sched = ts.ContinuousBatchingScheduler(eng)
    reqs = [ts.Request(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
    sched.submit(reqs)
    stats = sched.run_to_completion()
    assert [tg.leaf_ptrs(c) for c in caches] == ptrs
    return [r.generated for r in reqs], {f: getattr(stats, f) for f in _STATS}, eng


@pytest.mark.parametrize("mode", list(ENGINE_MODES))
def test_graphed_engine_matches_eager(mode):
    """The same seeded requests through an engine whose steps replay (the
    stand-in) and an eager one: identical tokens (greedy and sampled) and
    counters; the caches keep their storage through both runs."""
    arch, kw = ENGINE_MODES[mode]
    cfg = tget_config(arch, smoke=True).with_(dtype="float32")
    model = tm.pack_params(tm.init_lm(cfg, torch.Generator().manual_seed(0)), cfg)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in (5, 12, 9, 17)]
    eager_tok, eager_stats, _ = _serve(model, cfg, kw, prompts, graphed=False)
    tok, stats, eng = _serve(model, cfg, kw, prompts, graphed=True)
    assert tok == eager_tok and stats == eager_stats
    assert eng.graphs.captures and sum(eng.graphs.replays.values()) > 0
    assert max(eng.graphs.captures.values()) == 1


@pytest.mark.parametrize("mode", ["chunk_chain", "paged_chunk_tree", "model_drafter",
                                  "mla_chunk_chain"])
def test_engine_consumes_outputs_before_the_next_replay(mode):
    """With every graph's outputs in one storage (`aliasing_capture`), the
    engine and its ModelDrafter still emit the eager tokens: each step's
    output is read (in stream order) before the next replay of any key."""
    arch, kw = ENGINE_MODES[mode]
    cfg = tget_config(arch, smoke=True).with_(dtype="float32")
    model = tm.pack_params(tm.init_lm(cfg, torch.Generator().manual_seed(0)), cfg)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in (7, 11, 16, 4)]
    eager_tok, eager_stats, _ = _serve(model, cfg, kw, prompts, graphed=False)
    tok, stats, eng = _serve(model, cfg, kw, prompts, graphed=True, capture=aliasing_capture)
    assert tok == eager_tok and stats == eager_stats
    assert len(eng.graphs.graphs) >= 2 and sum(eng.graphs.replays.values()) > 0


def test_graphed_engine_matches_jax():
    """The slice as a whole: the dense smoke engine with replayed steps
    against the JAX engine (its jitted, donated steps), greedy tokens."""
    jcfg = jget_config("smollm-360m", smoke=True).with_(dtype="float32")
    tcfg = tget_config("smollm-360m", smoke=True).with_(dtype="float32")
    params = jm.pack_params(jm.init_lm(jax.random.PRNGKey(0), jcfg), jcfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab, size=n).astype(np.int32) for n in (5, 13, 20)]
    jeng = js.Engine(params, jcfg, max_slots=SLOTS, max_len=MAX_LEN)
    jsched = js.ContinuousBatchingScheduler(jeng)
    jreqs = [js.Request(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
    jsched.submit(jreqs)
    jsched.run_to_completion()
    model = bridge.lm_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    tok, _, eng = _serve(model, tcfg, {}, prompts, graphed=True)
    assert tok == [r.generated for r in jreqs]
    assert eng.graphs.captures["decode"] == 1 and eng.graphs.replays["decode"] > 0


def test_compile_guard_fails_on_a_second_capture():
    """`guard_entries` counts each step entry's captures: steady ticks
    after the warm-up and the capture grow nothing; a key captured again
    fails the guard."""
    cfg = tget_config("smollm-360m", smoke=True).with_(dtype="float32")
    model = tm.pack_params(tm.init_lm(cfg, torch.Generator().manual_seed(0)), cfg)
    eng = _graph_engine(ts.Engine(model, cfg, max_slots=SLOTS, max_len=MAX_LEN, device="cpu"))
    probes = tlint.guard_entries(eng)
    assert "capture.decode" in probes
    rng = np.random.default_rng(2)
    for i in range(SLOTS):
        eng.add(ts.Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=6).astype(np.int32),
                           max_new_tokens=12))
    guard = tlint.CompileGuard(probes)
    eng.step()
    eng.step()                                  # warm-up, then the capture
    guard.arm()
    for _ in range(3):
        eng.step()
    guard.assert_steady()
    eng.graphs.clear()
    eng.step()
    eng.step()                                  # the same key captured again
    assert guard.new_compiles() == {"capture.decode": 1}
    with pytest.raises(AssertionError, match="capture.decode"):
        guard.assert_steady()
