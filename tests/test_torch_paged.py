"""The paged KV cache in repro_torch against the JAX package (the GQA cases
of tests/test_paged_kv.py): the host pager (`serve.paging`, a copy of the
JAX module) takes the same decisions as `repro.serve.paging.Pager`; the
device primitives (`models.paged`) agree with `repro.models.paged` bit for
bit and never write the null page 0; and the paged engine emits the JAX
paged engine's greedy tokens with the same counters, on bridged weights of
the smollm-360m smoke config in f32.

The port's pools carry one extra sink page at index n_pages where JAX's
scatter drops writes (`mode="drop"`), so a JAX pool compares with the
port's pool minus its last page.

Against the port's dense engine the paged engine may differ only at a
near-tie, as chunked serving may (tests/test_torch_chunked.py): paged
admission attends the prompt's K/V read back from the bf16 cache, where
whole-prompt prefill attends its own f32 K/V."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import models as jm  # noqa: E402
from repro import serve as js  # noqa: E402
from repro import spec as jspec  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import uniform_layers as juniform_layers  # noqa: E402
from repro.models import paged as jpaged  # noqa: E402
from repro.serve import paging as jpaging  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch import serve as ts  # noqa: E402
from repro_torch import spec as tspec  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.configs import uniform_layers  # noqa: E402
from repro_torch.models import paged as tpaged  # noqa: E402
from repro_torch.serve import paging as tpaging  # noqa: E402

#: a greedy divergence between paged and dense whole-prompt serving is
#: allowed only where the dense logits of the two tokens are within this
#: fraction of the largest logit (bf16 rounding of K/V, as in
#: tests/test_torch_chunked.py)
TIE_RTOL = 1e-2
DTYPE = "float32"
_STATS = ("prefill_tokens", "prefill_pad_tokens", "decode_tokens", "decode_steps", "chunk_steps",
          "spec_steps", "spec_slot_steps", "spec_skipped_steps", "drafted_tokens",
          "accepted_tokens", "verified_nodes", "completed", "rejected",
          "prefix_hit_tokens", "prefix_hit_requests")
_PAGER_COUNTERS = ("prefix_hit_tokens", "prefix_hit_requests", "pages_paged_out",
                   "pages_paged_in", "pages_dropped", "free_pages", "shared_pages",
                   "offloaded_pages")


@pytest.fixture(scope="module")
def served():
    jcfg = jget_config("smollm-360m", smoke=True).with_(dtype=DTYPE)
    tcfg = tget_config("smollm-360m", smoke=True).with_(dtype=DTYPE)
    params = jm.pack_params(jm.init_lm(jax.random.PRNGKey(0), jcfg), jcfg)
    return jcfg, tcfg, params, jax.tree.map(np.asarray, params)


def _model(served):
    return bridge.lm_from_jax(served[3], served[1], device="cpu")


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def _run(pkg, eng, prompts, max_new):
    sched = pkg.ContinuousBatchingScheduler(eng)
    reqs = [pkg.Request(rid=i, prompt=p.copy(), max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    sched.submit(reqs)
    return [r.generated for r in reqs], sched.run_to_completion()


def _null_page_untouched(eng):
    """Page 0 (the shared null page) still holds its initial content."""
    for layer in eng.cache:
        assert not bool(layer["k"][0].any()) and not bool(layer["v"][0].any())
        assert bool((layer["slot_pos"][0] == -1).all())


def port_run(served, prompts, *, max_new=6, slots=3, max_len=96, spec=None, paged=None, **kw):
    """The port's engine alone (paged when `paged` holds PagedKVConfig
    keywords). → (tokens, stats, engine)."""
    eng = ts.Engine(_model(served), served[1], max_slots=slots, max_len=max_len,
                    spec=None if spec is None else tspec.SpecConfig(**spec),
                    paged_kv=None if paged is None else ts.PagedKVConfig(**paged),
                    device="cpu", **kw)
    return (*_run(ts, eng, prompts, max_new), eng)


def paged_pair(served, prompts, *, paged, max_new=6, slots=3, max_len=96, spec=None, **kw):
    """The port's paged engine against the JAX paged engine (same tokens,
    counters and pager counts) and the port's dense whole-prompt engine
    (same tokens up to a near-tie). → the port's (tokens, stats, engine)."""
    jcfg, _, params, _ = served
    jeng = js.Engine(params, jcfg, max_slots=slots, max_len=max_len,
                     spec=None if spec is None else jspec.SpecConfig(**spec),
                     paged_kv=js.PagedKVConfig(**paged), **kw)
    jg, jst = _run(js, jeng, prompts, max_new)
    got, stats, eng = port_run(served, prompts, max_new=max_new, slots=slots, max_len=max_len,
                               spec=spec, paged=paged, **kw)
    assert got == jg
    for f in _STATS:
        assert getattr(stats, f) == getattr(jst, f), f
    for f in _PAGER_COUNTERS:
        assert getattr(eng.pager, f) == getattr(jeng.pager, f), f
    np.testing.assert_array_equal(eng.pager.pool.refs, jeng.pager.pool.refs)
    _null_page_untouched(eng)
    base, _, _ = port_run(served, prompts, max_new=max_new, slots=slots, max_len=max_len)
    assert_same_or_near_tie(served, prompts, got, base, max_len)
    return got, stats, eng


def assert_same_or_near_tie(served, prompts, got, base, max_len):
    """`got` equals the dense whole-prompt tokens `base`, or each request's
    first divergent token is a near-tie of the dense logits there."""
    tcfg = served[1]
    model = _model(served)
    for prompt, g, b in zip(prompts, got, base):
        if g == b:
            continue
        t = next(i for i, (x, y) in enumerate(zip(g, b)) if x != y)
        cache = tm.init_cache(tcfg, 1, max_len, device="cpu")
        with torch.no_grad():
            logits, cache, _ = tm.prefill_into_slot(model, cache, 0, prompt, tcfg,
                                                    max_len=max_len)
            for tok in b[:t]:
                logits, cache = tm.decode_step(model, torch.tensor([[tok]], dtype=torch.int32),
                                               cache, tcfg)
        row = logits[0]
        assert int(torch.argmax(row)) == b[t]
        gap = float(row[b[t]] - row[g[t]])
        assert gap <= TIE_RTOL * float(row.abs().max()), (t, b[t], g[t], gap)


# --------------------------------------------------------------------------
# Host-side pager (no model): the JAX module's cases, then decision parity
# --------------------------------------------------------------------------
class TestPagePool:
    def test_null_page_never_allocated(self):
        pool = tpaging.PagePool(4)
        got = {pool.alloc() for _ in range(3)}
        assert got == {1, 2, 3}
        assert pool.alloc() is None

    def test_refcounted_release(self):
        pool = tpaging.PagePool(3)
        p = pool.alloc()
        pool.retain(p)
        assert not pool.release(p)
        assert pool.release(p)
        assert pool.free_pages == 2


class TestPagerAdmission:
    def _pager(self, n_pages=9, ps=4, **kw):
        cfg = tpaging.PagedKVConfig(page_size=ps, n_pages=n_pages, **kw)
        return tpaging.Pager(cfg, max_slots=2, max_len=32, n_pages=n_pages)

    def test_reserves_full_budget(self):
        pager = self._pager()
        pager.admit(0, np.arange(6), need_tokens=10)
        assert pager.free_pages == 8 - 3
        assert len(pager.slot_pages[0]) == 3

    def test_out_of_pages_rolls_back(self):
        pager = self._pager(n_pages=3)
        with pytest.raises(tpaging.OutOfPages, match="page pool exhausted"):
            pager.admit(0, np.arange(8), need_tokens=12)
        assert pager.free_pages == 2
        assert pager.slot_pages[0] == []

    def test_release_feeds_prefix_index_and_rehit(self):
        pager = self._pager()
        prompt = np.arange(11)
        pager.admit(0, prompt, need_tokens=14)
        pager.release(0, prompt)
        assert pager.shared_pages == 2
        assert pager.free_pages == 8 - 2
        assert pager.admit(1, prompt, need_tokens=14) == 8
        assert pager.prefix_hit_tokens == 8
        assert pager.prefix_hit_requests == 1
        assert pager.slot_shared[1] == 2

    def test_match_capped_below_full_prompt(self):
        pager = self._pager()
        prompt = np.arange(8)
        pager.admit(0, prompt, need_tokens=8)
        pager.release(0, prompt)
        assert pager.admit(1, prompt, need_tokens=8) == 4
        assert len(pager.slot_pages[1]) == 2

    def test_prefix_sharing_off(self):
        pager = self._pager(prefix_sharing=False)
        prompt = np.arange(11)
        pager.admit(0, prompt, need_tokens=12)
        pager.release(0, prompt)
        assert pager.shared_pages == 0
        assert pager.free_pages == 8
        assert pager.admit(1, prompt, need_tokens=12) == 0

    def test_cow_fork_shares_only_full_common_pages(self):
        pager = self._pager()
        p1 = np.arange(12)
        p2 = np.concatenate([np.arange(6), 90 + np.arange(6)])
        pager.admit(0, p1, need_tokens=12)
        pager.release(0, p1)
        assert pager.admit(1, p2, need_tokens=12) == 4
        assert pager.pool.refs[pager.slot_pages[1][0]] == 2

    def test_eviction_drops_cold_leaves_first(self):
        pager = self._pager(n_pages=5)
        prompt = np.arange(11)
        pager.admit(0, prompt, need_tokens=14)
        pager.release(0, prompt)
        pager.admit(1, 50 + np.arange(8), need_tokens=14)
        assert pager.pages_dropped == 2
        assert pager.shared_pages == 0

    def test_offload_tier_pages_out_and_back_in(self):
        store, calls = {}, {"out": 0, "in": 0}

        def page_out(page):
            calls["out"] += 1
            return f"kv@{page}"

        def page_in(page, data):
            calls["in"] += 1
            store[page] = data

        cfg = tpaging.PagedKVConfig(page_size=4, n_pages=5, host_offload_pages=8)
        pager = tpaging.Pager(cfg, max_slots=2, max_len=32, n_pages=5,
                              page_out=page_out, page_in=page_in)
        prompt = np.arange(11)
        pager.admit(0, prompt, need_tokens=14)
        pager.release(0, prompt)
        pager.admit(1, 50 + np.arange(8), need_tokens=14)
        assert calls["out"] == 2 and pager.offloaded_pages == 2
        assert pager.pages_paged_out == 2
        pager.release(1, 50 + np.arange(8))
        assert pager.admit(0, prompt, need_tokens=14) == 8 and calls["in"] == 2
        assert pager.pages_paged_in == 2 and pager.offloaded_pages == 2
        assert pager.pages_paged_out == 4

    def test_radix_walk_stops_at_first_miss(self):
        idx = tpaging.RadixPrefixIndex(4)
        n1 = idx.insert(idx.root, (0, 1, 2, 3))
        n1.page = 1
        n2 = idx.insert(n1, (4, 5, 6, 7))
        n2.page = 2
        assert [n.page for n in idx.walk(np.array([0, 1, 2, 3, 9, 9, 9, 9]), 8)] == [1]
        assert [n.page for n in idx.walk(np.arange(8), 8)] == [1, 2]
        assert list(idx.walk(np.arange(8), 7)) == [n1]


def _pager_trace(mod, cfg_kw, ops, *, max_slots, max_len, n_pages):
    """Drive one pager module through `ops` ((\"admit\", slot, prompt, need)
    or (\"release\", slot, prompt)) and record, after each op, everything
    it decided: the result, block tables, fresh pages (take_flush), the
    refcounts, the free list, the page-out/in callbacks, every counter."""
    events = []
    pager = mod.Pager(mod.PagedKVConfig(**cfg_kw), max_slots=max_slots, max_len=max_len,
                      n_pages=n_pages,
                      page_out=lambda page: events.append(("out", page)) or page,
                      page_in=lambda page, data: events.append(("in", page, data)))
    trace = []
    for op in ops:
        if op[0] == "admit":
            try:
                res = pager.admit(op[1], op[2], op[3])
            except mod.OutOfPages as e:
                res = ("OutOfPages", str(e))
        else:
            res = pager.release(op[1], op[2])
        tab, fresh = pager.take_flush()
        trace.append((res, tab.tolist(), list(fresh), pager.pool.refs.tolist(),
                      list(pager.pool.free), list(pager.slot_shared), list(events),
                      [getattr(pager, f) for f in _PAGER_COUNTERS]))
    return trace


def _random_ops(seed, *, max_slots, max_len, ps, n_ops=60):
    """A seeded admit/release sequence over prompts drawn from a few shared
    prefixes (so the radix index hits, forks mid-page and evicts)."""
    rng = np.random.default_rng(seed)
    stems = [rng.integers(0, 7, size=max_len) for _ in range(3)]
    live: dict = {}
    ops = []
    for _ in range(n_ops):
        free = [s for s in range(max_slots) if s not in live]
        if free and (not live or rng.random() < 0.6):
            slot = int(rng.choice(free))
            n = int(rng.integers(1, max_len // 2))
            prompt = stems[int(rng.integers(0, 3))][:n].copy()
            if rng.random() < 0.3:
                prompt[int(rng.integers(0, n)):] = 9       # fork anywhere, mid-page too
            need = min(max_len, n + int(rng.integers(0, max_len // 2)))
            ops.append(("admit", slot, prompt, need))
            live[slot] = prompt
        else:
            slot = int(rng.choice(sorted(live)))
            ops.append(("release", slot, live.pop(slot)))
    return ops


class TestPagerParity:
    @pytest.mark.parametrize("seed", range(4))
    @pytest.mark.parametrize("cfg_kw", [
        dict(page_size=4),
        dict(page_size=4, prefix_sharing=False),
        dict(page_size=4, host_offload_pages=3),
        dict(page_size=8, host_offload_pages=64),
    ], ids=["share", "noshare", "offload3", "offload64"])
    def test_same_decisions_as_jax(self, cfg_kw, seed):
        """Tables, fresh pages, refcounts, free list, eviction and offload
        order and every counter equal the JAX pager's after each op; an
        admission refused for pages is refused by both with the same text.
        The pool is small, so admissions evict, offload and run dry."""
        kw = dict(max_slots=3, max_len=32, n_pages=9)
        ops = _random_ops(seed, max_slots=3, max_len=32, ps=cfg_kw["page_size"])
        got = _pager_trace(tpaging, cfg_kw, ops, **kw)
        want = _pager_trace(jpaging, cfg_kw, ops, **kw)
        assert got == want
        results = [t[0] for t in got]
        counts = dict(zip(_PAGER_COUNTERS, got[-1][-1]))
        # the pool ran dry or evicted to the host; with sharing, some hit
        assert any(isinstance(r, tuple) for r in results) or counts["pages_paged_out"]
        if cfg_kw.get("prefix_sharing", True):
            assert any(isinstance(r, int) and r > 0 for r in results)
        if cfg_kw.get("host_offload_pages"):
            assert counts["pages_paged_in"] > 0


# --------------------------------------------------------------------------
# Device primitives against repro.models.paged, bit for bit
# --------------------------------------------------------------------------
B, CAP, PS, N_PAGES, KV, HD = 3, 4, 4, 7, 2, 5


def _tab(rng):
    """A block table with unmapped (0) entries; page numbers 1..N_PAGES-1."""
    tab = rng.integers(1, N_PAGES, size=(B, CAP)).astype(np.int32)
    tab[rng.random((B, CAP)) < 0.3] = 0
    return tab


def _slots(rng, s=9):
    """Logical indices with negatives and out-of-range ones mixed in."""
    return rng.integers(-3, CAP * PS + 4, size=(B, s)).astype(np.int32)


def _with_sink(pool: np.ndarray) -> torch.Tensor:
    """The port's pool: the JAX pool plus a sink page at index N_PAGES."""
    return torch.from_numpy(np.concatenate([pool, pool[:1]]))


class TestPagedPrimitives:
    @pytest.mark.parametrize("for_write", [True, False])
    def test_page_phys(self, for_write):
        rng = np.random.default_rng(0)
        tab, slots = _tab(rng), _slots(rng)
        pg, off = tpaged.page_phys(torch.from_numpy(tab), torch.from_numpy(slots), PS, N_PAGES,
                                   for_write=for_write)
        jpg, joff = jpaged.page_phys(jnp.asarray(tab), jnp.asarray(slots), PS, N_PAGES,
                                     for_write=for_write)
        np.testing.assert_array_equal(pg.numpy(), np.asarray(jpg))
        np.testing.assert_array_equal(off.numpy(), np.asarray(joff))

    @pytest.mark.parametrize("seed", range(3))
    def test_scatter_drops_unmapped_and_spares_page0(self, seed):
        rng = np.random.default_rng(seed)
        tab = _tab(rng)
        # distinct logical targets per row: at most one write per location
        slots = np.stack([rng.permutation(np.arange(-3, CAP * PS + 4))[:9]
                          for _ in range(B)]).astype(np.int32)
        # rows own disjoint pages, as the pager allocates them
        tab = np.where(tab > 0, (np.arange(B)[:, None] * 2 + tab % 2 + 1), 0).astype(np.int32)
        pool = rng.standard_normal((N_PAGES, PS, KV, HD)).astype(np.float32)
        vals = rng.standard_normal((B, 9, KV, HD)).astype(np.float32)
        got = tpaged.page_scatter(_with_sink(pool), torch.from_numpy(tab),
                                  torch.from_numpy(slots), torch.from_numpy(vals))
        want = jpaged.page_scatter(jnp.asarray(pool), jnp.asarray(tab), jnp.asarray(slots),
                                   jnp.asarray(vals))
        np.testing.assert_array_equal(got[:N_PAGES].numpy(), np.asarray(want))
        np.testing.assert_array_equal(got[0].numpy(), pool[0])
        assert not np.array_equal(got[1:N_PAGES].numpy(), pool[1:])   # some writes landed

    def test_page_view(self):
        rng = np.random.default_rng(1)
        tab = _tab(rng)
        pool = rng.standard_normal((N_PAGES, PS, KV, HD)).astype(np.float32)
        sp = rng.integers(-1, 50, size=(N_PAGES, PS)).astype(np.int32)
        for p in (pool, sp):
            got = tpaged.page_view(_with_sink(p), torch.from_numpy(tab))
            want = jpaged.page_view(jnp.asarray(p), jnp.asarray(tab))
            assert tuple(got.shape) == (B, CAP * PS) + p.shape[2:]
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def _caches(self, served, rng, batch=B, max_len=CAP * PS):
        """The same random paged cache in both layouts: JAX stacked over
        layer reps, the port one dict per layer (plus the sink page)."""
        jcfg, tcfg = served[0], served[1]
        jc = jm.init_cache(jcfg, batch, max_len, jnp.float32, page_size=PS, n_pages=N_PAGES)
        tc = tm.init_cache(tcfg, batch, max_len, torch.float32, device="cpu", page_size=PS,
                           n_pages=N_PAGES)
        (bname, bd), = jc[0].items()
        new = dict(bd)
        for key in ("k", "v", "slot_pos"):
            shape = bd[key].shape
            if key == "slot_pos":
                arr = rng.integers(-1, 40, size=shape).astype(np.int32)
                arr[:, 0] = -1                       # the null page's invariant
            else:
                arr = rng.standard_normal(shape).astype(np.float32)
                arr[:, 0] = 0.0
            new[key] = jnp.asarray(arr)
            for i, layer in enumerate(tc):
                layer[key][:N_PAGES] = torch.from_numpy(arr[i])
        tab = _tab(rng)
        new["tab"] = jnp.broadcast_to(jnp.asarray(tab), bd["tab"].shape)
        tm.set_block_tables(tc, torch.from_numpy(tab))
        return [{bname: new}], tc, bname

    def _assert_same(self, jc, tc, bname):
        for i, layer in enumerate(tc):
            for key in ("k", "v", "slot_pos"):
                np.testing.assert_array_equal(layer[key][:N_PAGES].numpy(),
                                              np.asarray(jc[0][bname][key][i]), err_msg=key)
            np.testing.assert_array_equal(layer["tab"].numpy(), np.asarray(jc[0][bname]["tab"][i]))

    def test_one_table_shared_by_every_layer(self, served):
        tc = tm.init_cache(served[1], B, CAP * PS, device="cpu", page_size=PS, n_pages=N_PAGES)
        assert len({id(layer["tab"]) for layer in tc}) == 1
        tab = tc[0]["tab"]
        tm.set_block_tables(tc, torch.ones((B, CAP), dtype=torch.int32))
        rolled = tm.rollback_cache(tc, torch.tensor([1, 2, 3]))
        assert all(layer["tab"] is tab for layer in rolled) and bool((tab == 1).all())
        assert tuple(tc[0]["k"].shape) == (N_PAGES + 1, PS) + tuple(tc[0]["k"].shape[2:])

    def test_scrub_pages_with_sentinels(self, served):
        rng = np.random.default_rng(2)
        jc, tc, bname = self._caches(served, rng)
        pages = np.array([3, 5, N_PAGES, N_PAGES], np.int32)     # padded with sentinels
        jc = jpaged.scrub_pages(jc, jnp.asarray(pages))
        tm.scrub_pages(tc, torch.from_numpy(pages))
        self._assert_same(jc, tc, bname)
        assert bool((tc[0]["slot_pos"][[3, 5]] == -1).all())

    @pytest.mark.parametrize("seed", range(3))
    def test_compact_paged_block(self, served, seed):
        """A tree window's compaction through the table: rows straddle page
        edges, unmapped entries and the table's end; page 0 stays as is."""
        rng = np.random.default_rng(seed)
        jc, tc, bname = self._caches(served, rng)
        n = 6
        pos = rng.integers(0, CAP * PS - 2, size=B).astype(np.int32)
        sel = np.tile(np.arange(n), (B, 1))
        sel[:, 1:3] = rng.integers(1, n, size=(B, 2))
        take = rng.integers(0, n + 1, size=B).astype(np.int32)
        src = pos[:, None] + sel
        dst = pos[:, None] + np.arange(n)[None, :]
        live = np.arange(n)[None, :] < take[:, None]
        want = jpaged.compact_paged_block(jc[0][bname], jnp.asarray(src), jnp.asarray(dst),
                                          jnp.asarray(live))
        for layer in tc:
            tm.compact_paged_block(layer, torch.from_numpy(src), torch.from_numpy(dst),
                                   torch.from_numpy(live))
        self._assert_same([{bname: want}], tc, bname)
        for layer in tc:
            assert bool((layer["slot_pos"][0] == -1).all()) and not bool(layer["k"][0].any())

    def test_compact_tree_cache_routes_paged_layers(self, served):
        rng = np.random.default_rng(3)
        jc, tc, bname = self._caches(served, rng)
        pos = np.array([0, 5, 13], np.int32)
        sel = np.array([[0, 2, 1, 3], [0, 1, 2, 3], [0, 3, 2, 1]], np.int32)
        take = np.array([3, 4, 2], np.int32)
        want = jm.compact_tree_cache(jc, jnp.asarray(pos), jnp.asarray(sel), jnp.asarray(take))
        tm.compact_tree_cache(tc, torch.from_numpy(pos), torch.from_numpy(sel),
                              torch.from_numpy(take))
        self._assert_same(want, tc, bname)

    def test_gather_restore_round_trip(self, served):
        rng = np.random.default_rng(4)
        jc, tc, bname = self._caches(served, rng)
        data = tm.gather_page(tc, 3)
        jdata = jpaged.gather_page(jc, 3)[0][bname]
        assert sorted(data) == ["k", "slot_pos", "v"]
        for key, host in data.items():
            assert host.device.type == "cpu"
            np.testing.assert_array_equal(host.numpy(), np.asarray(jdata[key]))
        before = [{k: v.clone() for k, v in layer.items()} for layer in tc]
        for layer in tc:                      # the page is recycled meanwhile
            layer["k"][3] = 7.0
            # lint: disable=R1 -- page 3 of a CPU test pool
            layer["slot_pos"][3] = 99
        tm.restore_page(tc, 5, data)          # paged back in elsewhere
        jc = jpaged.restore_page(jc, 5, jpaged.gather_page(jc, 3))
        for layer, old in zip(tc, before):
            for key in ("k", "v", "slot_pos"):
                np.testing.assert_array_equal(layer[key][5].numpy(), old[key][3].numpy())
                np.testing.assert_array_equal(layer[key][N_PAGES].numpy(),
                                              old[key][N_PAGES].numpy())   # sink untouched
        for i, layer in enumerate(tc):
            np.testing.assert_array_equal(layer["v"][5].numpy(),
                                          np.asarray(jc[0][bname]["v"][i, 5]))

    def test_init_cache_validation(self, served):
        with pytest.raises(ValueError, match="multiple of page_size"):
            tm.init_cache(served[1], 2, 60, device="cpu", page_size=16, n_pages=9)
        with pytest.raises(ValueError, match="n_pages"):
            tm.init_cache(served[1], 2, 64, device="cpu", page_size=16, n_pages=1)


# --------------------------------------------------------------------------
# Engine admission semantics (chunked claims: no forward pass)
# --------------------------------------------------------------------------
class TestPagedEngineAdmission:
    def test_out_of_pages_defers_exceeds_context_rejects(self, served):
        eng = ts.Engine(None, served[1], max_slots=2, max_len=64, prefill_chunk=16, device="cpu",
                        paged_kv=ts.PagedKVConfig(page_size=16, n_pages=3, prefix_sharing=False))
        ok = ts.Request(rid=0, prompt=np.arange(20, dtype=np.int32), max_new_tokens=8)
        assert eng.add(ok) and ok.error == ""
        starved = ts.Request(rid=1, prompt=np.arange(20, dtype=np.int32), max_new_tokens=8)
        assert not eng.add(starved)
        assert "waiting for free KV pages" in starved.error and "exhausted" in starved.error
        with pytest.raises(ValueError, match="model context"):
            eng.add(ts.Request(rid=2, prompt=np.arange(60, dtype=np.int32), max_new_tokens=8))
        with pytest.raises(ValueError, match="allocatable pages"):
            eng.add(ts.Request(rid=3, prompt=np.arange(40, dtype=np.int32), max_new_tokens=8))

    def test_queue_for_pages_clears_error_on_retry(self, served):
        eng = ts.Engine(None, served[1], max_slots=2, max_len=64, prefill_chunk=16, device="cpu",
                        paged_kv=ts.PagedKVConfig(page_size=16, n_pages=4, prefix_sharing=False))
        a = ts.Request(rid=0, prompt=np.arange(20, dtype=np.int32), max_new_tokens=8)
        b = ts.Request(rid=1, prompt=np.arange(20, dtype=np.int32), max_new_tokens=8)
        assert eng.add(a) and not eng.add(b)
        assert "waiting for free KV pages" in b.error
        del eng.prefilling[a.slot]
        eng.slot_free[a.slot] = True           # lint: disable=R1 -- the engine's host list
        eng.pager.release(a.slot, a.prompt)
        assert eng.add(b) and b.error == ""

    def test_reservation_and_flush(self, served):
        """Admission reserves prompt + max_new - 1 positions of pages, and
        the flush puts the slot's pages in the shared table, scrubbed."""
        eng = ts.Engine(None, served[1], max_slots=1, max_len=64, prefill_chunk=16, device="cpu",
                        paged_kv=ts.PagedKVConfig(page_size=16, prefix_sharing=False))
        for layer in eng.cache:
            # lint: disable=R1 -- a CPU test pool's pages, in bounds
            layer["slot_pos"][1:] = 5                  # a previous owner's positions
        assert eng.add(ts.Request(rid=0, prompt=np.arange(17, dtype=np.int32),
                                  max_new_tokens=16))
        pages = eng.pager.slot_pages[0]
        assert len(pages) == 2                         # 17 + 16 - 1 = 32 positions
        np.testing.assert_array_equal(eng.cache[0]["tab"].numpy(), [pages + [0, 0]])
        for layer in eng.cache:
            assert bool((layer["slot_pos"][pages] == -1).all())
            assert bool((layer["slot_pos"][[p for p in range(1, 5) if p not in pages]] == 5).all())

    def test_refusals_match_jax(self, served):
        """Windowed (ring) and SSM layers are genuinely non-pageable; the
        port refuses them with the JAX engine's texts."""
        jcfg, tcfg = served[0], served[1]
        paged = dict(page_size=16)
        for kw in (dict(window=8), dict(mixer="ssm")):
            tc = dataclasses.replace(tcfg, layers=uniform_layers(2, **kw))
            jc = dataclasses.replace(jcfg, layers=juniform_layers(2, **kw))
            with pytest.raises(ValueError, match="window" if "window" in kw else "ssm") as te:
                ts.Engine(None, tc, max_slots=1, max_len=64, device="cpu",
                          paged_kv=ts.PagedKVConfig(**paged))
            with pytest.raises(ValueError) as je:
                js.Engine(None, jc, max_slots=1, max_len=64, paged_kv=js.PagedKVConfig(**paged))
            assert str(te.value) == str(je.value)

    @pytest.mark.parametrize("max_len,paged,match", [
        (60, dict(page_size=16), "multiple of page_size"),
        (64, dict(page_size=16, n_pages=1), "n_pages"),
    ])
    def test_knob_validation(self, served, max_len, paged, match):
        with pytest.raises(ValueError, match=match) as te:
            ts.Engine(None, served[1], max_len=max_len, device="cpu",
                      paged_kv=ts.PagedKVConfig(**paged))
        with pytest.raises(ValueError) as je:
            js.Engine(None, served[0], max_len=max_len, paged_kv=js.PagedKVConfig(**paged))
        assert str(te.value) == str(je.value)


# --------------------------------------------------------------------------
# Greedy token identity: the port's paged engine == the JAX paged engine
# --------------------------------------------------------------------------
LENS = (7, 19, 34, 4, 25)
PAGED = dict(page_size=8)


class TestPagedExactness:
    def test_whole_prompt(self, served):
        _, stats, _ = paged_pair(served, _prompts(served[0].vocab, LENS), paged=PAGED)
        assert stats.prefill_tokens == sum(LENS)

    def test_chunked(self, served):
        _, stats, _ = paged_pair(served, _prompts(served[0].vocab, LENS), paged=PAGED,
                                 prefill_chunk=16)
        assert stats.chunk_steps > 0

    @pytest.mark.parametrize("spec", [dict(k=3), dict(k=3, adaptive_k=True),
                                      dict(k=3, tree=(2, 2))],
                             ids=["chain", "adaptive", "tree"])
    def test_spec_modes(self, served, spec):
        _, stats, _ = paged_pair(served, _prompts(served[0].vocab, LENS), paged=PAGED, spec=spec)
        assert stats.spec_steps > 0

    def test_chunked_chain(self, served):
        _, stats, _ = paged_pair(served, _prompts(served[0].vocab, LENS), paged=PAGED,
                                 prefill_chunk=16, spec=dict(k=3))
        assert stats.spec_steps > 0 and stats.chunk_steps > 0

    def test_page_recycling_stays_exact(self, served):
        """One slot and a minimal pool: every admission reuses the previous
        request's recycled pages, so the scrub on allocation keeps it exact."""
        paged = dict(page_size=8, n_pages=96 // 8 + 1, prefix_sharing=False)
        _, _, eng = paged_pair(served, _prompts(served[0].vocab, (19, 25, 7, 34)), paged=paged,
                               slots=1)
        assert eng.pager.free_pages == eng.pager.total_pages

    def test_null_page_untouched_after_every_step(self, served):
        """Chunked prefill with tree speculation, a chunk narrower than the
        tree, and rows past their reservation: after every tick page 0 is
        as it was and every mapped entry holds its own position or none."""
        eng = ts.Engine(_model(served), served[1], max_slots=3, max_len=96, prefill_chunk=8,
                        spec=tspec.SpecConfig(k=3, tree=(2, 2)), device="cpu",
                        paged_kv=ts.PagedKVConfig(page_size=8))
        sched = ts.ContinuousBatchingScheduler(eng)
        reqs = [ts.Request(rid=i, prompt=p.copy(), max_new_tokens=6)
                for i, p in enumerate(_prompts(served[0].vocab, LENS))]
        sched.submit(reqs)
        ticks = 0
        while sched.queue or eng.has_work:
            sched.tick()
            ticks += 1
            _null_page_untouched(eng)
            for layer in eng.cache:
                view = tm.page_view(layer["slot_pos"], layer["tab"])
                own = torch.arange(view.shape[1], dtype=view.dtype)[None, :]
                assert bool(((view < 0) | (view == own)).all())
        assert ticks > 3 and all(r.done for r in reqs)


# --------------------------------------------------------------------------
# Block-boundary edges
# --------------------------------------------------------------------------
class TestBlockBoundaries:
    def test_prompt_exactly_on_page_edge(self, served):
        paged_pair(served, _prompts(served[0].vocab, (8, 16, 24)), paged=PAGED)

    def test_rollback_across_page_edge(self, served):
        """page_size 4 < k+1 = 5: every verify window spans a page edge."""
        paged_pair(served, _prompts(served[0].vocab, (7, 14, 21)), paged=dict(page_size=4),
                   spec=dict(k=4), max_new=10)

    def test_tree_compaction_across_page_edge(self, served):
        """page_size 4 < n_nodes 7: the compacted window straddles an edge."""
        paged_pair(served, _prompts(served[0].vocab, (7, 14, 21)), paged=dict(page_size=4),
                   spec=dict(k=2, tree=(3, 2)), max_new=10)

    def test_cow_fork_mid_page(self, served):
        """Two prompts sharing a prefix that ends mid-page: only the full
        common page is shared, the partial page is recomputed privately."""
        rng = np.random.default_rng(5)
        base_p = rng.integers(0, served[0].vocab, size=20).astype(np.int32)
        fork = base_p.copy()
        fork[12:] = rng.integers(0, served[0].vocab, size=8).astype(np.int32)
        _, stats, _ = paged_pair(served, [base_p, fork, base_p], paged=PAGED, slots=1)
        assert stats.prefix_hit_requests == 2
        assert stats.prefix_hit_tokens == 8 + 16


# --------------------------------------------------------------------------
# Prefix sharing and the offload tier end to end
# --------------------------------------------------------------------------
class TestPrefixSharingServing:
    def test_shared_system_prompt_identity_and_hits(self, served):
        rng = np.random.default_rng(6)
        shared = rng.integers(0, served[0].vocab, size=24).astype(np.int32)
        prompts = [np.concatenate([shared, rng.integers(0, served[0].vocab, size=4)
                                   .astype(np.int32)]) for _ in range(4)]
        _, stats, _ = paged_pair(served, prompts, paged=PAGED, slots=1)
        assert stats.prefix_hit_requests == 3
        assert stats.prefix_hit_tokens == 3 * 24
        assert stats.prefill_tokens == sum(map(len, prompts)) - 3 * 24

    def test_shared_prompt_chunked(self, served):
        """A prefix hit under chunked prefill: the slot's first chunk starts
        at the matched frontier."""
        rng = np.random.default_rng(7)
        shared = rng.integers(0, served[0].vocab, size=16).astype(np.int32)
        prompts = [np.concatenate([shared, rng.integers(0, served[0].vocab, size=n)
                                   .astype(np.int32)]) for n in (5, 9, 3)]
        _, stats, _ = paged_pair(served, prompts, paged=PAGED, slots=1, prefill_chunk=8)
        assert stats.prefix_hit_tokens == 2 * 16

    def test_offload_tier_round_trip_stays_exact(self, served):
        """3 allocatable pages and a reservation of 3 per request: p2 pages
        p1's prefix out to the host and the second p1 pages it back in."""
        rng = np.random.default_rng(8)
        p1 = rng.integers(0, served[0].vocab, size=20).astype(np.int32)
        p2 = rng.integers(0, served[0].vocab, size=20).astype(np.int32)
        paged = dict(page_size=8, n_pages=4, host_offload_pages=8)
        _, stats, eng = paged_pair(served, [p1, p2, p1], paged=paged, slots=1, max_len=32,
                                   max_new=4)
        assert eng.pager.pages_paged_out >= 2 and eng.pager.pages_paged_in >= 2
        assert stats.prefix_hit_tokens == 16

    def test_out_of_pages_drains_fcfs(self, served):
        """A pool that fits one request at a time: later requests wait for
        pages (never rejected) and the queue drains FCFS."""
        paged = dict(page_size=8, n_pages=5, prefix_sharing=False)
        _, stats, _ = paged_pair(served, _prompts(served[0].vocab, (19, 21, 23)), paged=paged,
                                 slots=3, max_len=32, max_new=4)
        assert stats.completed == 3 and stats.rejected == 0


# --------------------------------------------------------------------------
# The launcher's paging flags
# --------------------------------------------------------------------------
def test_serve_cli_paged(capsys):
    from repro_torch.launch import serve as launch

    stats = launch.main(["--arch", "smollm-360m", "--smoke", "--device", "cpu", "--page-size", "8",
                         "--requests", "3", "--slots", "2", "--max-new", "4",
                         "--prompt-len", "20", "--max-len", "64"])
    out = capsys.readouterr().out
    assert stats.completed == 3 and "completed=3/3" in out and "paged: page_size=8 " in out
    for flag in ("--kv-pages", "--offload-pages"):
        with pytest.raises(SystemExit):
            launch.main(["--arch", "smollm-360m", "--smoke", "--device", "cpu", flag, "8"])
        assert "require --page-size" in capsys.readouterr().err
