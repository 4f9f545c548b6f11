"""The port's measured launch-plan choice (`repro_torch.kernels.autotune`),
on the CPU: every candidate is legal under the Python mirror of its C
entry's check (itself held to the constants of `csrc/*.cu`),
deduplicated, clamped to the problem, today's heuristic plan first; the
on-disk cache's round trip, its empty reads and atomic writes; reuse
without timing; no inline tuning on the CPU or inside a capture; the
cold-cache and all-fail fallbacks; the winner persisted and reported to
the installed `Obs`; a seeded plan reported by `launch_tiles` and handed
to the kernel by each wrapper. Every candidate of a few small shapes per
family, run through the kernels' CPU emulations of the plan tests, equals
the plain version bit for bit. The behaviours of `tests/test_autotune.py`,
mapped onto plans. Inputs are made by numpy from a seed."""
import dataclasses
import json
import os
import re

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import test_torch_decode_plan as tdp  # noqa: E402
import test_torch_lut_plan as tlp  # noqa: E402

from repro_torch import obs as tobs  # noqa: E402
from repro_torch.core import act_token_scale, pack_weight, ternary_quantize  # noqa: E402
from repro_torch.kernels import _build, _splitk, autotune, ops  # noqa: E402
from repro_torch.kernels import ternary_decode_gemm as tdg  # noqa: E402
from repro_torch.kernels import vlut_lookup_gemm as vlg  # noqa: E402

CPU = torch.device("cpu")

#: (family, g, M, KG, N, E) of the candidate tests: smollm-360m's segments
#: at decode and prefill N, whisper-medium's encoder at N 6,000, ragged and
#: one-K-group shapes, and the expert shapes of llama4-scout and deepseek-v3
SINGLE = ([(m, k // 5, n, 5) for m, k in tdp.SMOLLM for n in (1, 4, 16, 64, 256)]
          + [(1024, 204, 6000, 5), (1024, 1, 6000, 4), (4096, 204, 6000, 5),
             (1024, 819, 6000, 5), (70, 13, 17, 5), (1000, 191, 17, 4), (70, 1, 3, 4),
             (2048, 4, 61, 4), (8512, 408, 200, 5)])
GROUPED = [(16, 8192, 1024, 5, 4), (16, 5120, 1636, 5, 4), (16, 5120, 3, 4, 4),
           (16, 8192, 1024, 5, 64), (256, 2048, 1432, 5, 16), (256, 7168, 2, 4, 16),
           (3, 70, 13, 5, 5), (5, 130, 77, 4, 17), (140, 70, 2, 4, 1), (134, 1000, 64, 5, 16)]
CASES = ([("decode", g, m, kg, n, None) for m, kg, n, g in SINGLE]
         + [("lookup", g, m, kg, n, None) for m, kg, n, g in SINGLE]
         + [("decode_grouped", g, m, kg, n, e) for e, m, kg, g, n in GROUPED]
         + [("lookup_grouped", g, m, kg, n, e) for e, m, kg, g, n in GROUPED])


@pytest.fixture
def tmp_cache(tmp_path):
    """Point the process-default cache at a throwaway file; restore after."""
    cache = autotune.reset_default_cache(str(tmp_path / "plans.json"))
    yield cache
    autotune.reset_default_cache()


@pytest.fixture(autouse=True)
def _no_obs():
    tobs.install(None)
    yield
    tobs.install(None)


def _src(name):
    return (_build.CSRC / name).read_text()


def _const(text, name):
    return int(re.search(r"constexpr (?:int|size_t) " + name + r" = (\d+)", text).group(1))


# ---- candidates -----------------------------------------------------------

@pytest.mark.parametrize("kernel,g,m,kg,n,e", CASES)
def test_candidates_are_legal_unique_clamped_heuristic_first(kernel, g, m, kg, n, e):
    cands = autotune.candidate_plans(kernel, g, m, kg, n, e=e)
    assert cands[0] == autotune.heuristic(kernel, g, m, kg, n, e=e)
    assert 1 <= len(cands) <= autotune.MAX_CANDIDATES
    keys = [tuple(autotune.fields_of(kernel, p).values()) for p in cands]
    assert len(set(keys)) == len(keys)
    for p in cands:
        assert autotune.legal(kernel, p), p
        assert (p.m, p.kg, p.n, p.g, getattr(p, "e", None)) == (m, kg, n, g, e)
        assert autotune.make_plan(kernel, g, m, kg, n, autotune.fields_of(kernel, p), e=e) == p
        if p is not cands[0]:
            assert p.splits == 1 or p.blocks <= autotune.MAX_WAVES * tdg.WAVE, p
        if kernel == "decode":
            slices = [p.kgroups(z) for z in range(p.splits)]
            assert p.kstep == tdg.SUB or max(hi - lo for lo, hi in slices) > tdg.SUB, p
        elif kernel == "lookup":
            assert p.bm <= max(4 * vlg.BM_UNIT, -(-m // vlg.BM_UNIT) * vlg.BM_UNIT)
            assert p.chunk <= max(hi - lo for lo, hi in (p.kgroups(z) for z in range(p.splits)))
            assert p.chunk <= 4 or p.chunk % 4 == 0 or not (kg % 4 == 0 and 4 * p.splits <= kg)
        else:
            unit = tdg.GROUP_ROWS if kernel == "decode_grouped" else vlg.BM_UNIT
            assert p.bm <= -(-m // unit) * unit and p.ex <= e, p


def test_candidates_reach_every_free_field():
    """Across the cases each family varies each of its free fields (the
    decode kernel's two tiles share BN 16)."""
    for kernel in autotune.KERNELS:
        plans = [p for k, g, m, kg, n, e in CASES if k == kernel
                 for p in autotune.candidate_plans(k, g, m, kg, n, e=e)]
        for field in autotune.FIELDS[kernel]:
            want = len({bn for _, _, bn in tdg.TILES}) if field == "bn" else 2
            assert len({getattr(p, field) for p in plans}) >= want, (kernel, field)


def test_mirror_matches_kernel_constants():
    """The mirror's limits are those of the C entries' checks."""
    dec, lut, com = (_src("ternary_decode_gemm.cu"), _src("vlut_lookup_gemm.cu"),
                     _src("mpgemm_common.cuh"))
    assert "constexpr size_t kMaxSmem = 48 * 1024;" in dec
    assert autotune.DECODE_SMEM_MAX == 48 * 1024
    assert "constexpr size_t kMaxSmem = 232448 - 1024;" in lut
    assert "constexpr size_t kGMaxSmem = 232448 - 1024;" in dec
    assert autotune.LUT_SMEM_MAX == tdg.GROUP_SMEM_MAX == 232448 - 1024
    assert autotune.LUT_THREADS == _const(com, "kThreads")
    assert vlg.BN == _const(com, "kBN")
    assert autotune.LUT_ROWS == vlg.GROUP_ROWS == _const(lut, "kMaxRowsPerThread")
    assert vlg.BM_UNIT == _const(lut, "kLutBMUnit")
    assert (vlg.GROUP_THREADS, vlg.GROUP_CHUNK) == (_const(lut, "kGThreads"), _const(lut, "kGChunk"))
    assert (tdg.GROUP_STEP, tdg.GROUP_BN) == (_const(dec, "kGStep"), _const(dec, "kGBN"))
    assert tdg.GROUP_ROWS == _const(dec, "kGSlab") * _const(dec, "kGWarps")
    assert dec.count("> 65535") == lut.count("> 65535") == 4
    assert autotune.GRID_YZ == 65535
    assert "(long long)p.N * p.M >= (1LL << 31)" in dec
    assert "if (p.chunk != (p.KG < kGChunk ? p.KG : kGChunk)) return false;" in lut


@pytest.mark.parametrize("kernel,fields,why", [
    ("decode", dict(bm=96, bn=16, splits=1, kstep=32), "a tile the kernel lacks"),
    ("decode", dict(bm=64, bn=16, splits=1, kstep=48), "a step the kernel lacks"),
    ("decode", dict(bm=64, bn=16, splits=49, kstep=32), "splits off the code words"),
    ("lookup", dict(bm=192, splits=1, chunk=12), "rows off the 128-row unit"),
    ("lookup", dict(bm=640, splits=1, chunk=12), "more than 8 rows a thread"),
    ("lookup", dict(bm=512, splits=1, chunk=40), "more shared memory than a block has"),
    ("lookup", dict(bm=128, splits=193, chunk=1), "more splits than K-groups"),
])
def test_mirror_rejects_single_plans(kernel, fields, why):
    assert not autotune.legal(kernel, autotune.make_plan(kernel, 5, 960, 192, 64, fields)), why


@pytest.mark.parametrize("kernel,fields,why", [
    ("decode_grouped", dict(bm=256, splits=1, ex=1), "rows off the 512-row unit"),
    ("decode_grouped", dict(bm=512, splits=9, ex=1), "more splits than KG/128"),
    ("decode_grouped", dict(bm=512, splits=1, ex=17), "more experts a block than E"),
    ("lookup_grouped", dict(bm=192, splits=1, ex=1), "rows off the 128-row unit"),
    ("lookup_grouped", dict(bm=2048, splits=1, ex=1), "more than 8 rows a thread at C 64"),
    ("lookup_grouped", dict(bm=128, splits=65, ex=1), "more splits than KG/16"),
])
def test_mirror_rejects_grouped_plans(kernel, fields, why):
    p = autotune.make_plan(kernel, 5, 8192, 1024, 64, fields, e=16)
    assert not autotune.legal(kernel, p), why


def test_mirror_rejects_a_grouped_lookup_chunk_and_shared_bytes_off_the_rule():
    p = autotune.heuristic("lookup_grouped", 5, 8192, 1024, 4, e=16)
    assert autotune.legal("lookup_grouped", p)
    assert not autotune.legal("lookup_grouped", dataclasses.replace(p, chunk=8))
    assert not autotune.legal("lookup_grouped", dataclasses.replace(p, smem=p.smem + 16))
    d = autotune.heuristic("decode", 5, 960, 192, 4)
    assert not autotune.legal("decode", dataclasses.replace(d, smem=d.smem + 1))
    claims_words = tdg.DecodePlan(70, 1, 3, 4, 64, 16, 1, 32, True, False, 4 * 16 * 32)
    assert not autotune.legal("decode", claims_words)


# ---- the cache --------------------------------------------------------------

def test_cache_key_holds_card_source_and_problem():
    k = autotune.cache_key("lookup_grouped", 5, 8192, 1024, 4, e=16, fused=False,
                           card="NVIDIA H100 80GB HBM3", source="abc")
    assert k == "NVIDIA H100 80GB HBM3|abc|lookup_grouped|unfused|g5|m8192|kg1024|n4|e16"
    assert autotune.cache_key("decode", 5, 960, 192, 4, fused=True, card="c", source="s") \
        == "c|s|decode|fused|g5|m960|kg192|n4|e1"


def test_disk_round_trip(tmp_path):
    path = str(tmp_path / "plans.json")
    c1 = autotune.PlanCache(path)
    key = autotune.cache_key("lookup", 5, 320, 64, 32, fused=True, card="cpu", source="s")
    c1.put(key, dict(bm=256, splits=4, chunk=8), seconds=1.25e-3)
    # a fresh instance (fresh process analogue) reads the same winner
    c2 = autotune.PlanCache(path)
    assert c2.get(key) == dict(bm=256, splits=4, chunk=8)
    raw = json.load(open(path))
    assert raw[key]["seconds"] == pytest.approx(1.25e-3)


def test_missing_and_corrupt_cache_are_empty(tmp_path):
    assert autotune.PlanCache(str(tmp_path / "nope.json")).get("k") is None
    for i, text in enumerate(("{not json", "[1, 2]", '{"k": 3}', '{"k": {"bm": "x"}}')):
        bad = tmp_path / f"bad{i}.json"
        bad.write_text(text)
        assert autotune.PlanCache(str(bad)).get("k") is None


def test_writes_are_atomic(tmp_path, monkeypatch):
    """A write that fails halfway leaves the old file whole and no
    temporary file behind; one that succeeds leaves only the cache."""
    path = tmp_path / "plans.json"
    cache = autotune.PlanCache(str(path))
    cache.put("a", dict(bm=128, splits=1, chunk=4))
    before = path.read_text()

    def broken_dump(obj, f, **kw):
        f.write('{"a": ')
        raise OSError("disk full")

    monkeypatch.setattr(autotune.json, "dump", broken_dump)
    cache.put("b", dict(bm=256, splits=2, chunk=8))
    assert path.read_text() == before
    assert sorted(os.listdir(tmp_path)) == ["plans.json"]
    monkeypatch.undo()
    cache.put("c", dict(bm=384, splits=1, chunk=4))
    assert sorted(os.listdir(tmp_path)) == ["plans.json"]
    assert set(json.loads(path.read_text())) == {"a", "b", "c"}


def test_default_cache_path_and_env(tmp_path, monkeypatch):
    monkeypatch.delenv(autotune.CACHE_ENV, raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert autotune.PlanCache().path == str(tmp_path / ".cache" / "repro_torch" / "vlut_plans.json")
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "x.json"))
    assert autotune.reset_default_cache().path == str(tmp_path / "x.json")
    assert autotune.default_cache() is autotune.default_cache()
    autotune.reset_default_cache()


def test_memo_is_dropped_on_put_and_on_reset(tmp_cache):
    args = ("decode", 5, 960, 192, 4)
    heur = autotune.get_plan(*args, device=CPU)
    assert autotune.get_plan(*args, device=CPU) is heur and tmp_cache.memo
    key = autotune.cache_key(*args, fused=True, card="cpu", source=autotune._source())
    tmp_cache.put(key, dict(bm=128, bn=16, splits=4, kstep=64))
    assert not tmp_cache.memo
    assert autotune.describe(autotune.get_plan(*args, device=CPU)) == "g5 128x16 s4 k64"
    fresh = autotune.reset_default_cache(tmp_cache.path + ".other")
    assert not fresh.memo and autotune.get_plan(*args, device=CPU) == heur


# ---- tuning and reuse ---------------------------------------------------------

def _counting(calls, seconds=lambda p: float(p.splits)):
    def bench(plan):
        calls.append(plan)
        return seconds(plan)
    return bench


@pytest.mark.parametrize("kernel,g,m,kg,n,e", [CASES[1], CASES[len(SINGLE) + 1],
                                              CASES[2 * len(SINGLE)], CASES[-1]])
def test_cached_entries_reused_instead_of_retimed(kernel, g, m, kg, n, e, tmp_path):
    cache = autotune.PlanCache(str(tmp_path / "plans.json"))
    calls = []
    args = dict(e=e, card="test", cache=cache, benchmark=_counting(calls),
                tune_if_missing=True)
    trials = autotune.tune.trials
    p1 = autotune.get_plan(kernel, g, m, kg, n, **args)
    assert len(calls) == len(autotune.candidate_plans(kernel, g, m, kg, n, e=e))
    assert autotune.tune.trials == trials + len(calls)
    assert p1.splits == min(c.splits for c in calls)
    # warm cache, this process and a fresh one: no further timing, the same plan
    assert autotune.get_plan(kernel, g, m, kg, n, **args) == p1
    fresh = dict(args, cache=autotune.PlanCache(cache.path))
    assert autotune.get_plan(kernel, g, m, kg, n, **fresh) == p1
    assert len(calls) == autotune.tune.trials - trials


def test_env_tuning_never_happens_on_the_cpu(tmp_path, monkeypatch):
    """REPRO_VLUT_AUTOTUNE=1 (or tune_if_missing=True) never times
    candidates for a CPU tensor's launch, and the default benchmark refuses
    a CPU device."""
    monkeypatch.setenv(autotune.TUNE_ENV, "1")
    cache = autotune.PlanCache(str(tmp_path / "plans.json"))
    calls = []
    for want in (None, True):
        p = autotune.get_plan("lookup", 5, 960, 192, 4, device=CPU, cache=cache,
                              benchmark=_counting(calls), tune_if_missing=want)
        assert p == vlg.lut_plan(960, 192, 4, 5)
    assert not calls and not os.path.exists(cache.path)
    with pytest.raises(ValueError, match="CUDA device"):
        autotune.tune("lookup", 5, 960, 192, 4, device=CPU, cache=cache)


def test_no_tuning_inside_a_capture(tmp_path, monkeypatch):
    monkeypatch.setattr(autotune, "_capturing", lambda: True)
    cache = autotune.PlanCache(str(tmp_path / "plans.json"))
    calls = []
    p = autotune.get_plan("decode", 5, 960, 192, 4, card="test", cache=cache,
                          benchmark=_counting(calls), tune_if_missing=True)
    assert p == tdg.decode_plan(960, 192, 4, 5) and not calls and not cache.memo
    with pytest.raises(RuntimeError, match="capture"):
        autotune.tune("decode", 5, 960, 192, 4, card="test", cache=cache,
                      benchmark=_counting(calls))


@pytest.mark.parametrize("kernel,g,m,kg,n,e", [c for c in CASES if c[3] > 16][::7])
def test_cold_cache_falls_back_to_heuristic(kernel, g, m, kg, n, e, tmp_path):
    cache = autotune.PlanCache(str(tmp_path / "plans.json"))
    for fused in (True, False):
        p = autotune.get_plan(kernel, g, m, kg, n, e=e, fused=fused, card="test", cache=cache,
                              tune_if_missing=False)
        assert p == autotune.heuristic(kernel, g, m, kg, n, e=e)


def test_all_trials_failing_caches_nothing(tmp_path):
    """Every candidate out of device memory: the heuristic plan, nothing
    persisted (a later run may tune the key)."""
    cache = autotune.PlanCache(str(tmp_path / "plans.json"))

    def oom(plan):
        raise torch.cuda.OutOfMemoryError("split-K workspace")

    res = autotune.tune("decode", 5, 960, 192, 4, card="test", cache=cache, benchmark=oom)
    assert res.plan == tdg.decode_plan(960, 192, 4, 5) and res.seconds == float("inf")
    assert not res.trials and not os.path.exists(cache.path)


def test_a_failing_candidate_raises(tmp_path):
    """Anything else a candidate raises (a plan the C entry refuses, an
    output off the heuristic plan's) is a fault of the port: it raises."""
    cache = autotune.PlanCache(str(tmp_path / "plans.json"))

    def refused(plan):
        raise RuntimeError("vlut_lookup_gemm_fused: CUDA error 1 at launch")

    with pytest.raises(RuntimeError, match="CUDA error"):
        autotune.tune("lookup", 5, 960, 192, 4, card="test", cache=cache, benchmark=refused)
    assert not os.path.exists(cache.path)


def test_winner_is_the_minimum_and_persisted(tmp_path):
    cache = autotune.PlanCache(str(tmp_path / "plans.json"))
    cands = autotune.candidate_plans("lookup", 5, 960, 192, 64)
    times = {c: 1e-3 * (1 + (i * 7) % len(cands)) for i, c in enumerate(cands)}
    times[cands[5]] = 1e-5
    res = autotune.tune("lookup", 5, 960, 192, 64, card="test", cache=cache,
                        benchmark=times.__getitem__)
    assert res.plan == cands[5] and res.seconds == 1e-5 and len(res.trials) == len(cands)
    key = autotune.cache_key("lookup", 5, 960, 192, 64, fused=True, card="test",
                             source=autotune._source())
    assert autotune.PlanCache(cache.path).get(key) == autotune.fields_of("lookup", cands[5])
    assert json.load(open(cache.path))[key]["seconds"] == 1e-5


def test_winner_is_reported_to_the_installed_obs(tmp_path):
    """`record_kernel_sample`: one `repro:mpgemm_kernel_seconds` sample per
    tuned key (a grouped launch's seconds per expert)."""
    o = tobs.Obs(tobs.ObsConfig())
    tobs.install(o)
    cache = autotune.PlanCache(str(tmp_path / "plans.json"))
    autotune.tune("decode", 5, 960, 192, 4, card="test", cache=cache,
                  benchmark=lambda p: 2e-5 * p.splits)
    autotune.tune("lookup_grouped", 5, 8192, 1024, 4, e=16, fused=False, card="test",
                  cache=cache, benchmark=lambda p: 1.6e-4)
    single = o.registry.find("repro:mpgemm_kernel_seconds",
                             {"impl": "decode", "g": "5", "shape": "960x960", "m_tokens": "4"})
    grouped = o.registry.find("repro:mpgemm_kernel_seconds",
                              {"impl": "lookup_grouped", "g": "5", "shape": "8192x5120",
                               "m_tokens": "4"})
    assert list(single.samples) == [2e-5]
    assert list(grouped.samples) == [pytest.approx(1e-5)]


# ---- the dispatch --------------------------------------------------------------

def _weight(m, k, seed=0):
    w = torch.tensor(np.random.default_rng(seed).standard_normal((m, k)).astype(np.float32))
    tw = ternary_quantize(w)
    return pack_weight(tw.values, tw.scale)


def _old_tile(pw, n, impl, e=None):
    """`launch_tiles` as it read before the tuner: today's plan rules."""
    head = f"e{e} " if e is not None and e > 1 else ""
    out = []
    for packed, _, _, g in ops._segments(pw):
        kg = packed.shape[-1]
        if impl == "lookup" and e is not None:
            p = vlg.grouped_lut_plan(pw.M, kg, n, g, e)
            out.append(f"{head}g{g} bm{p.bm} s{p.splits} c{p.chunk} x{p.ex}")
        elif impl == "lookup":
            p = vlg.lut_plan(pw.M, kg, n, g)
            out.append(f"{head}g{g} bm{p.bm} s{p.splits} c{p.chunk}")
        elif e is not None:
            p = tdg.grouped_decode_plan(pw.M, kg, n, g, e)
            out.append(f"{head}g{g} bm{p.bm} s{p.splits} x{p.ex}")
        else:
            p = tdg.decode_plan(pw.M, kg, n, g)
            out.append(f"{head}g{g} {p.bm}x{p.bn} s{p.splits} k{p.kstep}")
    return out


#: (M, K) of the plan tests' weights: smollm-360m's, the K = 964 mixed one,
#: mamba2's and gemma3's new linears, and whisper-medium's
IDENTITY_WEIGHTS = tdp.SMOLLM + [(960, 964)] + tdp.NEW_LINEARS + [(1024, 1024), (4096, 1024),
                                                                   (1024, 4096)]


@pytest.mark.parametrize("m,k", IDENTITY_WEIGHTS)
def test_cold_cache_launch_tiles_are_todays(m, k, tmp_cache):
    """With an empty cache every launch reports (and launches) today's
    plan, single and grouped, fused and unfused."""
    pw = _weight(m, k)
    for n in (1, 4, 16, 17, 61, 64, 200, 256, 6000):
        for impl in ("decode", "lookup"):
            for fusion in ("fused", "unfused"):
                assert ops.launch_tiles(pw, n, impl, fusion=fusion) == _old_tile(pw, n, impl)
                for e in (1, 16):
                    assert ops.launch_tiles(pw, n, impl, e, fusion) == _old_tile(pw, n, impl, e)


def _seed(cache, kernel, g, m, kg, n, fields, e=None, fused=True):
    key = autotune.cache_key(kernel, g, m, kg, n, e=e, fused=fused, card="cpu",
                             source=autotune._source())
    cache.put(key, fields)


#: one odd but legal plan per wrapper: (family, fused, launch half, `_build`
#: entry, its seeded fields, its string)
ODD = [
    ("decode", True, tdg._launch_fused, "launch_decode",
     dict(bm=128, bn=16, splits=4, kstep=64), "g5 128x16 s4 k64"),
    ("decode", False, tdg._launch_int, "launch_decode_int",
     dict(bm=128, bn=16, splits=2, kstep=32), "g5 128x16 s2 k32"),
    ("lookup", True, vlg._launch_fused, "launch_lut",
     dict(bm=384, splits=8, chunk=4), "g5 bm384 s8 c4"),
    ("lookup", False, vlg._launch_int, "launch_lut_int",
     dict(bm=128, splits=1, chunk=20), "g5 bm128 s1 c20"),
    ("decode_grouped", True, tdg._launch_fused_grouped, "launch_decode_grouped",
     dict(bm=1024, splits=2, ex=2), "e4 g5 bm1024 s2 x2"),
    ("decode_grouped", False, tdg._launch_int_grouped, "launch_decode_int_grouped",
     dict(bm=512, splits=1, ex=4), "e4 g5 bm512 s1 x4"),
    ("lookup_grouped", True, vlg._launch_fused_grouped, "launch_lut_grouped",
     dict(bm=256, splits=3, ex=2), "e4 g5 bm256 s3 c16 x2"),
    ("lookup_grouped", False, vlg._launch_int_grouped, "launch_lut_int_grouped",
     dict(bm=1024, splits=1, ex=3), "e4 g5 bm1024 s1 c16 x3"),
]


@pytest.mark.parametrize("kernel,fused,launch,entry,fields,tile", ODD,
                         ids=[f"{o[0]}-{'fused' if o[1] else 'int'}" for o in ODD])
def test_seeded_plan_is_reported_and_launched(kernel, fused, launch, entry, fields, tile,
                                              tmp_cache, monkeypatch):
    """An odd but legal plan seeded in the cache for the exact segment a
    call will launch is what `launch_tiles` reports (and an installed
    `Obs`'s dispatch span), and what the wrapper hands the kernel's C
    entry, with the operands' alignment claims."""
    m, k, n, e = 2048, 2560, 4 if fused else 16, (4 if kernel.endswith("_grouped") else None)
    kg, g = k // 5, 5
    _seed(tmp_cache, kernel, g, m, kg, n, fields, e=e, fused=fused)
    pw = _weight(m, k, seed=3)
    fusion = "fused" if fused else "unfused"
    assert ops.launch_tiles(pw, n, kernel.split("_")[0], e, fusion) == [tile]
    rng = np.random.default_rng(4)
    lead = (e,) if e else ()
    packed = torch.tensor(rng.integers(0, 3 ** g, (*lead, m, kg)).astype(np.uint8))
    if fused:
        x = torch.tensor(rng.standard_normal((*lead, n, k)).astype(np.float32))
        args = (x, act_token_scale(x.reshape(-1, k).T).reshape(*lead, n).contiguous(),
                torch.ones((*lead, m)), g, torch.float32)
        claims = tdg.fused_aligned(packed, x)
    else:
        a_r = torch.tensor(rng.integers(-127, 128, (*lead, g, kg, n)).astype(np.int8))
        args, claims = (a_r, g), tdg.int_aligned(packed, a_r)
    seen = []
    monkeypatch.setattr(_build, entry, lambda *a: seen.append(a[-3]))
    monkeypatch.setattr(_splitk, "launch_args", lambda plan, device: (None, None))
    wrapper = autotune._wrapper(kernel, fused)
    monkeypatch.setattr(wrapper, "launches", 0)
    launch(packed, *args, None)
    want = autotune.make_plan(kernel, g, m, kg, n, fields, e=e)
    assert seen == [autotune.with_claims(want, *claims)] and wrapper.launches == 1
    if kernel == "decode":
        assert claims == (True, True) and seen[0].codes_aligned
    if fused and e is None:
        o = tobs.Obs(tobs.ObsConfig())
        tobs.install(o)
        ops.ternary_matmul(pw, torch.zeros((n, k)), impl=kernel)
        spans = [ev for ev in o.tracer.events if ev["name"] == "mpgemm_dispatch"]
        assert [s["args"]["tile"] for s in spans] == [[tile]]


def test_segment_mpgemm_takes_a_plan():
    """`segment_mpgemm(plan=)` (the JAX version's `tiles=`): on the CPU
    the plain versions, equal with and without a plan."""
    rng = np.random.default_rng(5)
    packed = torch.tensor(rng.integers(0, 243, (70, 13)).astype(np.uint8))
    a = torch.tensor(rng.standard_normal((65, 17)).astype(np.float32))
    for impl in ("decode", "lookup"):
        for fused in (True, False):
            plan = autotune.candidate_plans(impl, 5, 70, 13, 17)[-1]
            assert torch.equal(ops.segment_mpgemm(packed, a, 5, impl, fused=fused, plan=plan),
                               ops.segment_mpgemm(packed, a, 5, impl, fused=fused))


# ---- every candidate through the kernels' emulations ------------------------

@pytest.mark.parametrize("m,kg,n,g", [(70, 13, 17, 5), (130, 40, 20, 4)])
def test_every_decode_candidate_emulated_equals_plain(m, kg, n, g):
    """The decode kernel's emulation (`_emulate`: table decode, mma
    fragments, split-K sums) under every candidate: integer at both shapes,
    fused (bf16) at the first, bit for bit against the plain versions."""
    rng = np.random.default_rng(m + kg)
    packed = rng.integers(0, 3 ** g, (m, kg)).astype(np.uint8)
    a_r = rng.integers(-127, 128, (g, kg, n)).astype(np.int8)
    want = tdg.ternary_decode_gemm_plain(torch.tensor(packed), torch.tensor(a_r), g=g)
    x = torch.tensor((rng.standard_normal((n, kg * g)) * 3).astype(np.float32)).to(torch.bfloat16)
    a_scale = act_token_scale(x.T).contiguous()
    w_scale = torch.tensor(rng.random(m).astype(np.float32))
    want_f = tdg.ternary_decode_gemm_fused_plain(torch.tensor(packed), x, a_scale, w_scale, g=g,
                                                 out_dtype=torch.bfloat16)
    cands = autotune.candidate_plans("decode", g, m, kg, n)
    assert len({(p.bm, p.kstep) for p in cands}) > 1 and len({p.splits for p in cands}) > 2
    for p in cands:
        assert torch.equal(torch.tensor(tdp._emulate(packed, a_r, p, "int")), want), p
        if m == 70:
            acc = tdp._emulate(packed, x.float().numpy(), p, "fused", a_scale.numpy())
            got = tdg.epilogue(torch.tensor(acc).T, w_scale, a_scale, torch.bfloat16)
            assert torch.equal(got, want_f), p


@pytest.mark.parametrize("m,kg,n,g", [(70, 13, 17, 5), (130, 77, 33, 4), (320, 192, 4, 5)])
def test_every_lookup_candidate_tiled_equals_plain(m, kg, n, g):
    """The vector-LUT kernel's decomposition (`_tiled_plain`: its blocks'
    rows, tokens, K-splits and chunks) under every candidate equals the
    plain version bit for bit."""
    rng = np.random.default_rng(m + kg + n)
    packed = torch.tensor(rng.integers(0, 3 ** g, (m, kg)).astype(np.uint8))
    a_r = torch.tensor(rng.integers(-127, 128, (g, kg, n)).astype(np.int8))
    want = vlg.vlut_lookup_gemm_plain(packed, a_r, g=g)
    cands = autotune.candidate_plans("lookup", g, m, kg, n)
    assert len({p.chunk for p in cands}) > 1 and len({p.splits for p in cands}) > 2
    for p in cands:
        assert torch.equal(tlp._tiled_plain(packed, a_r, g, p)[1], want), p


@pytest.mark.parametrize("e,m,kg,g,n", [(3, 130, 300, 5, 17), (2, 600, 200, 5, 9),
                                        (5, 300, 2, 4, 5)])
def test_every_grouped_decode_candidate_emulated_equals_plain(e, m, kg, g, n):
    """The grouped decode kernel's block order (`_emulate_grouped`: random
    block order, warp slots, zero skip, split-K arrivals, experts a block)
    under every candidate: integer, and fused at the first shape, equal the
    plain versions bit for bit, with expert 1 all zero; split-K leaves the
    workspace and counters zeroed."""
    packed, a_r, x, rng = tdp._grouped_operands(e, m, kg, g, n, e + m + kg, zero_expert=1)
    want = tdg.ternary_decode_gemm_plain(torch.tensor(packed), torch.tensor(a_r), g=g)
    xt = torch.tensor(x).to(torch.bfloat16)
    a_scale = torch.stack([act_token_scale(xt[i].T) for i in range(e)]).contiguous()
    w_scale = torch.tensor(rng.random((e, m)).astype(np.float32))
    want_f = tdg.ternary_decode_gemm_fused_plain(torch.tensor(packed), xt, a_scale, w_scale,
                                                 g=g, out_dtype=torch.bfloat16)
    cands = autotune.candidate_plans("decode_grouped", g, m, kg, n, e=e)
    assert len({p.ex for p in cands}) > 1
    for p in cands:
        got, ws, counters, _ = tdp._emulate_grouped(packed, a_r, p, "int", seed=m)
        assert torch.equal(torch.tensor(got), want), p
        assert not ws.any() and not counters.any()
        if m == 130:
            acc, *_ = tdp._emulate_grouped(packed, xt.float().numpy(), p, "fused",
                                           a_scale.numpy(), seed=n)
            got = tdg.epilogue(torch.tensor(acc).transpose(1, 2), w_scale, a_scale, torch.bfloat16)
            assert torch.equal(got, want_f), p


@pytest.mark.parametrize("e,m,kg,g,n", [(3, 70, 45, 5, 5), (5, 130, 77, 4, 17),
                                        (2, 1000, 40, 5, 64), (7, 70, 1, 4, 3)])
def test_every_grouped_lookup_candidate_emulated_equals_plain(e, m, kg, g, n):
    """The grouped vector-LUT kernel's arithmetic (`_emulated_grouped_int`:
    16-bit packed lanes, flushes, K-splits, experts a block) under every
    candidate equals the plain version bit for bit."""
    rng = np.random.default_rng(e * m + kg)
    packed = rng.integers(0, 3 ** g, (e, m, kg)).astype(np.uint8)
    a_r = rng.integers(-128, 128, (e, g, kg, n)).astype(np.int8)
    want = vlg.vlut_lookup_gemm_plain(torch.tensor(packed), torch.tensor(a_r), g=g).numpy()
    cands = autotune.candidate_plans("lookup_grouped", g, m, kg, n, e=e)
    assert len(cands) > 1
    for p in cands:
        assert np.array_equal(tlp._emulated_grouped_int(packed, a_r, g, p), want), p
