"""The measured launch-plan choice of the four mpGeMM kernels (ported from
`repro.kernels.autotune`).

Each kernel family has a host plan (`decode_plan`, `lut_plan`,
`grouped_decode_plan`, `grouped_lut_plan`): a rule that fills the card at
the shapes it was timed on. The best plan inside what a kernel accepts
depends on the shape, so this module

  * enumerates the legal plans of a concrete problem (`candidate_plans`),
    today's rule first: each candidate passes a mirror of its C entry's
    check (`legal`: `plan_ok` / `gplan_ok` in `csrc/*_gemm.cu`), so the
    kernel never refuses one;
  * times each candidate on the card through the kernel's wrapper, after
    holding its output bit-equal to the heuristic plan's (`tune`);
  * persists the winner's free fields in an on-disk JSON cache
    (`PlanCache`, default ``~/.cache/repro_torch/vlut_plans.json``,
    override ``REPRO_VLUT_AUTOTUNE_CACHE``), keyed by the card's name and
    the kernels' source hash besides the problem (`cache_key`), so a
    rebuilt kernel or another card is tuned again;
  * answers each launch (`get_plan`): a cached plan, else the heuristic
    plan, unless inline tuning is asked for (``REPRO_VLUT_AUTOTUNE=1`` or
    ``tune_if_missing=True``), which never happens on the CPU or inside a
    CUDA-graph capture. After a shape's first call the answer is one
    dictionary lookup (the cache's memo). `generation` changes whenever a
    launch's answer may change (a stored winner, another cache): a step
    captured as a CUDA graph (`serve.graphs`) bakes its plans in and keys
    on it.

Kernel families: "decode" and "lookup" (single launches), and
"decode_grouped" and "lookup_grouped" (E experts of one shape in one
launch); `fused` tells the fused kernel from its integer twin.

The JAX package's VMEM budget (`VMEM_BUDGET_BYTES`, `vmem_budget_bytes`,
``REPRO_VLUT_VMEM_BUDGET``) has no counterpart: a block's shared memory on
the card is bounded by the kernel's own fixed maximum, which its C entry
checks and `legal` mirrors.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import json
import math
import os
import tempfile
from typing import Callable, Iterable

import torch

from repro_torch import obs as obs_mod

from . import _build

CACHE_ENV = "REPRO_VLUT_AUTOTUNE_CACHE"
TUNE_ENV = "REPRO_VLUT_AUTOTUNE"
KERNELS = ("decode", "lookup", "decode_grouped", "lookup_grouped")
#: the free fields of each family's plan: what the cache stores (the rest
#: of a plan follows from the problem, or from the operands at launch)
FIELDS = {"decode": ("bm", "bn", "splits", "kstep"),
          "lookup": ("bm", "splits", "chunk"),
          "decode_grouped": ("bm", "splits", "ex"),
          "lookup_grouped": ("bm", "splits", "ex")}

# The C entries' limits that the plan modules do not already name
GRID_YZ = 65535                 # grid y and z
DECODE_SMEM_MAX = 48 * 1024     # `kMaxSmem`, csrc/ternary_decode_gemm.cu
LUT_SMEM_MAX = 232448 - 1024    # `kMaxSmem`, csrc/vlut_lookup_gemm.cu
LUT_THREADS = 256               # `kThreads`, csrc/mpgemm_common.cuh
LUT_ROWS = 8                    # `kMaxRowsPerThread`, csrc/vlut_lookup_gemm.cu
#: the largest int32 offset of the grouped decode kernel's combine
GROUPED_DECODE_OUTPUTS = 1 << 31

#: candidates per problem, at most (the heuristic plan first)
MAX_CANDIDATES = 32
#: K-splits past this many waves of blocks only add split-K round trips
MAX_WAVES = 8
#: the card's L2 cache: operands smaller than this are flushed from it
#: between timed launches, as serving streams each weight from HBM
L2_BYTES = 50 * 2**20
#: timed launches in one graph replay, and replays (the median is kept),
#: for operands below and above the L2 cache
LAUNCHES = {"small": 8, "large": 2}
REPLAYS = {"small": 5, "large": 3}


def _modules():
    """The two kernel modules (imported here, not at the top: both import
    this module for their launches)."""
    from . import ternary_decode_gemm as tdg
    from . import vlut_lookup_gemm as vlg

    return tdg, vlg


def _check_kernel(kernel: str, e: int | None) -> None:
    if kernel not in KERNELS:
        raise ValueError(f"unknown mpGeMM kernel family {kernel!r}; have {KERNELS}")
    if kernel.endswith("_grouped") != (e is not None):
        raise ValueError(f"{kernel}: e (experts) is given exactly for the grouped families")


def heuristic(kernel: str, g: int, m: int, kg: int, n: int, *, e: int | None = None):
    """Today's plan rule of a family: the cold-cache answer."""
    _check_kernel(kernel, e)
    tdg, vlg = _modules()
    if kernel == "decode":
        return tdg.decode_plan(m, kg, n, g)
    if kernel == "lookup":
        return vlg.lut_plan(m, kg, n, g)
    if kernel == "decode_grouped":
        return tdg.grouped_decode_plan(m, kg, n, g, e)
    return vlg.grouped_lut_plan(m, kg, n, g, e)


def make_plan(kernel: str, g: int, m: int, kg: int, n: int, fields: dict, *,
              e: int | None = None, codes_aligned: bool = False, acts_aligned: bool = False):
    """The plan of a family with the given free fields (`FIELDS`), the rest
    derived as the kernel derives it: shared bytes, a grouped decode
    block's staged token rows, a grouped lookup block's chunk. A single
    decode plan carries the alignment claims given (they come from the
    operands at launch, never from the cache)."""
    _check_kernel(kernel, e)
    tdg, vlg = _modules()
    f = {k: int(fields[k]) for k in FIELDS[kernel]}
    if kernel == "decode":
        return tdg.DecodePlan(m, kg, n, g, f["bm"], f["bn"], f["splits"], f["kstep"],
                              codes_aligned, acts_aligned,
                              tdg.decode_smem_bytes(g, f["bn"], f["kstep"]))
    bnt = 4 * vlg.tok_lanes(min(n, vlg.BN))
    if kernel == "lookup":
        return vlg.LutPlan(m, kg, n, g, f["bm"], f["splits"], f["chunk"],
                           vlg.lut_smem_bytes(g, f["bm"], f["chunk"], bnt))
    if kernel == "decode_grouped":
        bn = 8 if n <= 8 else tdg.GROUP_BN
        longest = tdg._longest_slice(kg, max(1, f["splits"]))
        return tdg.GroupedDecodePlan(m, kg, n, g, e, f["bm"], f["splits"], f["ex"], bn,
                                     tdg.grouped_decode_smem_bytes(g, bn, longest))
    chunk = min(vlg.GROUP_CHUNK, kg)
    return vlg.GroupedLutPlan(m, kg, n, g, f["bm"], f["splits"], chunk,
                              vlg.grouped_smem_bytes(g, f["bm"], chunk, bnt), e, f["ex"])


def fields_of(kernel: str, plan) -> dict:
    """A plan's free fields, as the cache stores them."""
    return {k: int(getattr(plan, k)) for k in FIELDS[kernel]}


def with_claims(plan, codes_aligned: bool, acts_aligned: bool):
    """A single decode plan with the operands' alignment claims; any other
    plan as it is (its C entry derives its own)."""
    if hasattr(plan, "codes_aligned"):
        return dataclasses.replace(plan, codes_aligned=codes_aligned, acts_aligned=acts_aligned)
    return plan


def legal(kernel: str, plan) -> bool:
    """The family's C check (`plan_ok` / `gplan_ok`), in Python: the plan's
    geometry, grid and shared bytes, without the checks on pointers and
    strides (those the operands decide at launch)."""
    tdg, vlg = _modules()
    p = plan
    if min(p.m, p.kg, p.n) <= 0 or p.g not in (4, 5) or p.splits < 1:
        return False
    if kernel == "decode":
        return ((p.bm, p.bn) in {(bm, bn) for _, bm, bn in tdg.TILES}
                and p.kstep in (tdg.SUB, tdg.MAX_STEP)
                and p.splits <= p.kg and -(-p.n // p.bn) <= GRID_YZ and p.splits <= GRID_YZ
                and not (p.kg % 4 == 0 and 4 * p.splits > p.kg)
                and not ((p.codes_aligned or p.acts_aligned) and p.kg % 4)
                and p.smem == tdg.decode_smem_bytes(p.g, p.bn, p.kstep) <= DECODE_SMEM_MAX)
    bnt = 4 * vlg.tok_lanes(min(p.n, vlg.BN))
    if kernel == "lookup":
        return (p.bm > 0 and p.bm % vlg.BM_UNIT == 0 and p.splits <= min(p.kg, GRID_YZ)
                and p.chunk >= 1 and -(-p.n // vlg.BN) <= GRID_YZ
                and p.bm * bnt <= LUT_ROWS * LUT_THREADS * 4
                and p.smem == vlg.lut_smem_bytes(p.g, p.bm, p.chunk, bnt) <= LUT_SMEM_MAX)
    if p.e < 1 or not 1 <= p.ex <= p.e or -(-p.e // p.ex) * p.splits > GRID_YZ:
        return False
    if kernel == "decode_grouped":
        return (p.bm > 0 and p.bm % tdg.GROUP_ROWS == 0
                and p.splits <= max(1, p.kg // tdg.GROUP_STEP)
                and -(-p.n // tdg.GROUP_BN) <= GRID_YZ and p.n * p.m < GROUPED_DECODE_OUTPUTS
                and p.bn == (8 if p.n <= 8 else tdg.GROUP_BN)
                and p.smem == tdg.grouped_decode_smem_bytes(
                    p.g, p.bn, tdg._longest_slice(p.kg, p.splits)) <= tdg.GROUP_SMEM_MAX)
    return (p.bm > 0 and p.bm % vlg.BM_UNIT == 0
            and p.splits <= max(1, p.kg // vlg.GROUP_CHUNK)
            and p.chunk == min(p.kg, vlg.GROUP_CHUNK) and -(-p.n // vlg.BN) <= GRID_YZ
            and p.bm * bnt <= vlg.GROUP_ROWS * vlg.GROUP_THREADS * 4
            and p.smem == vlg.grouped_smem_bytes(p.g, p.bm, p.chunk, bnt) <= LUT_SMEM_MAX)


def describe(plan) -> str:
    """A plan as the dispatch span's `tile` entry: decode "g5 64x16 s2
    k32" (BM x BN, K-splits, K-groups per step), grouped "g5 bm2048 s1 x1"
    (rows a block, K-splits, experts a block); lookup "g5 bm128 s2 c64"
    (BM, K-splits, table chunk), grouped with " x4" after it."""
    if hasattr(plan, "kstep"):
        return f"g{plan.g} {plan.bm}x{plan.bn} s{plan.splits} k{plan.kstep}"
    if hasattr(plan, "chunk"):
        tail = f" x{plan.ex}" if hasattr(plan, "ex") else ""
        return f"g{plan.g} bm{plan.bm} s{plan.splits} c{plan.chunk}{tail}"
    return f"g{plan.g} bm{plan.bm} s{plan.splits} x{plan.ex}"


def _ladder(top: int, unit: int = 1) -> list[int]:
    """unit, 2 unit, 4 unit, ... up to top."""
    out, v = [], unit
    while v <= top:
        out.append(v)
        v *= 2
    return out


def candidate_plans(kernel: str, g: int, m: int, kg: int, n: int, *,
                    e: int | None = None) -> list:
    """The legal plans of one problem, deduplicated, today's heuristic plan
    first, at most `MAX_CANDIDATES`. K-splits run on a ladder 1, 2, 4, ...
    up to the family's cap, and stop where the grid passes `MAX_WAVES`
    waves. Per family:

    - decode: each tile the kernel has x each split x K-groups per step
      (32, and 64 where a K-slice is longer than 32);
    - lookup: rows a block 128-512 x each split, each with the chunk
      today's rule gives it; the heuristic's rows and splits also with the
      largest chunk the kernel's shared memory holds and the halves of
      both (on word boundaries where the rule keeps them);
    - decode_grouped: rows a block 512, 1,024, ... (and all rows) x each
      split (at most KG/128), one expert a block; the heuristic's rows and
      splits with 2, 4, ... experts a block; a segment of one step (KG <=
      128) has every rows x experts pair instead;
    - lookup_grouped: the same with rows a block 128, 256, ... (to the
      kernel's 8 rows a thread) and splits up to KG/16, chunks of 16.

    The alignment claims of a decode plan are left False: they come from
    the operands at launch."""
    tdg, vlg = _modules()
    heur = heuristic(kernel, g, m, kg, n, e=e)
    out, seen = [heur], {tuple(fields_of(kernel, heur).values())}

    def add(**fields):
        key = tuple(fields[k] for k in FIELDS[kernel])
        if key in seen or len(out) >= MAX_CANDIDATES:
            return
        p = make_plan(kernel, g, m, kg, n, fields, e=e)
        if legal(kernel, p) and (p.splits == 1 or p.blocks <= MAX_WAVES * tdg.WAVE):
            seen.add(key)
            out.append(p)

    if kernel == "decode":
        cap = kg // 4 if kg % 4 == 0 else kg
        for _, bm, bn in tdg.TILES:
            for s in _ladder(cap):
                longest = max(tdg._split_bound(z + 1, kg, s) - tdg._split_bound(z, kg, s)
                              for z in range(s))
                for kstep in ((tdg.SUB, tdg.MAX_STEP) if longest > tdg.SUB else (tdg.SUB,)):
                    add(bm=bm, bn=bn, splits=s, kstep=kstep)
        return out
    if kernel == "lookup":
        bnt = 4 * vlg.tok_lanes(min(n, vlg.BN))
        bms = range(vlg.BM_UNIT, min(4 * vlg.BM_UNIT, -(-m // vlg.BM_UNIT) * vlg.BM_UNIT) + 1,
                    vlg.BM_UNIT)
        chunks = [vlg.lut_chunk(g, heur.bm, kg, heur.splits, bnt, budget)
                  for budget in (vlg.SMEM_BUDGET, LUT_SMEM_MAX)]
        for c in chunks + [vlg.word_chunk(c // 2, kg, heur.splits) for c in chunks]:
            add(bm=heur.bm, splits=heur.splits, chunk=c)
        for bm in bms:
            for s in _ladder(kg):
                add(bm=bm, splits=s, chunk=vlg.lut_chunk(g, bm, kg, s, bnt, vlg.SMEM_BUDGET))
        return out
    if kernel == "decode_grouped":
        unit, top, max_splits, one_step = (tdg.GROUP_ROWS, -(-m // tdg.GROUP_ROWS) * tdg.GROUP_ROWS,
                                           max(1, kg // tdg.GROUP_STEP), kg <= tdg.GROUP_STEP)
    else:
        bnt = 4 * vlg.tok_lanes(min(n, vlg.BN))
        unit = vlg.BM_UNIT
        top = min(vlg.GROUP_THREADS * vlg.GROUP_ROWS * 4 // bnt, -(-m // unit) * unit)
        max_splits, one_step = max(1, kg // vlg.GROUP_CHUNK), kg <= vlg.GROUP_CHUNK
    bms = sorted(set(_ladder(top, unit)) | {top})
    if one_step:
        for bm in bms:
            for ex in _ladder(e):
                add(bm=bm, splits=1, ex=ex)
        return out
    for ex in _ladder(e):
        add(bm=heur.bm, splits=heur.splits, ex=ex)
    for bm in bms:
        for s in _ladder(max_splits):
            add(bm=bm, splits=s, ex=1)
    return out


def cache_key(kernel: str, g: int, m: int, kg: int, n: int, *, e: int | None = None,
              fused: bool, card: str, source: str) -> str:
    """The cache's key of one problem on one card and one build of the
    kernels (`_build.source_hash`)."""
    return (f"{card}|{source}|{kernel}|{'fused' if fused else 'unfused'}"
            f"|g{g}|m{m}|kg{kg}|n{n}|e{e or 1}")


#: the generations of every plan cache in the process, in turn
_GENERATIONS = itertools.count()


class PlanCache:
    """On-disk JSON map: cache_key → the plan's free fields and `seconds`.
    A missing or corrupt file reads as empty; every write replaces the
    whole file atomically. `memo` holds `get_plan`'s answers in process:
    dropped by `put`, which also moves `generation` on (unique across the
    process's caches)."""

    def __init__(self, path: str | None = None):
        self.path = path or os.environ.get(CACHE_ENV) or os.path.join(
            os.path.expanduser("~"), ".cache", "repro_torch", "vlut_plans.json")
        self._data: dict | None = None
        self.memo: dict = {}
        self.generation = next(_GENERATIONS)

    def _load(self) -> dict:
        if self._data is None:
            try:
                with open(self.path) as f:
                    data = json.load(f)
            except (OSError, ValueError):
                data = {}
            self._data = data if isinstance(data, dict) else {}
        return self._data

    def get(self, key: str) -> dict | None:
        """The stored fields of `key` (ints, `seconds` left out), or None
        where there is no well-formed entry."""
        ent = self._load().get(key)
        if not isinstance(ent, dict):
            return None
        try:
            return {k: int(v) for k, v in ent.items() if k != "seconds"}
        except (TypeError, ValueError):
            return None

    def put(self, key: str, fields: dict, seconds: float | None = None) -> None:
        data = self._load()
        ent = {k: int(v) for k, v in fields.items()}
        if seconds is not None:
            ent["seconds"] = float(seconds)
        data[key] = ent
        self.memo.clear()
        self.generation = next(_GENERATIONS)
        folder = os.path.dirname(self.path) or "."
        os.makedirs(folder, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=folder, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(data, f, indent=0, sort_keys=True)
            os.replace(tmp, self.path)
        except OSError:
            # an unwritable cache keeps the winner in this process only
            try:
                os.unlink(tmp)
            except OSError:
                pass


_default_cache: PlanCache | None = None


def default_cache() -> PlanCache:
    global _default_cache
    if _default_cache is None:
        _default_cache = PlanCache()
    return _default_cache


def reset_default_cache(path: str | None = None) -> PlanCache:
    """(Re)point the process-wide cache (a fresh memo with it)."""
    global _default_cache
    _default_cache = PlanCache(path)
    return _default_cache


def generation() -> int:
    """The process-wide cache's generation: equal between two calls
    exactly when no plan it answers can have changed."""
    return default_cache().generation


@functools.lru_cache(maxsize=None)
def _card(device) -> str:
    if device is not None and torch.device(device).type == "cpu":
        return "cpu"
    return torch.cuda.get_device_name(device)


@functools.lru_cache(maxsize=1)
def _source() -> str:
    return _build.source_hash()


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------
def _wrapper(kernel: str, fused: bool):
    tdg, vlg = _modules()
    return {("decode", True): tdg.ternary_decode_gemm_fused,
            ("decode", False): tdg.ternary_decode_gemm,
            ("lookup", True): vlg.vlut_lookup_gemm_fused,
            ("lookup", False): vlg.vlut_lookup_gemm,
            ("decode_grouped", True): tdg.ternary_decode_gemm_fused_grouped,
            ("decode_grouped", False): tdg.ternary_decode_gemm_grouped,
            ("lookup_grouped", True): vlg.vlut_lookup_gemm_fused_grouped,
            ("lookup_grouped", False): vlg.vlut_lookup_gemm_grouped}[kernel, fused]


def _replay_ms(graph, replays: int) -> float:
    """Median device ms of one replay of `graph`, between two events."""
    graph.replay()                                          # warm-up
    times = []
    for _ in range(replays):
        s, t = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        t.record()
        t.synchronize()
        times.append(s.elapsed_time(t))
    return sorted(times)[len(times) // 2]


def _graph(fn, launches: int, flush=None):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            if flush is not None:
                flush()
            fn()
    return graph


def default_benchmark(kernel: str, g: int, m: int, kg: int, n: int, *, e: int | None,
                      fused: bool, device: torch.device, dtype=torch.bfloat16,
                      out_dtype=torch.bfloat16) -> Callable:
    """→ run(plan) → seconds per launch of the family's kernel on random
    seeded operands on the card (codes in [0, 3^g), activations N(0, 9)
    in `dtype`, or int8 in [-127, 127]; `run.inputs`: the wrapper's
    operands before `g`). Each candidate's output is first held bit-equal
    to the heuristic plan's (`run.reference`) on the same operands: a
    difference is a fault of the port and raises. Then a CUDA graph of
    `LAUNCHES` launches is replayed (`REPLAYS` times after a warm-up,
    between two events; the median); where the operands fit in the L2
    cache, each launch follows a 50 MB write that flushes it, and a graph
    of the flushes alone is subtracted."""
    from repro_torch.core.quantize import act_token_scale

    tdg, _ = _modules()
    kern = _wrapper(kernel, fused)
    gen = torch.Generator(device=device).manual_seed(0)
    lead = () if e is None else (e,)
    packed = torch.randint(0, 3 ** g, (*lead, m, kg), generator=gen, device=device,
                           dtype=torch.uint8)
    if fused:
        x = (torch.randn((*lead, n, kg * g), generator=gen, device=device) * 3).to(dtype)
        a_scale = act_token_scale(x.reshape(-1, kg * g).T).reshape(*lead, n).contiguous()
        w_scale = torch.rand((*lead, m), generator=gen, device=device) + 0.5
        args, kw = (x, a_scale, w_scale), {"g": g, "out_dtype": out_dtype}
        claims = tdg.fused_aligned(packed, x) if kernel == "decode" else (False, False)
        nbytes = packed.numel() + x.numel() * x.element_size()
    else:
        a_r = torch.randint(-127, 128, (*lead, g, kg, n), generator=gen, device=device,
                            dtype=torch.int8)
        args, kw = (a_r,), {"g": g}
        claims = tdg.int_aligned(packed, a_r) if kernel == "decode" else (False, False)
        nbytes = packed.numel() + a_r.numel()
    size = "small" if nbytes < L2_BYTES else "large"
    launches, replays = LAUNCHES[size], REPLAYS[size]
    flush = None
    if size == "small":
        buf = torch.empty(L2_BYTES, dtype=torch.uint8, device=device)
        flush = buf.zero_
        flush_ms = _replay_ms(_graph(flush, launches), replays)
    ref = kern(packed, *args, plan=with_claims(heuristic(kernel, g, m, kg, n, e=e), *claims), **kw)

    def run(plan) -> float:
        plan = with_claims(plan, *claims)
        out = kern(packed, *args, plan=plan, **kw)
        if not torch.equal(out, ref):
            raise AssertionError(f"{kernel} ({'fused' if fused else 'integer'}): plan {plan} "
                                 "differs from the heuristic plan's output")
        del out
        ms = _replay_ms(_graph(lambda: kern(packed, *args, plan=plan, **kw), launches, flush),
                        replays)
        return (ms - (flush_ms if flush is not None else 0.0)) / launches / 1e3

    run.inputs, run.reference = (packed, *args), ref
    return run


@dataclasses.dataclass
class TuneResult:
    plan: object
    seconds: float
    trials: list


def tune(kernel: str, g: int, m: int, kg: int, n: int, *, e: int | None = None,
         fused: bool = True, device=None, card: str | None = None,
         cache: PlanCache | None = None, benchmark: Callable | None = None,
         candidates: Iterable | None = None) -> TuneResult:
    """Time every candidate (`candidate_plans` unless given), persist the
    fastest, return it. `benchmark(plan) → seconds` defaults to
    `default_benchmark` on `device` (a CUDA device: the default one when
    None), bf16 in and out. `card`: the key's device name (JAX's
    `backend`), by default `device`'s. A
    candidate loses only where its launch runs out of device memory (a
    split-K workspace too large); any other failure raises. If every
    candidate loses, the heuristic plan is returned and nothing cached.
    The winner is fed to the installed `Obs` (`record_kernel_sample`,
    seconds per expert for a grouped launch). Each timed candidate adds one
    to `tune.trials`."""
    _check_kernel(kernel, e)
    if _capturing():
        raise RuntimeError("autotune: no tuning inside a CUDA-graph capture")
    if benchmark is None:
        device = torch.device("cuda") if device is None else torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"autotune: the kernels are timed on a CUDA device, got {device}")
        benchmark = default_benchmark(kernel, g, m, kg, n, e=e, fused=fused, device=device)
    cache = cache if cache is not None else default_cache()
    cands = list(candidates) if candidates is not None else candidate_plans(
        kernel, g, m, kg, n, e=e)
    trials = []
    for p in cands:
        try:
            seconds = float(benchmark(p))
        except torch.cuda.OutOfMemoryError:
            continue
        tune.trials += 1
        trials.append((p, seconds))
    if not trials:
        return TuneResult(heuristic(kernel, g, m, kg, n, e=e), math.inf, trials)
    best, best_s = min(trials, key=lambda t: t[1])
    key = cache_key(kernel, g, m, kg, n, e=e, fused=fused,
                    card=card or _card(device), source=_source())
    cache.put(key, fields_of(kernel, best), best_s)
    o = obs_mod.current()
    if o is not None:
        o.record_kernel_sample(g=g, impl=kernel, m=m, kg=kg, n=n, fused=fused,
                               seconds=best_s / (e or 1))
    return TuneResult(best, best_s, trials)


tune.trials = 0


def get_plan(kernel: str, g: int, m: int, kg: int, n: int, *, e: int | None = None,
             fused: bool = True, device=None, card: str | None = None,
             codes_aligned: bool = False, acts_aligned: bool = False,
             cache: PlanCache | None = None, tune_if_missing: bool | None = None,
             benchmark: Callable | None = None):
    """The plan of one launch: the cached winner (with the operands'
    alignment claims) if there is a legal one; else, on a miss, a plan
    tuned inline where asked for (``REPRO_VLUT_AUTOTUNE=1`` or
    `tune_if_missing`) and possible (not on the CPU, not inside a CUDA-graph
    capture); else the heuristic plan. `card` (the key's device name, JAX's
    `backend`) defaults to `device`'s. Repeated calls cost one lookup in
    the cache's memo (not kept for a tuning call inside a capture, so that
    a later eager call tunes)."""
    cache = cache if cache is not None else default_cache()
    want = tune_if_missing if tune_if_missing is not None else os.environ.get(TUNE_ENV) == "1"
    memo_key = (kernel, fused, g, m, kg, n, e, codes_aligned, acts_aligned, device, card, want)
    plan = cache.memo.get(memo_key)
    if plan is not None:
        return plan
    _check_kernel(kernel, e)
    key = cache_key(kernel, g, m, kg, n, e=e, fused=fused, card=card or _card(device),
                    source=_source())
    fields = cache.get(key)
    if fields is not None and set(fields) == set(FIELDS[kernel]):
        plan = make_plan(kernel, g, m, kg, n, fields, e=e, codes_aligned=codes_aligned,
                         acts_aligned=acts_aligned)
        if not legal(kernel, plan):
            plan = None
    capturing = _capturing()
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if plan is None and want and not (capturing or on_cpu):
        plan = with_claims(tune(kernel, g, m, kg, n, e=e, fused=fused, device=device, card=card,
                                cache=cache, benchmark=benchmark).plan,
                           codes_aligned, acts_aligned)
    if plan is None:
        plan = with_claims(heuristic(kernel, g, m, kg, n, e=e), codes_aligned, acts_aligned)
    if not (capturing and want):
        cache.memo[memo_key] = plan
    return plan
