"""The IR entry-point registry: what gets traced, at which shapes (the
counterpart of `repro.lint.ir.registry`, under JAX's entry names).

Two families, each run once on fake tensors (`hlo_stats.trace_step`: no
data, no launch, no allocation) of one device:

* ``mpgemm_entries`` — the mpGeMM impls (the paper's §5.1 vocabulary):
  {vlut, vlut_packed, scalar_lut, mad_dense, mad_int8}, the packed serving
  path in BOTH fusion modes through the kernels the card serves with —
  ``impl="decode"`` under JAX's names (``vlut_packed_fused`` /
  ``_unfused``: JAX traced its backend default there) and ``impl="lookup"``
  under names of their own (``vlut_packed_lookup_*``) — each at
  representative token counts M. Shapes carry (m_out, k, m_tokens, fused)
  meta for the I4 cross-check against `roofline.analysis.mpgemm_cost`.
* ``engine_entries`` — every `Engine.step_entries()` /
  `ModelDrafter.step_entries()` surface of the smoke-config engines JAX's
  registry builds: the base chunked-prefill engine (prefill1 / decode /
  chunk_verify), a ModelDrafter chain-spec engine (verify + drafter.*), an
  n-gram tree-spec engine (tree verify + compact), a paged engine
  (decode, chunk_verify, set_tab, scrub), a paged tree engine (compact),
  and with ``full`` the MLA and paged MLA engines. The engines are built
  on fake tensors (`hlo_stats.fake_module` of `launch.steps.meta_model`),
  and each entry is the engine's own callable: what serving dispatches.

Determinism: a trace must be a pure function of (code, device) or the I5
snapshots would flap. `pinned_trace_env()` therefore isolates an empty
plan cache (`autotune`), turns inline tuning off, and dispatches
explicitly (impl "decode", fused) for the duration of tracing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile

import numpy as np
import torch

from .core import IREntry

#: token counts every impl is traced at (the fast lane); M=16 is the chain
#: verify across slots, M=1 the single-token decode column
QUICK_MS = (1, 16)
#: the full registry adds the serving-burst shapes (chunk x slots, a burst)
FULL_MS = (1, 16, 48, 256)
#: representative layer shape: M_out x K (divisible by g=5 and g=4 packing)
MPGEMM_SHAPE = (256, 1280)
#: the smoke engines: slots, cache length, chunk, draft length, page size
SLOTS, MAX_LEN, CHUNK, K_DRAFT, PAGE = 2, 64, 16, 2, 16
#: I4 ceilings, ~2x over the estimate/model ratio measured at FULL_MS's worst
#: M (tests/test_torch_lint_ir.py writes the ratios): the reference impls
#: materialize the LUT (vlut ~157x, scalar_lut ~129x at M 256) or the
#: unpacked weight (mad_dense ~165x, mad_int8 ~107x at M 1); the packed
#: serving path's eager glue (transposes, scales, casts) ~5x fused and
#: ~6.5x unfused at M 256, DEFAULT_FACTOR covering the fused one
TRAFFIC_FACTORS = {"vlut": 320.0, "scalar_lut": 260.0, "mad_dense": 330.0,
                   "mad_int8": 215.0, "vlut_packed_unfused": 13.0,
                   "vlut_packed_lookup_unfused": 13.0}


@contextlib.contextmanager
def pinned_trace_env():
    """Deterministic tracing context: heuristic plans only (an isolated,
    empty plan cache, inline tuning off) and explicit dispatch (impl
    "decode", fused); the environment and the process's plan cache are
    restored after."""
    from repro_torch.kernels import autotune, ops

    saved = {k: os.environ.pop(k, None) for k in (autotune.TUNE_ENV, autotune.CACHE_ENV)}
    os.environ[autotune.TUNE_ENV] = "0"
    prev = autotune.default_cache()
    with tempfile.TemporaryDirectory(prefix="ir_plans_") as tmp:
        autotune.reset_default_cache(os.path.join(tmp, "plans.json"))   # empty, absent
        try:
            with ops.dispatch_override(impl="decode", fusion="fused"):
                yield
        finally:
            autotune._default_cache = prev
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v


def fake_packed(pw, device, mode):
    """A fake copy (shapes, strides, dtypes; no data) on `device` of a
    `PackedWeight`."""
    def fake(t):
        with mode:
            return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=device)

    return dataclasses.replace(pw, packed5=fake(pw.packed5), packed4=fake(pw.packed4),
                               scale=fake(pw.scale))


def _packed_pair(m_out: int, k: int, device):
    """(auto-packed, i2-packed) ternary weights on `device`, from a fixed
    seed."""
    from repro_torch.core import pack_weight, ternary_quantize

    w = np.random.default_rng(0).standard_normal((m_out, k)).astype(np.float32)
    tw = ternary_quantize(torch.from_numpy(w).to(device))
    return pack_weight(tw.values, tw.scale, "auto"), pack_weight(tw.values, tw.scale, "i2")


def _trace_entry(name, fn, args, *, kind, device, meta=None, suppress=None) -> IREntry:
    from repro_torch.roofline.hlo_stats import trace_step_partial

    trace, _ = trace_step_partial(fn, *args)
    return IREntry(name=name, trace=trace, kind=kind, meta=dict(meta or {}),
                   suppress=dict(suppress or {}), device=torch.device(device).type, fn=fn)


def mpgemm_combos():
    """(name, fn, weight index (0 auto, 1 i2), kwargs) of every traced impl."""
    from repro_torch.core import mad_gemm, mad_gemm_int8, scalar_lut_gemm, vlut_gemm
    from repro_torch.kernels import ops

    return [
        ("vlut", vlut_gemm, 1, {}),
        ("vlut_packed_fused", ops.vlut_mpgemm, 0, dict(impl="decode", fusion="fused")),
        ("vlut_packed_unfused", ops.vlut_mpgemm, 0, dict(impl="decode", fusion="unfused")),
        ("vlut_packed_lookup_fused", ops.vlut_mpgemm, 0, dict(impl="lookup", fusion="fused")),
        ("vlut_packed_lookup_unfused", ops.vlut_mpgemm, 0,
         dict(impl="lookup", fusion="unfused")),
        ("scalar_lut", scalar_lut_gemm, 1, {}),
        ("mad_dense", mad_gemm, 1, {}),
        ("mad_int8", mad_gemm_int8, 1, {}),
    ]


def _maker(device, mode):
    """(zeros(*shape, dtype=int32), the context models and caches are built
    in): fake tensors of `mode`, or real ones where `mode` is None."""
    ctx = mode if mode is not None else contextlib.nullcontext()

    def zeros(*shape, dtype=torch.int32):
        with ctx:
            return torch.zeros(shape, dtype=dtype, device=device)

    return zeros, ctx


def mpgemm_cases(full: bool = False, device="cpu", mode=None) -> list[tuple]:
    """(name, fn, args, meta) of every mpGeMM impl x fusion at each M, on
    fake tensors of `mode`, or real ones (the seeded weights) where `mode`
    is None."""
    m_out, k = MPGEMM_SHAPE
    zeros, _ = _maker(device, mode)
    if mode is None:
        weights = _packed_pair(m_out, k, device)
    else:
        weights = [fake_packed(w, device, mode) for w in _packed_pair(m_out, k, "cpu")]
    cases = []
    for name, fn, wi, kw in mpgemm_combos():
        for m in FULL_MS if full else QUICK_MS:
            meta = dict(impl=name, m_out=m_out, k=k, m_tokens=m, fused="unfused" not in name,
                        **({"traffic_factor": TRAFFIC_FACTORS[name]}
                           if name in TRAFFIC_FACTORS else {}))
            cases.append((f"mpgemm/{name}/M{m}", lambda w_, a_, fn=fn, kw=kw: fn(w_, a_, **kw),
                          (weights[wi], zeros(k, m, dtype=torch.float32)), meta))
    return cases


def mpgemm_entries(full: bool = False, device="cpu") -> list[IREntry]:
    """Trace every mpGeMM impl x fusion combination at each M."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cases = mpgemm_cases(full, device, FakeTensorMode())
    with pinned_trace_env():
        return [_trace_entry(name, fn, args, kind="mpgemm", device=device, meta=meta)
                for name, fn, args, meta in cases]


def _smoke_params(arch: str, device, mode):
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import meta_model
    from repro_torch.models import init_lm, pack_params
    from repro_torch.roofline.hlo_stats import fake_module

    cfg = get_config(arch, smoke=True)
    if mode is None:
        gen = torch.Generator(device=device).manual_seed(0)
        return cfg, pack_params(init_lm(cfg, gen), cfg)
    return cfg, fake_module(meta_model(cfg, packed=True), device, mode)


def engine_cases(full: bool = False, device="cpu", mode=None) -> list[tuple]:
    """(name, kind, fn, args, meta) of every distinct `Engine.step_entries()`
    / `ModelDrafter.step_entries()` name across the base, chain-spec
    (ModelDrafter oracle), tree-spec, paged and paged-tree engines (and,
    with `full`, the MLA and paged MLA engines): the engines' own callables
    and their arguments, fake tensors of `mode` or, where `mode` is None,
    real ones (the smoke models from seed 0)."""
    from repro_torch.models import init_cache
    from repro_torch.serve import Engine, PagedKVConfig
    from repro_torch.spec import SpecConfig

    zeros, ctx = _maker(device, mode)
    cases = []

    def case(name, step, fn, *args, kind="engine"):
        cases.append((f"engine/{name}", kind, fn, args, {"step": step}))

    def engine(params, cfg, **kw):
        with ctx:
            return Engine(params, cfg, max_slots=SLOTS, max_len=MAX_LEN, device=device, **kw)

    def single_cache(cfg):
        with ctx:
            return init_cache(cfg, 1, 16, device=device)

    cfg, params = _smoke_params("smollm-360m", device, mode)
    paged_cfg = PagedKVConfig(page_size=PAGE)
    base = engine(params, cfg, prefill_chunk=CHUNK)
    be = base.step_entries()
    t1 = zeros(1, 16)
    case("prefill1", "prefill1", be["prefill1"], params, single_cache(cfg), t1)
    case("decode", "decode", be["decode"], params, base.cache, zeros(SLOTS, 1))
    case("chunk_verify", "chunk_verify", be["chunk_verify"], params, base.cache,
         zeros(SLOTS, CHUNK), zeros(SLOTS, dtype=torch.int64))

    spec_eng = engine(params, cfg, spec=SpecConfig(
        k=K_DRAFT, drafter="model", draft_params=params, draft_cfg=cfg))
    se = spec_eng.step_entries()
    case("verify", "verify", se["verify"], params, spec_eng.cache, zeros(SLOTS, K_DRAFT + 1))
    case("drafter.prefill", "drafter.prefill", se["drafter.prefill"], params,
         single_cache(cfg), t1, kind="drafter")
    case("drafter.verify", "drafter.verify", se["drafter.verify"], params,
         spec_eng.drafter.cache, zeros(SLOTS, K_DRAFT + 1), kind="drafter")
    case("drafter.decode", "drafter.decode", se["drafter.decode"], params,
         spec_eng.drafter.cache, zeros(SLOTS, 1), kind="drafter")

    tree_eng = engine(params, cfg, spec=SpecConfig(k=K_DRAFT, drafter="ngram", tree=(2,)))
    te, n_nodes = tree_eng.step_entries(), tree_eng._tree.n_nodes
    case("tree_verify", "verify", te["verify"], params, tree_eng.cache, zeros(SLOTS, n_nodes))
    compact_args = (zeros(SLOTS, dtype=torch.int64), zeros(SLOTS, n_nodes, dtype=torch.int64),
                    zeros(SLOTS, dtype=torch.int64))
    case("compact", "compact", te["compact"], tree_eng.cache, *compact_args)

    # paged KV: decode/chunk_verify gather K/V through the block table, plus
    # the host pager's two flush entries (table copy + scrub) and the
    # tree-compact walk over a paged pool
    paged = engine(params, cfg, prefill_chunk=CHUNK, paged_kv=paged_cfg)
    pe = paged.step_entries()
    case("paged_decode", "decode", pe["decode"], params, paged.cache, zeros(SLOTS, 1))
    case("paged_chunk_verify", "chunk_verify", pe["chunk_verify"], params, paged.cache,
         zeros(SLOTS, CHUNK), zeros(SLOTS, dtype=torch.int64))
    case("set_tab", "set_tab", pe["set_tab"], paged.cache, zeros(SLOTS, MAX_LEN // PAGE))
    case("scrub", "scrub", pe["scrub"], paged.cache, zeros(paged_cfg.scrub_batch))

    paged_tree = engine(params, cfg, spec=SpecConfig(k=K_DRAFT, drafter="ngram", tree=(2,)),
                        paged_kv=paged_cfg)
    case("paged_compact", "compact", paged_tree.step_entries()["compact"], paged_tree.cache,
         *compact_args)

    if full:
        mla_cfg, mla_params = _smoke_params("deepseek-v3-671b", device, mode)
        mla = engine(mla_params, mla_cfg, prefill_chunk=CHUNK)
        me = mla.step_entries()
        case("mla_decode", "decode", me["decode"], mla_params, mla.cache, zeros(SLOTS, 1))
        case("mla_chunk_verify", "chunk_verify", me["chunk_verify"], mla_params, mla.cache,
             zeros(SLOTS, CHUNK), zeros(SLOTS, dtype=torch.int64))
        # paged MLA: the latent pool gathers through the same block tables
        # (ckv/krope leaves, no slot_pos: no scrub pass)
        pmla = engine(mla_params, mla_cfg, prefill_chunk=CHUNK, paged_kv=paged_cfg)
        pme = pmla.step_entries()
        case("paged_mla_decode", "decode", pme["decode"], mla_params, pmla.cache,
             zeros(SLOTS, 1))
        case("paged_mla_chunk_verify", "chunk_verify", pme["chunk_verify"], mla_params,
             pmla.cache, zeros(SLOTS, CHUNK), zeros(SLOTS, dtype=torch.int64))
    return cases


def engine_entries(full: bool = False, device="cpu") -> list[IREntry]:
    """Trace every `engine_cases` entry on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cases = engine_cases(full, device, FakeTensorMode())
    with pinned_trace_env():
        return [_trace_entry(name, fn, args, kind=kind, device=device, meta=meta)
                for name, kind, fn, args, meta in cases]


def default_entries(full: bool = False, device="cpu") -> list[IREntry]:
    """The registry `python -m repro_torch.lint --ir` runs: every mpGeMM
    impl x fusion combination plus every serving entry point."""
    return mpgemm_entries(full=full, device=device) + engine_entries(full=full, device=device)
