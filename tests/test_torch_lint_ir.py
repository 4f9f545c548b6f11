"""repro_torch.lint.ir, the passes over the port's traced op streams: a
firing and a clean fixture for each pass I0–I5 (a promoted-f32 decode for
I1, a `.item()` inside a step for I2, a dead product for I3, a forced-tiny
factor for I4, a stale and a missing snapshot for I5), the registry (traced
once per module: every `step_entries()` name covered, every snapshot
committed, retraces hash identically, `pinned_trace_env` restores the
environment, the JAX registry's names all present), the port clean under
every pass, the I4 model equal to `mpgemm_cost` for each kernel operator
with the measured traffic ratios, and the trace records' ids (with
`step_stats` unchanged on an id-free record)."""
import json
import os
import pathlib

import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.lint.ir import registry as jax_registry  # noqa: E402
from repro_torch.core.packing import unpack_ternary  # noqa: E402
from repro_torch.kernels import autotune, ops  # noqa: E402
from repro_torch.kernels import ternary_decode_gemm as tdg  # noqa: E402
from repro_torch.lint import ir  # noqa: E402
from repro_torch.lint.ir import registry  # noqa: E402
from repro_torch.lint.ir.core import IREntry  # noqa: E402
from repro_torch.lint.ir.snapshots import signature, snapshot_dir  # noqa: E402
from repro_torch.lint.ir.traffic import estimate_bytes, model_bytes  # noqa: E402
from repro_torch.roofline.analysis import mpgemm_cost  # noqa: E402
from repro_torch.roofline.hlo_stats import (  # noqa: E402
    Trace,
    kernel_cost,
    op_traffic,
    step_stats,
    trace_step,
    trace_step_partial,
)
from repro_torch.serve import Engine, PagedKVConfig  # noqa: E402
from repro_torch.spec import SpecConfig  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
SNAPSHOTS = ROOT / "tests" / "torch_ir_snapshots"
#: estimate / mpgemm_cost bytes at registry.FULL_MS's worst M, measured on
#: the CPU trace (the eager traffic model counts the same ops on any
#: device); registry.TRAFFIC_FACTORS sits ~2x above each
MEASURED_RATIOS = {"vlut": 157.13, "vlut_packed_fused": 4.95, "vlut_packed_unfused": 6.52,
                   "vlut_packed_lookup_fused": 4.95, "vlut_packed_lookup_unfused": 6.52,
                   "scalar_lut": 129.07, "mad_dense": 164.73, "mad_int8": 106.50}


@pytest.fixture(scope="module")
def entries():
    return ir.default_entries(full=True)


def fake(*shape, dtype=torch.float32, mode):
    with mode:
        return torch.zeros(shape, dtype=dtype)


def entry_of(fn, *args, name="fixture", **meta):
    trace, _ = trace_step_partial(fn, *args)
    return IREntry(name=name, trace=trace, kind="step", meta=meta)


# --------------------------------------------------------------------------
# I0 — registry suppressions
# --------------------------------------------------------------------------
def test_i0_under_justified_suppression():
    mode = FakeTensorMode()
    e = entry_of(lambda x: x + 1, fake(4, mode=mode))
    e.suppress = {"I4": "ok"}
    assert [f.rule for f in ir.run_passes([e], select={"I4"})] == ["I0"]
    e.suppress = {"I3": "a dead op kept on purpose here"}
    dead = entry_of(lambda x, w: (x @ w, x + 1)[1], fake(4, 4, mode=mode), fake(4, 4, mode=mode))
    dead.suppress = e.suppress
    assert ir.run_passes([dead], select={"I3"}) == []


# --------------------------------------------------------------------------
# I1 — quantized-dtype flow
# --------------------------------------------------------------------------
def _packed(mode):
    return fake(8, 4, dtype=torch.uint8, mode=mode), fake(3, 20, mode=mode), fake(8, mode=mode)


def test_i1_flags_a_promoted_f32_decode():
    mode = FakeTensorMode()
    packed, x, _ = _packed(mode)
    e = entry_of(lambda p, a: a @ unpack_ternary(p, 5).to(torch.float32).T, packed, x)
    fs = ir.run_passes([e], select={"I1"})
    assert [f.rule for f in fs] == ["I1"] and "aten::mm" in fs[0].message


@pytest.mark.parametrize("how", ["scaled", "kernel", "int_product"])
def test_i1_clean_datapaths(how):
    mode = FakeTensorMode()
    packed, x, scale = _packed(mode)
    if how == "scaled":       # the dequant mul before the product
        fn = lambda p, a, s: a @ (unpack_ternary(p, 5).to(torch.float32) * s[:, None]).T  # noqa: E731
    elif how == "kernel":     # the fused kernel's operator
        fn = lambda p, a, s: tdg.ternary_decode_gemm_fused(  # noqa: E731
            p, a, a.abs().amax(-1) / 127, s, g=5)
    else:                     # integers all the way
        fn = lambda p, a, s: torch.matmul(  # noqa: E731
            a.to(torch.int32), unpack_ternary(p, 5).to(torch.int32).T)
    assert ir.run_passes([entry_of(fn, packed, x, scale)], select={"I1"}) == []


def test_i1_index_operands_carry_no_taint():
    """Codes used as LUT indices are the method: a gather by codes feeding a
    float product is clean."""
    mode = FakeTensorMode()
    packed, _, _ = _packed(mode)
    table = fake(243, 6, mode=mode)
    e = entry_of(lambda p, t: t[p.long()].sum(1) @ t.T, packed, table)
    assert ir.run_passes([e], select={"I1"}) == []


# --------------------------------------------------------------------------
# I2 — effects
# --------------------------------------------------------------------------
@pytest.mark.parametrize("fn, op", [
    (lambda x: x * x.sum().item(), "_local_scalar_dense"),
    (lambda x: x[torch.nonzero(x > 0)[:, 0]], "nonzero"),
    (lambda x: x[x > 0], "index"),
], ids=["item", "nonzero", "bool_mask"])
def test_i2_flags_a_host_sync_inside_a_step(fn, op):
    mode = FakeTensorMode()
    e = entry_of(fn, fake(8, mode=mode))
    assert e.trace.stopped["op"].endswith(op)
    fs = ir.run_passes([e], select={"I2"})
    assert [f.rule for f in fs] == ["I2"] and "stopped" in fs[0].message


def _copy_trace(src_derived: bool) -> Trace:
    """A hand-made record: one `_to_copy` from the cpu to the card, of an
    argument (or of a constant the step built)."""
    src = [0, 0, "cpu"] if src_derived else [5, 5, "cpu"]
    op = {"op": "aten::_to_copy", "args": [["T", [4], "float32"]], "kwargs": {},
          "out": ["T", [4], "float32"], "view": False, "inplace": False,
          "ids": {"in": [src], "out": [[1, 1, "cuda:0"]]}}
    return Trace([op], {"argument": 16, "output": 16, "alias": 0, "peak_temp": 16},
                 arguments=[[0, 0, "cpu", [4], "float32"]], outputs=[[1, 1, "cuda:0", [4], "float32"]])


@pytest.mark.parametrize("derived, n", [(True, 1), (False, 0)])
def test_i2_copies_of_argument_data_across_devices(derived, n):
    fs = ir.run_passes([IREntry("copy", _copy_trace(derived))], select={"I2"})
    assert len(fs) == n and all("cuda:0" in f.message for f in fs)


def test_i2_clean_step():
    mode = FakeTensorMode()
    e = entry_of(lambda x: torch.argmax(x * 2, -1), fake(2, 8, mode=mode))
    assert e.trace.stopped is None and ir.run_passes([e], select={"I2"}) == []


# --------------------------------------------------------------------------
# I3 — dead code
# --------------------------------------------------------------------------
def test_i3_flags_a_dead_product():
    mode = FakeTensorMode()

    def step(x, w):
        x @ w                      # computed, dropped
        return x + 1

    fs = ir.run_passes([entry_of(step, fake(4, 4, mode=mode), fake(4, 4, mode=mode))],
                       select={"I3"})
    assert [f.rule for f in fs] == ["I3"] and "aten::mm" in fs[0].message


def test_i3_flags_a_large_dead_intermediate():
    mode = FakeTensorMode()
    fs = ir.run_passes([entry_of(lambda x: (x.repeat(64, 1), x.sum())[1],
                                 fake(64, 64, mode=mode))], select={"I3"})
    assert [f.rule for f in fs] == ["I3"]


def test_i3_live_through_outputs_arguments_and_views():
    mode = FakeTensorMode()

    def into_argument(out, x, w):
        out[:2].copy_(x @ w)        # an in-place write into an argument: live
        return None

    def through_a_view(x, w):
        tmp = torch.zeros(4, 4)
        tmp[1:3].copy_((x @ w)[:2])  # written through a view, read through the base
        return tmp.sum()

    for fn, args in ((into_argument, (fake(4, 4, mode=mode), fake(2, 4, mode=mode),
                                      fake(4, 4, mode=mode))),
                     (through_a_view, (fake(4, 4, mode=mode), fake(4, 4, mode=mode))),
                     (lambda x, w: x @ w, (fake(4, 4, mode=mode), fake(4, 4, mode=mode)))):
        assert ir.run_passes([entry_of(fn, *args)], select={"I3"}) == []


# --------------------------------------------------------------------------
# I4 — traffic against mpgemm_cost
# --------------------------------------------------------------------------
def test_i4_forced_tiny_factor_fires(entries):
    e = next(e for e in entries if e.name == "mpgemm/vlut_packed_fused/M16")
    assert ir.run_passes([e], select={"I4"}) == []
    tiny = IREntry(e.name, e.trace, meta=dict(e.meta, traffic_factor=0.01))
    fs = ir.run_passes([tiny], select={"I4"})
    assert [f.rule for f in fs] == ["I4"] and "0.01x" in fs[0].message


def test_i4_measured_ratios_and_factors(entries):
    """The ratios `registry.TRAFFIC_FACTORS` were set from, at FULL_MS's
    worst M: each still measures within 5%, each factor ~2x above it."""
    worst: dict = {}
    for e in entries:
        if e.kind == "mpgemm":
            r = estimate_bytes(e.trace) / model_bytes(e.meta)
            worst[e.meta["impl"]] = max(worst.get(e.meta["impl"], 0.0), r)
    assert set(worst) == set(MEASURED_RATIOS)
    for impl, r in worst.items():
        factor = registry.TRAFFIC_FACTORS.get(impl, ir.traffic.DEFAULT_FACTOR)
        assert r == pytest.approx(MEASURED_RATIOS[impl], rel=0.05), impl
        assert 1.5 * r <= factor <= 2.5 * r, impl


def test_i4_model_equals_mpgemm_cost_per_kernel_operator(entries):
    """A kernel operator's share of the traffic estimate is `mpgemm_cost`'s
    bytes of its own product (`hlo_stats.kernel_cost`)."""
    seen = set()
    for e in entries:
        if e.kind != "mpgemm" or "packed" not in e.meta["impl"]:
            continue
        for op in e.trace.ops:
            if not op["op"].startswith("repro_torch::"):
                continue
            name = op["op"].split("::")[1]
            fused = name.endswith("_fused")
            packed, g = op["args"][0][1], int(op["args"][4] if fused else op["args"][2])
            n = op["args"][1][1][0] if fused else op["args"][1][1][-1]
            want = mpgemm_cost(packed[0], packed[1] * g, n, g, fused=fused)[1]
            assert op_traffic(op) == kernel_cost(op)[1] == want
            seen.add(name)
    assert seen == {"ternary_decode_gemm_fused", "ternary_decode_gemm",
                    "vlut_lookup_gemm_fused", "vlut_lookup_gemm"}


# --------------------------------------------------------------------------
# I5 — snapshots
# --------------------------------------------------------------------------
def test_i5_missing_stale_and_updated(entries, tmp_path):
    e = next(e for e in entries if e.name == "engine/decode")
    root = str(tmp_path)
    fs = ir.run_passes([e], select={"I5"}, snapshot_root=root)
    assert [f.rule for f in fs] == ["I5"] and "no golden snapshot" in fs[0].message
    assert ir.run_passes([e], select={"I5"}, snapshot_root=root, update_snapshots=True) == []
    assert ir.run_passes([e], select={"I5"}, snapshot_root=root) == []
    path = pathlib.Path(snapshot_dir(root, "cpu")) / "engine__decode.json"
    snap = json.loads(path.read_text())
    snap["hash"], snap["ops"]["aten::mm"] = "0" * 64, snap["ops"].get("aten::mm", 0) + 1
    path.write_text(json.dumps(snap))
    fs = ir.run_passes([e], select={"I5"}, snapshot_root=root)
    assert [f.rule for f in fs] == ["I5"] and "diverged" in fs[0].message
    assert "aten::mm" in fs[0].message


def test_i5_retraces_hash_identically(entries):
    fresh = {e.name: e for e in ir.mpgemm_entries()}
    for e in entries:
        if e.name in ("mpgemm/vlut_packed_fused/M16", "mpgemm/mad_int8/M1"):
            assert signature(fresh[e.name].trace) == signature(e.trace)
    decode = next(e for e in entries if e.name == "engine/decode")
    again = next(e for e in ir.engine_entries() if e.name == "engine/decode")
    assert signature(again.trace) == signature(decode.trace)


def test_i5_hash_leaves_out_ids_and_devices(entries):
    e = next(e for e in entries if e.name == "mpgemm/vlut_packed_fused/M1")
    t = e.trace
    moved = Trace([dict(op, ids={"in": [[i + 100, s + 100, "cuda:0"] for i, s, _ in op["ids"]["in"]],
                                 "out": [[i + 100, s + 100, "cuda:0"]
                                         for i, s, _ in op["ids"]["out"]]})
                   for op in t.ops], t.memory,
                  arguments=[[a[0] + 1, a[1] + 1, "cuda:0", a[3], a[4]] for a in t.arguments],
                  outputs=[[a[0] + 1, a[1] + 1, "cuda:0", a[3], a[4]] for a in t.outputs])
    assert signature(moved) == signature(t)


# --------------------------------------------------------------------------
# the registry
# --------------------------------------------------------------------------
def test_registry_covers_every_step_entry_name(entries):
    mode = FakeTensorMode()
    cfg, params = registry._smoke_params("smollm-360m", "cpu", mode)
    with mode:
        engines = [
            Engine(params, cfg, max_slots=2, max_len=64, prefill_chunk=16, device="cpu",
                   paged_kv=PagedKVConfig(page_size=16),
                   spec=SpecConfig(k=2, drafter="model", draft_params=params, draft_cfg=cfg)),
            Engine(params, cfg, max_slots=2, max_len=64, device="cpu",
                   spec=SpecConfig(k=2, drafter="ngram", tree=(2,))),
        ]
    names = set().union(*(e.step_entries() for e in engines))
    assert names == {"prefill1", "decode", "chunk_verify", "set_tab", "scrub", "verify",
                     "compact", "drafter.prefill", "drafter.verify", "drafter.decode"}
    assert names <= {e.meta["step"] for e in entries if "step" in e.meta}


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_every_snapshot_is_committed(entries, device):
    """A snapshot for every entry of the full registry, and no stale file;
    the card's set (cuda/) differs from the CPU's only where a trace on the
    card copies a host constant to it (the draft tree's)."""
    have = {p.stem for p in (SNAPSHOTS / device).glob("*.json")}
    assert have == {e.name.replace("/", "__") for e in entries}
    if device == "cuda":
        differ = {p.stem for p in (SNAPSHOTS / "cuda").glob("*.json")
                  if json.loads(p.read_text())["hash"]
                  != json.loads((SNAPSHOTS / "cpu" / p.name).read_text())["hash"]}
        assert differ == {"engine__tree_verify"}


def test_registry_includes_the_jax_registry_names(entries):
    """Every name of `repro.lint.ir.default_entries(full=True)` has its
    counterpart here under the same name: the JAX full registry's names as
    its committed snapshots hold them (the JAX coverage test keeps the two
    equal; JAX's passes fail under jax 0.9, so only names are compared)."""
    assert (jax_registry.QUICK_MS, jax_registry.FULL_MS, jax_registry.MPGEMM_SHAPE) == (
        registry.QUICK_MS, registry.FULL_MS, registry.MPGEMM_SHAPE)
    jax_names = {p.stem.replace("__", "/")
                 for p in (ROOT / "tests" / "ir_snapshots" / "cpu").glob("*.json")}
    assert len(jax_names) == 42
    names = {e.name for e in entries}
    assert jax_names <= names
    assert names - jax_names == {f"mpgemm/vlut_packed_lookup_{f}/M{m}"
                                 for f in ("fused", "unfused") for m in registry.FULL_MS}


def test_pinned_trace_env_restores_environment(tmp_path):
    cache_path = str(tmp_path / "user.json")
    os.environ[autotune.TUNE_ENV] = "1"
    os.environ[autotune.CACHE_ENV] = cache_path
    prev = autotune.default_cache()
    impl, fusion = ops.dispatch_config().impl, ops.dispatch_config().fusion
    try:
        with registry.pinned_trace_env():
            assert (ops.dispatch_config().impl, ops.dispatch_config().fusion) == ("decode", "fused")
            assert os.environ[autotune.TUNE_ENV] == "0"
            assert autotune.CACHE_ENV not in os.environ
            assert autotune.default_cache() is not prev
            assert not os.path.exists(autotune.default_cache().path)
        assert os.environ[autotune.TUNE_ENV] == "1"
        assert os.environ[autotune.CACHE_ENV] == cache_path
        assert autotune.default_cache() is prev
        assert (ops.dispatch_config().impl, ops.dispatch_config().fusion) == (impl, fusion)
    finally:
        os.environ.pop(autotune.TUNE_ENV, None)
        os.environ.pop(autotune.CACHE_ENV, None)


def test_port_is_ir_clean(entries):
    """The acceptance gate, as a test: every pass, the committed CPU
    snapshots included, finds nothing in the full registry."""
    fs = ir.run_passes(entries)
    assert fs == [], "\n".join(f.format() for f in fs)


# --------------------------------------------------------------------------
# the trace records' ids
# --------------------------------------------------------------------------
def test_trace_records_carry_ids():
    mode = FakeTensorMode()
    x, w = fake(4, 4, mode=mode), fake(4, 4, mode=mode)

    def step(x, w):
        v = x.view(16)
        y = x @ w
        x.add_(1)
        return y, v

    trace, _ = trace_step(step, x, w)
    view, mm, add = trace.ops
    (xi, xs, dev), (wi, ws, _) = trace.arguments[0][:3], trace.arguments[1][:3]
    assert dev == "cpu" and trace.arguments[0][3:] == [[4, 4], "float32"]
    assert view["ids"]["in"] == [[xi, xs, "cpu"]] and view["ids"]["out"][0][1] == xs
    assert mm["ids"]["in"] == [[xi, xs, "cpu"], [wi, ws, "cpu"]]
    assert add["ids"]["out"] == [[xi, xs, "cpu"]]                # in place: the same tensor
    assert [o[:2] for o in trace.outputs] == [mm["ids"]["out"][0][:2], view["ids"]["out"][0][:2]]
    again = Trace.from_json(trace.to_json())
    assert again == trace


def test_step_stats_unchanged_on_id_free_records(entries):
    """An older record (no ids, arguments, outputs or stop) reads back and
    gives the same statistics; a pass that needs ids refuses it."""
    e = next(e for e in entries if e.name == "engine/decode")
    old = json.loads(e.trace.to_json())
    for op in old["ops"]:
        del op["ids"]
    bare = Trace.from_json(json.dumps({k: old[k] for k in ("ops", "memory", "seconds")}))
    assert bare.arguments == [] and bare.outputs == [] and bare.stopped is None
    assert step_stats(bare) == step_stats(e.trace)
    with pytest.raises(ValueError, match="no tensor ids"):
        ir.run_passes([IREntry("old", bare)], select={"I1"})


def test_real_cases_match_the_traced_entries():
    """The registry's cases on real tensors (what `chip_smoke.py` phase 19
    runs on the card) are the traced entries, name for name, and each runs
    (twice, as phase 19 (c) runs it: a warm-up, then the checked run)."""
    with registry.pinned_trace_env():
        real = registry.engine_cases(full=True, device="cpu")
        mp = registry.mpgemm_cases(device="cpu")
        for _, _, fn, args, _ in real:
            fn(*args)
            fn(*args)
        for _, fn, args, _ in mp:
            assert fn(*args).shape == (registry.MPGEMM_SHAPE[0], args[1].shape[1])
    assert [c[0] for c in real] == [e.name for e in ir.engine_entries(full=True)]
    assert [c[0] for c in mp] == [e.name for e in ir.mpgemm_entries()]


def test_qat_step_with_flash_is_ir_clean():
    """The smoke QAT step (flash attention, remat) is clean under I1–I4.
    I3 found the flash backward recomputing the attention output through
    the plain version only to differentiate it (its last product and cast
    were dead in every layer); the backward now differentiates the
    probabilities and the product with v by hand, bit for bit what
    autograd through the plain version gives."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.steps import make_train_step, meta_model
    from repro_torch.models import stacked_shapes
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.roofline.hlo_stats import fake_module

    cfg = get_config("smollm-360m", smoke=True).with_(attn_impl="flash")
    opt_cfg = AdamWConfig()
    mode = FakeTensorMode()
    model = fake_module(meta_model(cfg), "cpu", mode).requires_grad_(True)
    with mode:
        params = dict(model.named_parameters())
        state = {"params": params, "opt": adamw_init(params, opt_cfg, stacked_shapes(model, cfg))}
        batch = {"tokens": torch.zeros((2, 32), dtype=torch.int32),
                 "labels": torch.zeros((2, 32), dtype=torch.int32)}
    trace, _ = trace_step(make_train_step(cfg, opt_cfg), model, state, batch)
    assert sum(op["op"] == "repro_torch::flash_attention" for op in trace.ops) == 2 * cfg.n_layers
    assert ir.run_passes([IREntry("train", trace, kind="step")],
                         select={"I1", "I2", "I3", "I4"}) == []
    gen = torch.Generator().manual_seed(0)
    for dtype, causal, window, softcap in ((torch.float32, True, 0, 0.0),
                                           (torch.bfloat16, True, 24, 20.0)):
        q, k, v = (torch.randn(shape, generator=gen).to(dtype).requires_grad_()
                   for shape in ((2, 6, 40, 32), (2, 2, 40, 32), (2, 2, 40, 32)))
        g = torch.randn((2, 6, 40, 32), generator=gen).to(dtype)
        want = torch.autograd.grad(fa.flash_attention_plain(
            q, k, v, causal=causal, window=window, softcap=softcap), (q, k, v), g)
        got = torch.autograd.grad(fa.flash_attention_trainable(q, k, v, causal, window, softcap),
                                  (q, k, v), g)
        assert all(torch.equal(a, b) for a, b in zip(want, got))
