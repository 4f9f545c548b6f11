"""repro_torch.lint, the port's static analysis and runtime sanitizers:
one positive (flagged) and one negative (clean) fixture per rule R0–R5,
the suppression contract, the report and CLI, the port's own tree clean
under its linter, parity with `repro.lint` (R0, R4 and E0 findings equal
on every file of the port and on the JAX lint tests' fixtures; the port's
R3 flags every line the JAX R3 flags there), the sanitizer's three modes
and its restore, the smoke steps clean under it, and the steady-state
guard on the plan caches."""
import ast
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import repro.lint as jax_lint  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.kernels import ternary_decode_gemm as tdg  # noqa: E402
from repro_torch.launch.steps import make_decode_step, make_prefill_step, make_train_step  # noqa: E402
from repro_torch.lint import (  # noqa: E402
    DEFAULT_PATHS,
    CompileGuard,
    Probe,
    SanitizerError,
    enable_sanitizers,
    growth_probes,
    guard_entries,
    lint_paths,
    lint_source,
    registered_rules,
    report_json,
    restore_sanitizers,
    sanitizers_requested,
)
from repro_torch.lint import rules_launch  # noqa: E402
from repro_torch.models import init_cache, init_lm, pack_params, stacked_shapes  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
ENGINE = "src/repro_torch/serve/engine.py"          # R3 is path-scoped


def findings(src, path="x.py", select=None):
    return lint_source(textwrap.dedent(src), path, select=select)


def rules_of(fs):
    return [f.rule for f in fs]


def test_all_rules_registered():
    assert set(registered_rules()) == {"R1", "R2", "R3", "R4", "R5"}


# --------------------------------------------------------------------------
# R1 — cache writes without drop semantics
# --------------------------------------------------------------------------
@pytest.mark.parametrize("src", [
    "def f(cache, i, v):\n    cache[i] = v\n",
    "def f(kv_buf, i, v):\n    kv_buf.index_put_((i,), v)\n",
    "def f(leaf, i, v):\n    leaf.index_copy_(0, i, v)\n",
    "def f(state, i, v):\n    state.scatter_(0, i, v)\n",
    "def f(cache, i, v):\n    cache['k'][i].copy_(v)\n",
], ids=["subscript", "index_put_", "index_copy_", "scatter_", "copy_"])
def test_r1_flags_cache_writes(src):
    assert rules_of(findings(src)) == ["R1"]


@pytest.mark.parametrize("src", [
    # form 1: write_rows (the rule sees no index write)
    "def f(cache, s, v):\n    write_rows(cache['k'], s, v)\n",
    # form 2: a torch.where write-back of the target's own content
    "def f(leaf, b, s, keep, new):\n"
    "    leaf[b, s] = torch.where(keep, new, leaf[b, s])\n",
    # form 3: the paged write sink
    "def f(leaf, tab, s, v):\n"
    "    pg, off = page_phys(tab, s, 16, 8, for_write=True)\n"
    "    leaf[pg, off] = v\n",
    # the drop form's own definition
    "def write_rows(leaf, slots, values):\n    leaf[0, slots] = values\n",
    # host state: numpy, lists, dicts
    "import numpy as np\nclass E:\n    def __init__(self):\n        self.slot_free = [True] * 4\n"
    "        self.last_token = np.zeros((4, 1))\n"
    "    def f(self, s):\n        self.slot_free[s] = False\n        self.last_token[s, 0] = 1\n",
    # a dict key write, and a target that is no cache
    "def f(cache, tokens, v):\n    cache['k'] = v\n    tokens[0] = 1\n",
], ids=["write_rows", "where_write_back", "paged_sink", "drop_def", "host_state", "dict_key"])
def test_r1_drop_forms_are_clean(src):
    assert findings(src) == []


def test_r1_where_of_another_buffer_is_flagged():
    src = "def f(leaf, b, s, keep, new, old):\n    leaf[b, s] = torch.where(keep, new, old)\n"
    assert rules_of(findings(src)) == ["R1"]


# --------------------------------------------------------------------------
# R2 — re-planning hazards
# --------------------------------------------------------------------------
@pytest.mark.parametrize("src, what", [
    ("import functools\nfor n in range(3):\n    plan = functools.lru_cache(maxsize=None)(make)\n",
     "cache-in-loop"),
    ("import functools\nfor n in range(3):\n    @functools.lru_cache(maxsize=None)\n"
     "    def plan(m):\n        return m\n", "cache-in-loop"),
    ("import functools\nx = functools.lru_cache(maxsize=None)(make)(3)\n", "cache-immediate"),
    ("import functools\nx = functools.cache(make)(3)\n", "cache-immediate"),
    ("import torch\nfor n in range(3):\n    g = torch.cuda.CUDAGraph()\n", "graph-in-loop"),
    ("import torch\ng = None\nfor n in range(3):\n    with torch.cuda.graph(g):\n        f()\n",
     "graph-in-loop"),
    ("p = decode_plan(960, 192, [4], 5)\n", "unhashable-key"),
    ("import functools\n@functools.lru_cache\ndef plan(shape):\n    return shape\n"
     "p = plan({1: 2})\n", "unhashable-key"),
], ids=["wrapper_in_loop", "def_in_loop", "lru_immediate", "cache_immediate", "graph_obj",
        "graph_ctx", "plan_list", "local_cached_dict"])
def test_r2_flags(src, what):
    fs = findings(src)
    assert rules_of(fs) == ["R2"] and what in fs[0].message


def test_r2_hoisted_and_hashable_are_clean():
    src = """
    import functools
    import torch
    plan = functools.lru_cache(maxsize=None)(make)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for n in range(3):
            plan(n)
    for n in range(3):
        g.replay()
    p = decode_plan(960, 192, 4, 5)
    """
    assert findings(src) == []


# --------------------------------------------------------------------------
# R3 — host syncs on the serving hot path
# --------------------------------------------------------------------------
@pytest.mark.parametrize("body", [
    "t = logits[slot].item()",
    "t = logits[slot].tolist()",
    "t = logits[slot].cpu()",
    "t = logits.numpy()",
    "t = int(device_out[slot])",
    "t = bool(device_out[slot])",
    "t = np.asarray(device_out)",
    "torch.cuda.synchronize()",
], ids=["item", "tolist", "cpu", "numpy", "int", "bool", "np_asarray", "synchronize"])
def test_r3_flags_sync_in_loop(body):
    src = f"import numpy as np\ndef tick(self, logits, device_out):\n    for slot in range(8):\n        {body}\n"
    assert rules_of(findings(src, ENGINE)) == ["R3"]


def test_r3_batch_then_index_is_clean():
    src = """
    import numpy as np
    def tick(self, sampled, counts):
        nxt = np.asarray(sampled.cpu())          # one host copy per tick
        host = torch.cat([counts, sampled]).cpu().numpy()
        n_acc, out = host[:, 0], host[:, 1:]
        for slot in range(8):
            tok = int(nxt[slot])
            acc = int(n_acc[slot])
            more = [int(t) for t in out[slot]]
    """
    assert findings(src, ENGINE) == []


def test_r3_other_modules_not_in_scope():
    src = "def tick(self, logits):\n    for slot in range(8):\n        t = logits[slot].item()\n"
    assert findings(src, "src/repro_torch/models/decoder.py") == []


# --------------------------------------------------------------------------
# R4 — time.time
# --------------------------------------------------------------------------
@pytest.mark.parametrize("src, flagged", [
    ("import time\nt0 = time.time()\n", True),
    ("from time import time\n", True),
    ("import time\nt0 = time.perf_counter()\n", False),
])
def test_r4(src, flagged):
    assert rules_of(findings(src)) == (["R4"] if flagged else [])


# --------------------------------------------------------------------------
# R5 — C-entry arity and the shared-memory budget
# --------------------------------------------------------------------------
_CU = r'''
#define ENTRY_ARGS \
  const void *a, void *out, int n, \
  long long smem, void *stream
extern "C" int kern_a(ENTRY_ARGS) {
  return 0;
}
extern "C" int kern_b(const void* a, int n) { return 0; }
'''
_BUILD = '''
import ctypes
_ARGTYPES = {
    "kern_a": [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_longlong, ctypes.c_void_p],
    "kern_b": [ctypes.c_void_p] + [ctypes.c_int] * NB,
}
def _plan_args(plan):
    return plan.smem, plan.stream
def launch(a, out, n, plan):
    load().kern_a(a, out, NA, *_plan_args(plan))
    load().kern_b(a, *out.stride()[:1])
'''


def _r5(tmp_path, na="n", nb=1):
    pkg = tmp_path / "pkg"
    (pkg / "csrc").mkdir(parents=True)
    (pkg / "kernels").mkdir()
    (pkg / "csrc" / "k.cu").write_text(_CU)
    path = pkg / "kernels" / "_build.py"
    path.write_text(_BUILD.replace("NA", na).replace("NB", str(nb)))
    return lint_paths([str(path)])[0]


def test_r5_entry_arity_clean(tmp_path):
    assert _r5(tmp_path) == []
    assert rules_launch.c_entries(str(tmp_path / "pkg" / "csrc")) == {"kern_a": 5, "kern_b": 2}


def test_r5_entry_arity_flags_a_call(tmp_path):
    fs = _r5(tmp_path, na="n, n")
    assert rules_of(fs) == ["R5"] and "`kern_a` is called with 6" in fs[0].message


def test_r5_entry_arity_flags_a_signature(tmp_path):
    fs = _r5(tmp_path, nb=2)
    assert rules_of(fs) == ["R5"] and "signature of `kern_b` declares 3" in fs[0].message


def test_r5_entry_arity_on_the_port():
    """Every ctypes call and signature of the port's `_build` matches its
    C entry (and the rule counts all eleven entries)."""
    entries = rules_launch.c_entries(str(ROOT / "src" / "repro_torch" / "csrc"))
    assert len(entries) == 11 and entries["ternary_decode_gemm_fused"] == 24
    path = ROOT / "src" / "repro_torch" / "kernels" / "_build.py"
    src = path.read_text()
    assert lint_source(src, str(path), select={"R5"}) == []
    short = src.replace("plan.bm, plan.splits, plan.chunk, plan.smem, stream,\n    )\n    if rc != 0:\n"
                        "        raise RuntimeError(f\"vlut_lookup_gemm_fused:",
                        "plan.bm, plan.splits, plan.chunk, stream,\n    )\n    if rc != 0:\n"
                        "        raise RuntimeError(f\"vlut_lookup_gemm_fused:")
    assert short != src
    fs = lint_source(short, str(path), select={"R5"})
    assert [f.message for f in fs] == [
        "R5/entry-arity: `vlut_lookup_gemm_fused` is called with 20 argument(s) but its C "
        "entry takes 21"]


@pytest.mark.parametrize("module", ["ternary_decode_gemm", "vlut_lookup_gemm",
                                    "flash_attention"])
def test_r5_smem_budget(module, monkeypatch):
    """The default plans fit the card's 227 KB a block; a budget below them
    flags the module's smem helper."""
    path = ROOT / "src" / "repro_torch" / "kernels" / f"{module}.py"
    src = path.read_text()
    assert lint_source(src, str(path), select={"R5"}) == []
    monkeypatch.setattr(rules_launch, "SMEM_PER_BLOCK", 1024)
    fs = lint_source(src, str(path), select={"R5"})
    helper = rules_launch.KERNEL_MODULES[f"kernels/{module}.py"][0]
    assert rules_of(fs) == ["R5"] and "R5/smem-budget" in fs[0].message
    assert src.splitlines()[fs[0].line - 1].startswith(f"def {helper}(")


# --------------------------------------------------------------------------
# suppressions (R0) and E0
# --------------------------------------------------------------------------
FLAGGED = "def f(cache, i, v):\n    cache[i] = v{}\n"


@pytest.mark.parametrize("comment, rules", [
    ("  # lint: disable=R1 -- i is bounded by construction", []),
    ("  # lint: disable=R1 -- ok", ["R0", "R1"]),
    ("  # lint: disable=R1", ["R0", "R1"]),
    ("  # lint: disable=R4 -- wrong rule named here", ["R1"]),
    ("  # lint: disable=R4, R1 -- both rules named here", []),
], ids=["justified", "short", "malformed", "wrong_rule", "multi_rule"])
def test_suppressions(comment, rules):
    assert sorted(rules_of(findings(FLAGGED.format(comment)))) == rules


def test_standalone_comment_covers_next_line():
    src = ("def f(cache, i, v):\n    # lint: disable=R1 -- i is bounded by construction\n"
           "    cache[i] = v\n")
    assert findings(src) == []


def test_syntax_error_is_e0():
    assert rules_of(findings("def f(:\n")) == ["E0"]


# --------------------------------------------------------------------------
# report and CLI
# --------------------------------------------------------------------------
def test_json_report_shape():
    rep = report_json(findings("import time\nt = time.time()\n"), 1)
    assert rep["version"] == 1 and rep["files_scanned"] == 1
    assert rep["counts"] == {"R4": 1} and rep["findings"][0]["rule"] == "R4"
    assert set(rep["rules"]) == {"R1", "R2", "R3", "R4", "R5"}


def test_cli_exit_codes(tmp_path):
    clean, dirty, report = tmp_path / "ok.py", tmp_path / "bad.py", tmp_path / "r.json"
    clean.write_text("import time\nt0 = time.perf_counter()\n")
    dirty.write_text("import time\nt0 = time.time()\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}

    def run(*args):
        return subprocess.run([sys.executable, "-m", "repro_torch.lint", *args],
                              capture_output=True, text=True, env=env, cwd=ROOT)

    ok = run(str(clean))
    assert ok.returncode == 0, ok.stdout + ok.stderr
    bad = run(str(dirty), "--json", str(report))
    assert bad.returncode == 1 and "R4" in bad.stdout
    assert json.loads(report.read_text())["counts"] == {"R4": 1}
    assert run("--update-snapshots").returncode == 2        # IR flags need --ir
    listed = run("--list-rules")
    assert listed.returncode == 0 and "R5:" in listed.stdout


def test_port_is_lint_clean():
    """The acceptance gate, as a test: the port's default paths stay clean
    under its own linter."""
    paths = [str(p) for pat in DEFAULT_PATHS for p in sorted(ROOT.glob(pat))]
    fs, n = lint_paths(paths)
    assert n > 100
    assert fs == [], "\n".join(f.format() for f in fs)


# --------------------------------------------------------------------------
# parity with repro.lint
# --------------------------------------------------------------------------
def _jax_fixtures(classes: tuple) -> list[str]:
    """The source strings the JAX lint tests hand to `findings(...)` (and
    the class-level fixtures) in `classes`."""
    tree = ast.parse((ROOT / "tests" / "test_lint.py").read_text())
    out = []
    for cls in tree.body:
        if not (isinstance(cls, ast.ClassDef) and cls.name in classes):
            continue
        for node in ast.walk(cls):
            if (isinstance(node, ast.Call) and getattr(node.func, "id", "") == "findings"
                    and node.args and isinstance(node.args[0], ast.Constant)):
                out.append(textwrap.dedent(node.args[0].value))
            elif (isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant)
                  and isinstance(node.value.value, str) and isinstance(node.targets[0], ast.Name)
                  and node.targets[0].id.startswith("SRC")):
                out.append(node.value.value)
    return out


def _key(fs):
    return [(f.rule, f.line, f.col, f.message) for f in fs]


@pytest.mark.parametrize("path", sorted((ROOT / "src" / "repro_torch").rglob("*.py")),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_parity_r0_r4_e0_on_the_port(path):
    src = path.read_text()
    sel = {"R0", "R4", "E0"}
    assert _key(lint_source(src, str(path), select=sel)) == _key(
        jax_lint.lint_source(src, str(path), select=sel))


def test_parity_r0_r4_e0_on_the_jax_fixtures():
    fixtures = _jax_fixtures(("TestR4Timing", "TestSuppressions", "TestReport"))
    fixtures.append("def f(:\n")
    assert len(fixtures) >= 10
    sel = {"R0", "R4", "E0"}
    for src in fixtures:
        assert _key(lint_source(src, "x.py", select=sel)) == _key(
            jax_lint.lint_source(src, "x.py", select=sel)), src


def test_parity_r3_flags_every_jax_r3_line():
    fixtures = _jax_fixtures(("TestR3HostSync",))
    assert len(fixtures) >= 4
    flagged = 0
    for src in fixtures:
        want = {f.line for f in jax_lint.lint_source(src, "src/repro/serve/engine.py",
                                                     select={"R3"})}
        got = {f.line for f in lint_source(src, ENGINE, select={"R3"})}
        assert want <= got, src
        flagged += len(want)
    assert flagged >= 2


# --------------------------------------------------------------------------
# the sanitizer
# --------------------------------------------------------------------------
@pytest.mark.parametrize("fn, what", [
    (lambda: torch.ones(3) + torch.ones(2, 3), "rank promotion"),
    (lambda: torch.where(torch.ones(3, dtype=torch.bool), torch.ones(3), torch.ones(2, 3)),
     "rank promotion"),
    (lambda: torch.ones(3) * torch.ones(3, dtype=torch.float64), "dtype promotion"),
    (lambda: torch.ones(3).add_(torch.ones(3, dtype=torch.float16)), "dtype promotion"),
    (lambda: torch.zeros(3) / torch.zeros(3), "debug-NaNs"),
], ids=["rank", "where_rank", "dtype", "inplace_dtype", "nan"])
def test_sanitizer_modes_raise_and_restore(fn, what):
    prev = enable_sanitizers()
    try:
        with pytest.raises(SanitizerError, match=what):
            fn()
    finally:
        restore_sanitizers(prev)
    fn()                                      # restored: the same call passes


def test_sanitizer_allows_what_strict_jax_allows():
    prev = enable_sanitizers()
    try:
        x = torch.ones(2, 3)
        x * 2.0 + 1                                            # python scalars
        x * torch.ones(1, 3)                                   # same rank, size-1 axis
        torch.where(x > 0, x, torch.zeros(2, 3))               # the condition is no operand
        torch.empty(4)                                         # unwritten: no NaN check
        with pytest.raises(SanitizerError):
            x * torch.ones(3)
    finally:
        restore_sanitizers(prev)


def test_sanitizers_requested():
    assert sanitizers_requested({"REPRO_SANITIZE": "1"})
    assert not sanitizers_requested({"REPRO_SANITIZE": "0"}) and not sanitizers_requested({})


def test_smoke_steps_run_clean_under_the_sanitizer():
    """The smoke decode, prefill and QAT steps break none of the three
    rules (the port's explicit axes: `rmsnorm_apply`, `rope`, the trit
    unpacking), and sanitized decode tokens equal plain ones."""
    cfg = get_config("smollm-360m", smoke=True)
    model = pack_params(init_lm(cfg, torch.Generator().manual_seed(0)), cfg)
    decode, prefill = make_decode_step(cfg, device="cpu"), make_prefill_step(cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 16), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    plain_cache = init_cache(cfg, 2, 64, device="cpu")
    plain = prefill(model, plain_cache, {"tokens": tokens})[0]
    plain_next = decode(model, plain_cache, plain[:, None])[0]
    opt_cfg = AdamWConfig()
    tmodel = init_lm(cfg, torch.Generator().manual_seed(0)).requires_grad_(True)
    params = dict(tmodel.named_parameters())
    state = {"params": params, "opt": adamw_init(params, opt_cfg, stacked_shapes(tmodel, cfg))}
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    prev = enable_sanitizers()
    try:
        cache = init_cache(cfg, 2, 64, device="cpu")
        tok = prefill(model, cache, {"tokens": tokens})[0]
        nxt = decode(model, cache, tok[:, None])[0]
        _, metrics = make_train_step(cfg, opt_cfg)(tmodel, state, batch)
    finally:
        restore_sanitizers(prev)
    assert torch.equal(tok, plain) and torch.equal(nxt, plain_next)
    assert torch.isfinite(metrics["loss"])


# --------------------------------------------------------------------------
# the steady-state guard
# --------------------------------------------------------------------------
def test_compile_guard_on_the_plan_cache():
    tdg.decode_plan(960, 192, 4, 5)
    guard = CompileGuard({"decode_plan": tdg.decode_plan})
    guard.arm()
    tdg.decode_plan(960, 192, 4, 5)                  # a steady shape: a hit
    guard.assert_steady()
    tdg.decode_plan(960, 192, 10_000 + tdg.decode_plan.cache_info().currsize, 5)   # a new N
    assert guard.new_compiles() == {"decode_plan": 1}
    with pytest.raises(AssertionError, match="decode_plan"):
        guard.assert_steady()


def test_growth_probes_see_the_memo_and_the_plans(tmp_path):
    prev = autotune.default_cache()
    autotune.reset_default_cache(str(tmp_path / "plans.json"))
    try:
        guard = CompileGuard(growth_probes("cpu"))
        autotune.get_plan("decode", 5, 960, 192, 4, device="cpu")
        guard.arm()
        autotune.get_plan("decode", 5, 960, 192, 4, device="cpu")      # memo hit
        guard.assert_steady()
        autotune.get_plan("decode", 5, 960, 192, 7, device="cpu")      # a new N
        grew = guard.new_compiles()
        assert grew["autotune.memo"] == 1 and set(grew) <= {"autotune.memo",
                                                            "plan.decode_plan"}
        with pytest.raises(AssertionError, match="autotune.memo"):
            guard.assert_steady("the test's ticks")
    finally:
        autotune._default_cache = prev


def test_guard_entries_of_an_engine():
    from repro_torch.serve import Engine

    cfg = get_config("smollm-360m", smoke=True)
    eng = Engine(None, cfg, max_slots=2, max_len=32, device="cpu")
    probes = guard_entries(eng)
    assert {"plan.decode_plan", "plan.lut_plan", "plan.grouped_decode_plan",
            "plan.grouped_lut_plan", "plan.flash_plan", "autotune.memo", "autotune.trials",
            "build.builds", "build.loads", "splitk.cpu",
            "capture.prefill1", "capture.decode"} == set(probes)
    assert all(isinstance(p, Probe) for p in probes.values())
    assert guard_entries(object()) == {}
    guard = CompileGuard({"opaque": lambda: None, **probes})
    guard.arm()
    guard.assert_steady()                     # nothing ran: nothing grew; opaque counts 0
