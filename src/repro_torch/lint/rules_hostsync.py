"""R3 — host-sync calls inside engine/scheduler hot-loop bodies (the
counterpart of `repro.lint.rules_hostsync`, with PyTorch's syncs added).

On a CUDA tensor each of these blocks the host until the device has
caught up, and copies the value back:

* ``x.item()``, ``x.tolist()``, ``x.cpu()``, ``x.numpy()``;
* ``int(x)``, ``float(x)``, ``bool(x)`` of a tensor;
* ``np.asarray(x)`` / ``np.array(x)`` of a tensor;
* ``torch.cuda.synchronize()`` (and the JAX package's
  ``block_until_ready``, kept so that the rule flags every line the JAX
  rule flags).

Inside the scheduler tick loop each one serializes the pipeline per
element: one batched copy at tick end (``np.asarray(t.cpu())``: the
engine's one host copy per tick) is the pattern this rule pushes code
toward.

Scope and precision (as in the JAX rule):

* Only the serving hot-path modules (`HOT_PATH_SUFFIXES`) are checked, and
  only calls lexically inside a for/while body.
* ``int()``/``float()``/``bool()`` are *not* flagged when the argument's
  base name was provably materialized on the host earlier in the same
  function: assigned from an ``np.*`` call, from a ``.numpy()`` /
  ``.tolist()`` result (``t.cpu().numpy()``), or bound by iterating such a
  value — ``nxt = np.asarray(t.cpu()); for s in ...: int(nxt[s])`` is the
  batch-then-index idiom.
* Anything the AST can't prove host-side (attribute state, helper-method
  returns) stays flagged; genuinely-host sites carry a justified
  suppression instead of a silent exemption.
"""
from __future__ import annotations

import ast
from typing import Iterable

from .core import Finding, LintModule, rule

#: modules where per-element host syncs are a throughput bug
HOT_PATH_SUFFIXES = (
    "serve/engine.py",
    "serve/scheduler.py",
)

_SYNC_BUILTINS = {"float", "int", "bool"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_SYNC_NP_FUNCS = {"asarray", "array"}
#: modules whose calls return host-resident numpy (never a device tensor)
_HOST_PRODUCERS = {"np", "numpy"}
#: tensor methods whose result lives on the host
_HOST_METHODS = {"numpy", "tolist"}


def _base_name(node: ast.AST) -> str | None:
    """Leftmost plain Name of a Name/Subscript/chained expression, or None
    when the base is an attribute/call (origin unknowable locally)."""
    while True:
        if isinstance(node, ast.Name):
            return node.id
        if isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Call) and isinstance(
            node.func, ast.Attribute
        ) and node.func.attr in ("copy", "astype", "reshape"):
            node = node.func.value
        else:
            return None


def _is_np_call(node: ast.AST) -> bool:
    """np.<anything>(...) — asarray/zeros/arange/full/concatenate/..."""
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    while isinstance(f, ast.Attribute):
        if isinstance(f.value, ast.Name) and f.value.id in _HOST_PRODUCERS:
            return True
        f = f.value
    return False


def _is_host_call(node: ast.AST) -> bool:
    """A call whose result is on the host: np.*, or ``.numpy()`` /
    ``.tolist()`` of a tensor (``t.cpu().numpy()``)."""
    return _is_np_call(node) or (
        isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
        and node.func.attr in _HOST_METHODS
    )


def _host_names(fn: ast.AST) -> set[str]:
    """Names in `fn` provably bound to host values (flow-insensitive: one
    host assignment marks the name for the whole function — good enough
    because the codebase never reuses a name for device and host data)."""
    host: set[str] = set()
    # pass 1: direct host assignments (incl. pairwise tuple assigns)
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign):
            continue
        pairs: list[tuple[ast.AST, ast.AST]] = []
        for tgt in node.targets:
            if isinstance(tgt, ast.Tuple) and isinstance(
                node.value, ast.Tuple
            ) and len(tgt.elts) == len(node.value.elts):
                pairs += list(zip(tgt.elts, node.value.elts))
            else:
                pairs.append((tgt, node.value))
        for tgt, val in pairs:
            if not isinstance(tgt, ast.Name):
                continue
            base = _base_name(val)
            if _is_host_call(val) or (base is not None and base in host):
                host.add(tgt.id)
    # pass 2: loop/comprehension targets iterating a host value
    for node in ast.walk(fn):
        if isinstance(node, (ast.For, ast.comprehension)):
            it, tgt = node.iter, node.target
        else:
            continue
        base = _base_name(it)
        if base in host and isinstance(tgt, ast.Name):
            host.add(tgt.id)
    return host


def _is_cuda_synchronize(f: ast.AST) -> bool:
    """``torch.cuda.synchronize`` / ``cuda.synchronize``."""
    return (isinstance(f, ast.Attribute) and f.attr == "synchronize"
            and isinstance(f.value, ast.Attribute) and f.value.attr == "cuda")


@rule("R3", "host-sync call (.item()/.cpu()/int(t)/np.asarray(t)/"
            "torch.cuda.synchronize) inside an engine/scheduler loop body")
def check_hostsync(mod: LintModule) -> Iterable[Finding]:
    if not mod.path.replace("\\", "/").endswith(HOT_PATH_SUFFIXES):
        return
    host_cache: dict[ast.AST, set[str]] = {}
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        if not mod.in_loop(node):
            continue
        f = node.func
        desc = None
        if isinstance(f, ast.Name) and f.id in _SYNC_BUILTINS and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                continue
            fn = mod.enclosing_function(node)
            if fn is not None:
                if fn not in host_cache:
                    host_cache[fn] = _host_names(fn)
                if _base_name(arg) in host_cache[fn]:
                    continue  # proven host value — no device round-trip
            desc = f"`{f.id}(...)`"
        elif _is_cuda_synchronize(f):
            desc = "`torch.cuda.synchronize()`"
        elif isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS:
            desc = f"`.{f.attr}()`"
        elif (
            isinstance(f, ast.Attribute)
            and f.attr in _SYNC_NP_FUNCS
            and isinstance(f.value, ast.Name)
            and f.value.id in _HOST_PRODUCERS
        ):
            desc = f"`np.{f.attr}(...)`"
        elif isinstance(f, ast.Attribute) and f.attr == "block_until_ready":
            desc = "`block_until_ready()`"
        if desc is None:
            continue
        yield Finding(
            "R3", mod.path, node.lineno, node.col_offset,
            f"{desc} inside a loop body on the serving hot path forces a "
            f"per-element host sync — batch the transfer outside the loop "
            f"(or justify: host-side data needs no device round-trip)",
        )
