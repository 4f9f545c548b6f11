"""R2 — re-planning and re-capture hazards (the port's counterpart of
`repro.lint.rules_recompile`).

The port compiles nothing per step: its steps run eagerly, and what a step
pays again on a new shape is its launch planning (the `lru_cache`d plan
functions and `autotune`'s memo) and, where a step is replayed as a CUDA
graph, its capture. So R2 guards those, one rule id, the finding's message
naming the sub-pattern:

R2/cache-in-loop     a `functools.lru_cache` / `functools.cache` wrapper made
                     inside a for/while body (or a def so decorated there):
                     each iteration starts an empty cache, so every call
                     plans again.
R2/cache-immediate   ``lru_cache(...)(fn)(args)`` / ``cache(fn)(args)``: a
                     wrapper made and dropped in one expression, its cache
                     never reused.
R2/graph-in-loop     a ``torch.cuda.graph(...)`` capture or a
                     ``CUDAGraph()`` made inside a loop body: a capture per
                     iteration instead of one capture replayed.
R2/unhashable-key    a list, dict or set literal passed to an `lru_cache`d
                     plan function (`PLAN_FUNCTIONS`, or a function this
                     module decorates): the call raises TypeError, since the
                     cache key must hash (use a tuple).
"""
from __future__ import annotations

import ast
from typing import Iterable

from .core import Finding, LintModule, rule

#: the port's cached launch-plan functions (kernels/*.py)
PLAN_FUNCTIONS = frozenset({"decode_plan", "lut_plan", "grouped_decode_plan",
                            "grouped_lut_plan", "flash_plan"})
_CACHE_DECOS = {"lru_cache", "cache"}


def _call_name(node: ast.Call) -> str:
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def _is_cache_wrapper(node: ast.AST) -> bool:
    """``lru_cache(...)`` / ``functools.cache``-style: a call of
    `lru_cache`, or ``functools.cache(fn)``."""
    if not isinstance(node, ast.Call):
        return False
    name = _call_name(node)
    if name == "lru_cache":
        return True
    return name == "cache" and isinstance(node.func, ast.Attribute) and isinstance(
        node.func.value, ast.Name) and node.func.value.id == "functools"


def _cached_defs(tree: ast.AST) -> set[str]:
    out = set()
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in fn.decorator_list:
                d = dec.func if isinstance(dec, ast.Call) else dec
                name = d.attr if isinstance(d, ast.Attribute) else getattr(d, "id", "")
                if name in _CACHE_DECOS:
                    out.add(fn.name)
    return out


def _is_graph_capture(node: ast.Call) -> bool:
    """``torch.cuda.graph(...)`` or ``CUDAGraph()``."""
    name = _call_name(node)
    if name == "CUDAGraph":
        return True
    f = node.func
    return name == "graph" and isinstance(f, ast.Attribute) and isinstance(
        f.value, ast.Attribute) and f.value.attr == "cuda"


@rule("R2", "re-planning hazard (plan cache made in a loop or thrown away, "
            "graph capture in a loop, unhashable plan-cache key)")
def check_recompile(mod: LintModule) -> Iterable[Finding]:
    cached = PLAN_FUNCTIONS | _cached_defs(mod.tree)
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and mod.in_loop(node):
            for dec in node.decorator_list:
                d = dec.func if isinstance(dec, ast.Call) else dec
                name = d.attr if isinstance(d, ast.Attribute) else getattr(d, "id", "")
                if name in _CACHE_DECOS:
                    yield Finding(
                        "R2", mod.path, node.lineno, node.col_offset,
                        f"R2/cache-in-loop: `@{name}` def `{node.name}` inside a loop "
                        f"body starts an empty cache every iteration — hoist it above "
                        f"the loop",
                    )
            continue
        if not isinstance(node, ast.Call):
            continue
        if _is_cache_wrapper(node):
            parent = mod.parents.get(node)
            # lru_cache(maxsize=...)(fn)(args): the wrapped call is the parent
            # of the parent; cache(fn)(args): the parent
            outer = parent if _call_name(node) == "cache" else (
                mod.parents.get(parent) if isinstance(parent, ast.Call)
                and parent.func is node else None)
            if isinstance(outer, ast.Call) and outer.func is (
                    node if _call_name(node) == "cache" else parent):
                yield Finding(
                    "R2", mod.path, node.lineno, node.col_offset,
                    "R2/cache-immediate: a cache wrapper made and called in one "
                    "expression is never reused — hoist the cached callable out of "
                    "the call expression",
                )
            elif mod.in_loop(node):
                yield Finding(
                    "R2", mod.path, node.lineno, node.col_offset,
                    "R2/cache-in-loop: a cache wrapper made inside a loop body starts "
                    "an empty cache every iteration — hoist it above the loop",
                )
            continue
        if _is_graph_capture(node) and mod.in_loop(node):
            yield Finding(
                "R2", mod.path, node.lineno, node.col_offset,
                f"R2/graph-in-loop: `{mod.text(node.func)}(...)` inside a loop body "
                f"captures a CUDA graph every iteration — capture once above the "
                f"loop and replay it",
            )
            continue
        name = _call_name(node)
        if name in cached:
            for arg in [*node.args, *(kw.value for kw in node.keywords)]:
                if isinstance(arg, (ast.List, ast.Dict, ast.Set)):
                    yield Finding(
                        "R2", mod.path, arg.lineno, arg.col_offset,
                        f"R2/unhashable-key: {type(arg).__name__.lower()} literal "
                        f"passed to the cached plan function `{name}` — its cache key "
                        f"must hash (use a tuple)",
                    )
