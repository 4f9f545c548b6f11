"""R5 — launch geometry and the on-chip memory budget (the port's
counterpart of `repro.lint.rules_pallas`).

The port's kernels are CUDA C entries bound with ctypes: nothing checks a
call's arity against the C signature (a short call passes garbage for the
trailing arguments, a long one is silently cut), and a plan whose shared
memory passes the card's per-block limit fails only at launch, on the
card. Both are checkable here:

R5/entry-arity   each call of a C entry through the loaded library
                 (``load().<entry>(...)``) passes as many arguments as the
                 entry's C signature has parameters, and each ctypes
                 signature (``_ARGTYPES = {"<entry>": [...]}``) declares as
                 many. The signature is read from the ``extern "C"`` entry
                 in the ``csrc/*.cu`` beside the linted package (macros of
                 the parameter list expanded); starred arguments count when
                 they are a tuple literal, a constant slice, or a call of a
                 module function that returns a tuple literal.
R5/smem-budget   each kernel module's default plans stay within the card's
                 `SMEM_PER_BLOCK` (227 KB, an H100's dynamic shared memory a
                 block) at the ternary group sizes g ∈ {4, 5}: the plans
                 (`decode_plan`, `lut_plan`, their grouped twins and
                 `flash_plan`) at the shapes the model zoo launches, each
                 plan's bytes from the module's own ``*_smem_bytes`` helper,
                 as JAX's R5 reads `autotune.tile_vmem_bytes`.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Iterable

from .core import Finding, LintModule, rule

#: dynamic shared memory one block may take on an H100 (227 KB)
SMEM_PER_BLOCK = 232448
_SUPPORTED_G = (4, 5)

_ENTRY_RE = re.compile(r'extern\s+"C"\s+[\w\s\*]+?\b(\w+)\s*\(([^)]*)\)\s*\{', re.S)
_DEFINE_RE = re.compile(r"#define\s+(\w+)\s*\\?\n((?:[^\n]*\\\n)*[^\n]*)")


# --------------------------------------------------------------------------
# R5/entry-arity
# --------------------------------------------------------------------------
def c_entries(csrc: str) -> dict[str, int]:
    """{entry name: parameter count} of every ``extern "C"`` function in the
    ``*.cu`` files of `csrc` (a parameter-list macro expanded)."""
    out: dict[str, int] = {}
    for name in sorted(os.listdir(csrc)):
        if not name.endswith(".cu"):
            continue
        with open(os.path.join(csrc, name), encoding="utf-8") as f:
            text = f.read()
        macros = {m.group(1): m.group(2).replace("\\\n", " ")
                  for m in _DEFINE_RE.finditer(text)}
        for m in _ENTRY_RE.finditer(text):
            params = m.group(2).strip()
            params = macros.get(params, params)
            out[m.group(1)] = 0 if params in ("", "void") else len(params.split(","))
    return out


def _find_csrc(path: str) -> str | None:
    """The ``csrc`` folder of the package a module lies in: a sibling of
    the module's folder or of one of its two parents."""
    d = os.path.dirname(os.path.abspath(path))
    for _ in range(3):
        cand = os.path.join(d, "csrc")
        if os.path.isdir(cand):
            return cand
        d = os.path.dirname(d)
    return None


def _tuple_returns(tree: ast.AST) -> dict[str, ast.Tuple]:
    """Module functions whose every return is a tuple literal of one length."""
    out = {}
    for fn in tree.body if isinstance(tree, ast.Module) else []:
        if not isinstance(fn, ast.FunctionDef):
            continue
        rets = [n.value for n in ast.walk(fn) if isinstance(n, ast.Return)]
        if rets and all(isinstance(r, ast.Tuple) for r in rets) and len(
                {len(r.elts) for r in rets}) == 1:
            out[fn.name] = rets[0]
    return out


def _count_args(args: list, funcs: dict) -> int | None:
    """Positional arguments of a call, starred ones resolved; None where
    one cannot be counted statically."""
    n = 0
    for a in args:
        if not isinstance(a, ast.Starred):
            n += 1
            continue
        v = a.value
        if isinstance(v, (ast.Tuple, ast.List)):
            sub = _count_args(v.elts, funcs)
        elif isinstance(v, ast.Call) and isinstance(v.func, ast.Name) and v.func.id in funcs:
            sub = _count_args(funcs[v.func.id].elts, funcs)
        elif (isinstance(v, ast.Subscript) and isinstance(v.slice, ast.Slice)
              and v.slice.step is None and all(
                  b is None or (isinstance(b, ast.Constant) and isinstance(b.value, int)
                                and b.value >= 0) for b in (v.slice.lower, v.slice.upper))
              and v.slice.upper is not None):
            sub = v.slice.upper.value - (v.slice.lower.value if v.slice.lower else 0)
        else:
            return None
        if sub is None:
            return None
        n += sub
    return n


def _list_len(node: ast.AST, names: dict) -> int | None:
    """Length of a statically built list: literals, ``[x] * n``, sums and
    module-level names of such."""
    if isinstance(node, (ast.List, ast.Tuple)):
        return len(node.elts)
    if isinstance(node, ast.Name) and node.id in names:
        return _list_len(names[node.id], names)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        a, b = _list_len(node.left, names), _list_len(node.right, names)
        return None if a is None or b is None else a + b
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        for seq, k in ((node.left, node.right), (node.right, node.left)):
            if isinstance(k, ast.Constant) and isinstance(k.value, int):
                n = _list_len(seq, names)
                return None if n is None else n * k.value
    return None


def _check_arity(mod: LintModule) -> Iterable[Finding]:
    csrc = _find_csrc(mod.path)
    if csrc is None:
        return
    entries = c_entries(csrc)
    if not entries:
        return
    funcs = _tuple_returns(mod.tree)
    names = {t.id: n.value for n in (mod.tree.body if isinstance(mod.tree, ast.Module) else [])
             if isinstance(n, ast.Assign) for t in n.targets if isinstance(t, ast.Name)}
    for node in ast.walk(mod.tree):
        # the ctypes signatures: {"<entry>": <list>} bound to _ARGTYPES
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "_ARGTYPES" for t in node.targets) \
                and isinstance(node.value, ast.Dict):
            for k, v in zip(node.value.keys, node.value.values):
                if not (isinstance(k, ast.Constant) and k.value in entries):
                    continue
                n = _list_len(v, names)
                if n is not None and n != entries[k.value]:
                    yield Finding(
                        "R5", mod.path, v.lineno, v.col_offset,
                        f"R5/entry-arity: the ctypes signature of `{k.value}` declares "
                        f"{n} argument(s) but its C entry takes {entries[k.value]}",
                    )
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr in entries and isinstance(node.func.value, ast.Call)):
            continue
        n = _count_args(node.args, funcs)
        want = entries[node.func.attr]
        if n is None:
            yield Finding(
                "R5", mod.path, node.lineno, node.col_offset,
                f"R5/entry-arity: the arguments of `{node.func.attr}` cannot be "
                f"counted statically — spell them out or star a tuple-returning helper",
            )
        elif n != want:
            yield Finding(
                "R5", mod.path, node.lineno, node.col_offset,
                f"R5/entry-arity: `{node.func.attr}` is called with {n} argument(s) "
                f"but its C entry takes {want}",
            )


# --------------------------------------------------------------------------
# R5/smem-budget
# --------------------------------------------------------------------------
#: (M, K) of the model zoo's BitLinears the budget is checked at, tokens N,
#: experts E and head dims D
_SHAPES = ((960, 960), (2560, 960), (960, 2560), (8192, 5120), (5120, 8192))
_TOKENS = (1, 4, 16, 64, 256, 6000)
_EXPERTS = (16, 256)
_HEAD_DIMS = (20, 64, 128, 256)


def _decode_plans():
    from repro_torch.kernels import ternary_decode_gemm as tdg

    for g in _SUPPORTED_G:
        for m, k in _SHAPES:
            for n in _TOKENS:
                yield "decode_plan", (m, k // g, n, g), tdg.decode_plan(m, k // g, n, g)
            for e in _EXPERTS:
                for c in _TOKENS[:4]:
                    yield ("grouped_decode_plan", (m, k // g, c, g, e),
                           tdg.grouped_decode_plan(m, k // g, c, g, e))


def _lut_plans():
    from repro_torch.kernels import vlut_lookup_gemm as vlg

    for g in _SUPPORTED_G:
        for m, k in _SHAPES:
            for n in _TOKENS:
                yield "lut_plan", (m, k // g, n, g), vlg.lut_plan(m, k // g, n, g)
            for e in _EXPERTS:
                for c in _TOKENS[:4]:
                    yield ("grouped_lut_plan", (m, k // g, c, g, e),
                           vlg.grouped_lut_plan(m, k // g, c, g, e))


def _flash_plans():
    import torch

    from repro_torch.kernels import flash_attention as fa

    for d in _HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            strides = ((1, 1, 1),) * 4
            yield ("flash_plan", (d, str(dtype).removeprefix("torch.")),
                   fa.flash_plan(8, 16, 512, 512, d, strides, dtype))


#: kernel module (path suffix) → (its smem helper, the plans to check)
KERNEL_MODULES = {
    "kernels/ternary_decode_gemm.py": ("decode_smem_bytes", _decode_plans),
    "kernels/vlut_lookup_gemm.py": ("lut_smem_bytes", _lut_plans),
    "kernels/flash_attention.py": ("mma_smem_bytes", _flash_plans),
}


def _check_smem(mod: LintModule) -> Iterable[Finding]:
    path = mod.path.replace("\\", "/")
    hit = next((v for k, v in KERNEL_MODULES.items() if path.endswith(k)), None)
    if hit is None:
        return
    helper, plans = hit
    at = next((n for n in ast.walk(mod.tree)
               if isinstance(n, ast.FunctionDef) and n.name == helper), None)
    if at is None:
        return
    for fn, args, plan in plans():
        if plan.smem > SMEM_PER_BLOCK:
            yield Finding(
                "R5", mod.path, at.lineno, at.col_offset,
                f"R5/smem-budget: the default `{fn}{args}` needs {plan.smem} B of "
                f"shared memory a block — over the card's {SMEM_PER_BLOCK} B",
            )
            return  # one budget finding per module is enough


@rule("R5", "launch geometry: C-entry arity of every ctypes call and "
            "signature, default plans' shared memory vs the card's per-block limit")
def check_launch(mod: LintModule) -> Iterable[Finding]:
    yield from _check_arity(mod)
    yield from _check_smem(mod)
