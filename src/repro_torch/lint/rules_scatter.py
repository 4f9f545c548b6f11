"""R1 — in-place writes into a cache must carry the port's drop semantics
(the counterpart of `repro.lint.rules_scatter`).

The JAX package writes its KV/slot caches with ``.at[idx].set(v,
mode="drop")``: an out-of-range index is dropped. A PyTorch index write has
no such mode. A position past the buffer raises on the CPU and is a device
assert on the card (the process dies), and a negative one silently wraps
onto the buffer's end. The port therefore writes its caches in one of
three forms that drop a write with no host sync:

1. `dist.sharding.write_rows` (a keep mask writes the slot's current
   content back; on a sharded cache each device writes its own block);
2. a value built by ``torch.where`` over a keep mask, one of whose
   branches is the write's own target (the current content), written to
   wrapped slots: ``leaf[b, s] = torch.where(keep, new, leaf[b, s])``;
3. the paged write sink: the indices come from ``page_phys(...,
   for_write=True)``, which sends an unmapped or out-of-range target to a
   page no block table names.

Every other in-place write whose target looks like a cache buffer is a
finding: a subscript assignment (``leaf[i] = v``; a dict key write,
``cache["k"] = v``, is not a tensor write), ``index_put_``,
``index_copy_``, ``index_fill_``, ``scatter_``, and ``copy_`` into a
subscript. A write that
cannot go out of range (a host-int slot, a whole-buffer copy) carries a
justified suppression.

Target detection is JAX's name heuristic: the written expression's
identifier chain must contain one of `CACHE_NAME_PARTS`. Targets provably
on the host are exempt: a local name or an attribute assigned, anywhere in
the module, from an ``np.*`` call, a list, dict or set (literal or
comprehension) or ``[...] * n`` (the engine's per-slot bookkeeping).

The port's cache writes (`src/repro_torch`), each with what the rule sees:

- `models/attention.py` dense K/V/slot_pos: `write_rows` (form 1), with
  a `torch.where` keep mask for verify columns past the buffer;
- `models/attention.py` paged K/V/slot_pos: ``ck[pg, off] = ...`` through
  `page_phys(for_write=True)` (form 3; the names ``ck``/``cv``/``sp`` do
  not match);
- `models/mla.py` dense latents: `write_rows` with a keep mask (form 1);
  paged latents: `paged.page_scatter` (form 3; target ``pool``);
- `models/decoder.py` `compact_tree_cache`: ``leaf[bidx, dst_w] =
  torch.where(k_b, gathered, leaf[bidx, dst_w])`` (form 2);
- `models/decoder.py` `scatter_slot_cache`: ``leaf[slot:slot + 1] = ...``
  (a host-int slot: suppressed); `reset_slot_idx`: ``layer["idx"][slot]``
  (name does not match);
- `models/paged.py` `compact_paged_block` (form 3), `scrub_pages`
  (``sp.index_fill_(0, pages.clamp(...), -1)``: sentinels clamp into the
  sink; the name does not match), `restore_page`
  (``layer[key][page]``: a host-int page), `set_block_tables` (``copy_`` of
  the whole table);
- `dist/sharding.py` `write_rows` itself (form 1's definition).
"""
from __future__ import annotations

import ast
from typing import Iterable

from .core import Finding, LintModule, rule

#: substrings of identifiers that mark a write target as a cache buffer
#: (JAX's `CACHE_NAME_PARTS`, unchanged)
CACHE_NAME_PARTS = (
    "cache", "ckv", "krope", "slot", "last_token", "leaf", "buf", "kv",
    "state", "full",
)
#: in-place tensor writes by method
_WRITE_METHODS = {"index_put_", "index_copy_", "index_fill_", "scatter_"}
#: functions that are the drop form itself (their writes are the form)
_DROP_DEFS = {"write_rows"}


def _name_chain(node: ast.AST) -> list[str]:
    """Identifier parts of an attribute/subscript chain, outermost first:
    ``cache["k"][i]`` -> ["cache", "k"]."""
    parts: list[str] = []

    def walk(n: ast.AST) -> None:
        if isinstance(n, ast.Name):
            parts.append(n.id)
        elif isinstance(n, ast.Attribute):
            walk(n.value)
            parts.append(n.attr)
        elif isinstance(n, ast.Subscript):
            walk(n.value)
            if isinstance(n.slice, ast.Constant) and isinstance(n.slice.value, str):
                parts.append(n.slice.value)
        elif isinstance(n, ast.Call):
            walk(n.func)

    walk(node)
    return parts


def _is_cache_name(node: ast.AST) -> bool:
    return any(part in ident.lower() for ident in _name_chain(node)
               for part in CACHE_NAME_PARTS)


def _root_name(v: ast.AST) -> str | None:
    """The Name an attribute/call/subscript chain starts from."""
    while isinstance(v, (ast.Attribute, ast.Call, ast.Subscript)):
        v = v.func if isinstance(v, ast.Call) else v.value
    return v.id if isinstance(v, ast.Name) else None


def _is_host_value(v: ast.AST, host: set[str]) -> bool:
    """A list/dict/set (literal or comprehension), ``[...] * n``, or a
    chain rooted at numpy or at a host name (``rng.integers(...)``,
    ``slots[w]``)."""
    if isinstance(v, (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp, ast.SetComp)):
        return True
    if isinstance(v, ast.BinOp) and isinstance(v.op, ast.Mult):
        return isinstance(v.left, ast.List) or isinstance(v.right, ast.List)
    root = _root_name(v)
    return root is not None and (root in ("np", "numpy") or root in host)


def _host_targets(tree: ast.AST) -> set[str]:
    """Names and attribute names bound to a host value somewhere in the
    module (flow-insensitive, as R3's host analysis; to a fixpoint)."""
    binds = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            binds.append((node.targets, node.value))
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            binds.append(([node.target], node.value))
    out: set[str] = set()
    grew = True
    while grew:
        grew = False
        for targets, value in binds:
            if not _is_host_value(value, out):
                continue
            for t in targets:
                name = t.id if isinstance(t, ast.Name) else (
                    t.attr if isinstance(t, ast.Attribute) else None)
                if name is not None and name not in out:
                    out.add(name)
                    grew = True
    return out


def _written_base(target: ast.AST) -> ast.AST:
    """The buffer a subscript write lands in: ``a.b[i][j]`` -> ``a.b``
    (string-keyed subscripts are part of the buffer's name)."""
    while isinstance(target, ast.Subscript) and not (
            isinstance(target.slice, ast.Constant) and isinstance(target.slice.value, str)):
        target = target.value
    return target


def _last_ident(node: ast.AST) -> str | None:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _sink_names(fn: ast.AST) -> set[str]:
    """Names bound from ``page_phys(..., for_write=True)`` in `fn`."""
    out: set[str] = set()
    for node in ast.walk(fn):
        if not (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)):
            continue
        f = node.value.func
        name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")
        if name != "page_phys" or not any(
                kw.arg == "for_write" and isinstance(kw.value, ast.Constant)
                and kw.value.value is True for kw in node.value.keywords):
            continue
        for t in node.targets:
            for n in ast.walk(t):
                if isinstance(n, ast.Name):
                    out.add(n.id)
    return out


def _index_names(sub: ast.Subscript) -> set[str]:
    return {n.id for n in ast.walk(sub.slice) if isinstance(n, ast.Name)}


def _writes_back(value: ast.AST, target: ast.AST) -> bool:
    """Form 2: ``torch.where(keep, new, <target>)`` (either branch)."""
    if not isinstance(value, ast.Call):
        return False
    f = value.func
    name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")
    want = ast.unparse(target)
    return name == "where" and any(ast.unparse(a) == want for a in value.args[1:3])


@rule("R1", "in-place cache write without the port's drop semantics "
            "(write_rows, a torch.where write-back, or the paged write sink)")
def check_cache_writes(mod: LintModule) -> Iterable[Finding]:
    host = _host_targets(mod.tree)
    sinks: dict[ast.AST, set[str]] = {}

    def in_drop_def(node) -> bool:
        fn = mod.enclosing_function(node)
        return isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) and fn.name in _DROP_DEFS

    def is_host(target) -> bool:
        return _last_ident(_written_base(target)) in host

    def sink_indexed(node, sub: ast.Subscript) -> bool:
        fn = mod.enclosing_function(node)
        if fn is None:
            return False
        if fn not in sinks:
            sinks[fn] = _sink_names(fn)
        return bool(_index_names(sub) & sinks[fn])

    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if not isinstance(t, ast.Subscript) or (
                        isinstance(t.slice, ast.Constant) and isinstance(t.slice.value, str)):
                    continue
                base = _written_base(t)
                if not _is_cache_name(base) or is_host(t) or in_drop_def(node):
                    continue
                if isinstance(node, ast.Assign) and _writes_back(node.value, t):
                    continue
                if sink_indexed(node, t):
                    continue
                yield Finding(
                    "R1", mod.path, node.lineno, node.col_offset,
                    f"index write into cache-like target `{mod.text(base)}` "
                    f"without drop semantics — an out-of-range index is a "
                    f"device assert and a negative one wraps; use write_rows, a "
                    f"torch.where write-back or the paged sink, or justify why "
                    f"the index is in bounds",
                )
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            meth, target = node.func.attr, node.func.value
            if meth in _WRITE_METHODS:
                pass
            elif meth == "copy_" and isinstance(target, ast.Subscript) and not (
                    isinstance(target.slice, ast.Constant)
                    and isinstance(target.slice.value, str)):
                pass
            else:
                continue
            if not _is_cache_name(target) or is_host(target) or in_drop_def(node):
                continue
            yield Finding(
                "R1", mod.path, node.lineno, node.col_offset,
                f"`.{meth}` into cache-like target `{mod.text(target)}` "
                f"without drop semantics — an out-of-range index is a device "
                f"assert and a negative one wraps; use write_rows, a "
                f"torch.where write-back or the paged sink, or justify why "
                f"the index is in bounds",
            )
