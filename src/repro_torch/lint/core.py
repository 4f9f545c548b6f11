"""repro_torch.lint core: file walking, rule registry, suppressions,
reporting (a copy of `repro.lint.core`, which the port may not import).

The analyzer is a plain-AST pass (no imports of the linted code, no type
inference): each rule registers a ``check(module) -> Iterable[Finding]``
callable and receives a `LintModule` — the parsed tree plus cheap derived
structure (parent links, per-line comments, suppression map). Heuristics are
deliberately textual where the hazard is textual (e.g. R1's cache-name match)
— the point is mechanically catching known bug classes, not general
soundness. The rule catalog is in the package docstring.

Suppression contract (verified, not free-form):

    leaf[slot:slot + 1] = one  # lint: disable=R1 -- slot is a host int

One comment suppresses the named rule(s) on its own line and, when the
comment stands alone on a line, on the following line. The justification
after ``--`` is mandatory and must carry at least three words; a bare or
under-justified suppression is itself reported (rule R0, unsuppressable).
A syntax error is reported as E0. `report_json` writes the JAX package's
schema.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import json
import os
import re
import tokenize
from typing import Callable, Iterable, Iterator

#: rule id -> (one-line description, check callable)
_REGISTRY: dict[str, tuple[str, Callable[["LintModule"], Iterable["Finding"]]]] = {}

_SUPPRESS_RE = re.compile(
    r"#\s*lint:\s*disable=([A-Za-z0-9_,\s]+?)\s*(?:--|—)\s*(.*)$"
)
_SUPPRESS_ANY_RE = re.compile(r"#\s*lint:\s*disable")

#: minimum justification: three words — "slot is host-int" style, not "ok"
MIN_JUSTIFICATION_WORDS = 3


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Suppression:
    line: int
    rules: tuple[str, ...]
    justification: str
    standalone: bool  # comment is the whole line -> also covers line + 1

    @property
    def covered_lines(self) -> tuple[int, ...]:
        return (self.line, self.line + 1) if self.standalone else (self.line,)


def rule(rule_id: str, description: str):
    """Decorator registering ``check(module) -> Iterable[Finding]``."""

    def deco(fn):
        _REGISTRY[rule_id] = (description, fn)
        fn.rule_id = rule_id
        fn.description = description
        return fn

    return deco


def registered_rules() -> dict[str, str]:
    return {rid: desc for rid, (desc, _) in sorted(_REGISTRY.items())}


class LintModule:
    """One parsed source file + the derived structure rules need."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.tree = ast.parse(source, filename=path)
        self.lines = source.splitlines()
        self._parents: dict[ast.AST, ast.AST] | None = None
        self.comments: list[tuple[int, str, bool]] = self._scan_comments(source)
        self.suppressions: list[Suppression] = []
        self.bad_suppressions: list[tuple[int, str]] = []
        self._collect_suppressions()

    # -- structure ---------------------------------------------------------
    @property
    def parents(self) -> dict[ast.AST, ast.AST]:
        if self._parents is None:
            self._parents = {}
            for node in ast.walk(self.tree):
                for child in ast.iter_child_nodes(node):
                    self._parents[child] = node
        return self._parents

    def ancestors(self, node: ast.AST) -> Iterator[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            yield cur
            cur = self.parents.get(cur)

    def enclosing_function(self, node: ast.AST):
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                return anc
        return None

    def in_loop(self, node: ast.AST) -> bool:
        """True when `node` sits inside a for/while *body* without an
        intervening function definition (a nested def is a new scope whose
        execution frequency the loop does not determine — a def in a loop
        that jits per iteration is still caught: the jit call's own chain
        passes the For before any FunctionDef only if inline)."""
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.For, ast.While)):
                return True
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                return False
        return False

    def text(self, node: ast.AST) -> str:
        try:
            return ast.unparse(node)
        except Exception:  # pragma: no cover - unparse is total on 3.9+
            return ""

    # -- comments / suppressions ------------------------------------------
    @staticmethod
    def _scan_comments(source: str) -> list[tuple[int, str, bool]]:
        out: list[tuple[int, str, bool]] = []
        try:
            toks = tokenize.generate_tokens(io.StringIO(source).readline)
            for tok in toks:
                if tok.type == tokenize.COMMENT:
                    standalone = tok.line[: tok.start[1]].strip() == ""
                    out.append((tok.start[0], tok.string, standalone))
        except tokenize.TokenizeError:  # pragma: no cover - parse succeeded
            pass
        return out

    def _collect_suppressions(self) -> None:
        for line, comment, standalone in self.comments:
            m = _SUPPRESS_RE.search(comment)
            if not m:
                if _SUPPRESS_ANY_RE.search(comment):
                    # disable marker without the required `--` separator
                    self.bad_suppressions.append(
                        (line, "malformed suppression: use "
                               "`# lint: disable=<RULES> -- <justification>`")
                    )
                continue
            rules = tuple(
                r.strip() for r in m.group(1).split(",") if r.strip()
            )
            justification = m.group(2).strip()
            if len(justification.split()) < MIN_JUSTIFICATION_WORDS:
                self.bad_suppressions.append(
                    (line, f"suppression of {','.join(rules)} lacks a "
                           f"justification (≥{MIN_JUSTIFICATION_WORDS} words "
                           f"after `--`)")
                )
                continue
            self.suppressions.append(
                Suppression(line, rules, justification, standalone)
            )

    def suppressed(self, rule_id: str, line: int) -> bool:
        for s in self.suppressions:
            if rule_id in s.rules and line in s.covered_lines:
                return True
        return False


def iter_py_files(paths: Iterable[str]) -> Iterator[str]:
    for p in paths:
        if os.path.isfile(p) and p.endswith(".py"):
            yield p
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(
                d for d in dirs
                if not d.startswith(".") and d != "__pycache__"
            )
            for f in sorted(files):
                if f.endswith(".py"):
                    yield os.path.join(root, f)


def lint_file(path: str, select: set[str] | None = None) -> list[Finding]:
    with open(path, encoding="utf-8") as f:
        source = f.read()
    return lint_source(source, path, select=select)


def lint_source(
    source: str, path: str = "<string>", select: set[str] | None = None
) -> list[Finding]:
    try:
        mod = LintModule(path, source)
    except SyntaxError as e:
        return [Finding("E0", path, e.lineno or 1, e.offset or 0,
                        f"syntax error: {e.msg}")]
    findings: list[Finding] = []
    # R0 — bad suppressions are findings themselves and cannot be suppressed
    if select is None or "R0" in select:
        for line, msg in mod.bad_suppressions:
            findings.append(Finding("R0", path, line, 0, msg))
    for rid, (_desc, check) in sorted(_REGISTRY.items()):
        if select is not None and rid not in select:
            continue
        for f in check(mod):
            if not mod.suppressed(f.rule, f.line):
                findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def lint_paths(
    paths: Iterable[str], select: set[str] | None = None
) -> tuple[list[Finding], int]:
    """-> (findings, files_scanned)."""
    findings: list[Finding] = []
    n = 0
    for path in iter_py_files(paths):
        n += 1
        findings.extend(lint_file(path, select=select))
    return findings, n


def report_json(findings: list[Finding], files_scanned: int) -> dict:
    counts: dict[str, int] = {}
    for f in findings:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    return {
        "version": 1,
        "files_scanned": files_scanned,
        "rules": registered_rules(),
        "counts": counts,
        "findings": [f.as_dict() for f in findings],
    }


def write_json(path: str, findings: list[Finding], files_scanned: int) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(report_json(findings, files_scanned), f, indent=1)
        f.write("\n")
