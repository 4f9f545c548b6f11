"""R4 — wall-clock timing must use ``time.perf_counter`` (a copy of
`repro.lint.rules_timing`).

``time.time()`` is subject to NTP slews/steps and has coarse resolution on
some platforms. Any reference to ``time.time`` (call, alias, or ``from time
import time``) is flagged — there is no legitimate *timing* use in this
codebase, and timestamp-for-display uses can justify a suppression. (Device
time is read from CUDA events; this rule covers the host clock.)
"""
from __future__ import annotations

import ast
from typing import Iterable

from .core import Finding, LintModule, rule


@rule("R4", "time.time used for timing (NTP-unstable, coarse) — "
            "use time.perf_counter")
def check_timing(mod: LintModule) -> Iterable[Finding]:
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ImportFrom) and node.module == "time":
            for alias in node.names:
                if alias.name == "time":
                    yield Finding(
                        "R4", mod.path, node.lineno, node.col_offset,
                        "`from time import time` — import perf_counter "
                        "instead",
                    )
        elif isinstance(node, ast.Attribute):
            if node.attr == "time" and isinstance(node.value, ast.Name) \
                    and node.value.id == "time":
                yield Finding(
                    "R4", mod.path, node.lineno, node.col_offset,
                    "`time.time` — use `time.perf_counter` for intervals "
                    "(monotonic, high-resolution)",
                )
