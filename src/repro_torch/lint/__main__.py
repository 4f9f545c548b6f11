"""CLI: ``python -m repro_torch.lint [paths] [--json out.json]``.

AST mode (default) lints source files (default: `src/repro_torch`,
`tests/test_torch_*.py`, `chip_smoke.py`, from the repository root); IR
mode (``--ir``) traces the entry-point registry on fake tensors of
``--device`` and runs the passes I1-I5. Both share the exit-code contract:
0 clean, 1 findings (including bad suppressions), 2 usage.

    python -m repro_torch.lint --ir                     # the registry on the cpu
    python -m repro_torch.lint --ir --ir-full           # + the MLA engines, FULL_MS
    python -m repro_torch.lint --ir --update-snapshots  # rewrite the snapshots
"""
from __future__ import annotations

import argparse
import glob
import sys

from . import DEFAULT_PATHS
from .core import lint_paths, registered_rules, report_json, write_json


def _select(args) -> set[str] | None:
    return ({s.strip() for s in args.select.split(",") if s.strip()}
            if args.select else None)


def _summary(findings) -> str:
    counts = report_json(findings, 0)["counts"]
    summary = ", ".join(f"{k}={v}" for k, v in sorted(counts.items()))
    return f" [{summary}]" if summary else ""


def _run_ir(args) -> int:
    # imported lazily: IR mode needs the model stack, AST mode doesn't
    from . import ir

    entries = ir.default_entries(full=args.ir_full, device=args.device)
    findings = ir.run_passes(entries, select=_select(args), snapshot_root=args.snapshot_dir,
                             update_snapshots=args.update_snapshots)
    for f in findings:
        print(f.format())
    if args.json:
        write_json(args.json, findings, len(entries))
    verb = "snapshotted" if args.update_snapshots else "checked"
    print(f"repro_torch.lint --ir: {len(entries)} entry point(s) {verb} on {args.device}, "
          f"{len(findings)} finding(s)" + _summary(findings))
    return 1 if findings else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="static analysis of the PyTorch/CUDA port (rule catalog: the "
                    "repro_torch.lint package docstring)")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files or directories to lint (default: "
                         + " ".join(DEFAULT_PATHS) + "; ignored with --ir)")
    ap.add_argument("--json", metavar="FILE", default=None,
                    help="also write a machine-readable JSON report")
    ap.add_argument("--select", default=None,
                    help="comma-separated rule/pass ids to run (default: all)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the registered rules and exit")
    ap.add_argument("--ir", action="store_true",
                    help="run the IR passes over the traced entry-point registry "
                         "instead of the AST rules")
    ap.add_argument("--ir-full", action="store_true",
                    help="with --ir: the full registry (FULL_MS, the MLA engines)")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="with --ir: the fake tensors' device (default cpu: a trace "
                         "launches nothing)")
    ap.add_argument("--update-snapshots", action="store_true",
                    help="with --ir: rewrite the I5 snapshots instead of checking them")
    ap.add_argument("--snapshot-dir", default=None,
                    help="with --ir: snapshot root (default tests/torch_ir_snapshots)")
    ap.add_argument("--list-passes", action="store_true",
                    help="print the registered IR passes and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid, desc in registered_rules().items():
            print(f"{rid}: {desc}")
        return 0
    if args.list_passes:
        from . import ir

        for pid, desc in ir.registered_passes().items():
            print(f"{pid}: {desc}")
        return 0
    if args.ir:
        args.device = args.device or "cpu"
        return _run_ir(args)
    if args.ir_full or args.update_snapshots or args.snapshot_dir or args.device:
        ap.error("--ir-full/--update-snapshots/--snapshot-dir/--device require --ir")

    paths = args.paths or [p for pat in DEFAULT_PATHS for p in sorted(glob.glob(pat))]
    findings, n_files = lint_paths(paths, select=_select(args))
    for f in findings:
        print(f.format())
    if args.json:
        write_json(args.json, findings, n_files)
    print(f"repro_torch.lint: {n_files} file(s), {len(findings)} finding(s)"
          + _summary(findings))
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
