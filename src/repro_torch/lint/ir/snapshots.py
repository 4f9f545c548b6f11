"""I5 — golden op-stream signatures: structural snapshots of the hot path
(the counterpart of `repro.lint.ir.snapshots`).

A refactor that changes the op stream of a serving step — other ops,
other shapes, an extra materialization — should be a reviewable diff, not
a silent change found later by a benchmark. Each registry entry gets a
structural hash over its trace: every op's name, its operands' and
results' shapes and dtypes, its scalar arguments in a canonical form, and
its view/in-place flags, plus the step's argument and result tensors.
Tensor ids, storage ids and devices do not enter the hash (a device string
among the scalars reads "<device>", an object's address "<obj>"), so a
retrace hashes the same and a cpu trace can match a cuda one.

Snapshots live under ``tests/torch_ir_snapshots/<device>/<entry>.json`` (a
root of their own: the JAX package's `tests/ir_snapshots/` holds jaxprs)
and carry the hash plus per-op counts, so a mismatch's message shows
*what kind* of structure changed. Workflow:

    python -m repro_torch.lint --ir                     # gate: hashes match
    python -m repro_torch.lint --ir --update-snapshots  # intentional change:
                                                        # rewrite + commit

Findings: a missing snapshot (an entry never snapshotted) and a stale one
(hash mismatch, the message names the per-op count delta).
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import re
from collections import Counter
from typing import Iterable

from ..core import Finding
from .core import IREntry, ir_pass

#: default snapshot root (keyed by device inside)
SNAPSHOT_ROOT = str(pathlib.Path(__file__).resolve().parents[4] / "tests" / "torch_ir_snapshots")
_DEVICE_RE = re.compile(r"^(cpu|cuda|meta)(:\d+)?$")


def snapshot_dir(root: str | None = None, device: str = "cpu") -> str:
    return os.path.join(root or SNAPSHOT_ROOT, device)


def canon(x) -> str:
    """Stable rendering of a recorded argument (no ids, no devices)."""
    if isinstance(x, list) and len(x) == 3 and x[0] == "T":
        return f"{x[2]}[{','.join(str(d) for d in x[1])}]"
    if isinstance(x, list):
        return "(" + ",".join(canon(v) for v in x) + ")"
    if isinstance(x, dict):
        return "{" + ",".join(f"{k}:{canon(x[k])}" for k in sorted(x)) + "}"
    if isinstance(x, str):
        if _DEVICE_RE.match(x):
            return "<device>"
        return "<obj>" if "0x" in x else repr(x)
    return repr(x)


def _tensor_sig(t: list) -> str:
    return f"{t[4]}[{','.join(str(d) for d in t[3])}]"


def signature(trace) -> tuple[str, dict]:
    """-> (sha256 structural hash, {op: count})."""
    lines = ["in:" + ",".join(_tensor_sig(t) for t in trace.arguments)]
    for op in trace.ops:
        lines.append(f"{op['op']}({canon(op['args'])};{canon(op['kwargs'])})"
                     f"->({canon(op['out'])})[{int(op['view'])}{int(op['inplace'])}]")
    lines.append("out:" + ",".join(_tensor_sig(t) for t in trace.outputs))
    if trace.stopped:
        lines.append(f"stopped:{trace.stopped['op']}")
    digest = hashlib.sha256("\n".join(lines).encode()).hexdigest()
    return digest, dict(sorted(Counter(op["op"] for op in trace.ops).items()))


def _snapshot_path(entry: IREntry, root: str | None) -> str:
    return os.path.join(snapshot_dir(root, entry.device), entry.name.replace("/", "__") + ".json")


def write_snapshot(entry: IREntry, root: str | None = None) -> str:
    digest, counts = signature(entry.trace)
    path = _snapshot_path(entry, root)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {
        "entry": entry.name,
        "device": entry.device,
        "hash": digest,
        "n_ops": sum(counts.values()),
        "ops": counts,
        "arguments": [_tensor_sig(t) for t in entry.trace.arguments],
        "outputs": [_tensor_sig(t) for t in entry.trace.outputs],
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def _count_delta(old: dict, new: dict) -> str:
    keys = sorted(set(old) | set(new))
    parts = [f"{k}: {old.get(k, 0)}->{new.get(k, 0)}" for k in keys
             if old.get(k, 0) != new.get(k, 0)]
    return ", ".join(parts) if parts else "same op counts"


@ir_pass("I5", "golden op-stream signatures: structural hash vs the committed snapshot "
               "under tests/torch_ir_snapshots/<device>/ (update with --update-snapshots)")
def check_snapshots(entry: IREntry, snapshot_root: str | None = None,
                    update_snapshots: bool = False) -> Iterable[Finding]:
    if update_snapshots:
        write_snapshot(entry, snapshot_root)
        return
    path = _snapshot_path(entry, snapshot_root)
    if not os.path.exists(path):
        yield Finding(
            "I5", entry.path, 0, 0,
            f"no golden snapshot at {path} — run `python -m repro_torch.lint --ir "
            f"--update-snapshots` and commit the result")
        return
    with open(path, encoding="utf-8") as f:
        want = json.load(f)
    digest, counts = signature(entry.trace)
    if digest != want.get("hash"):
        yield Finding(
            "I5", entry.path, 0, 0,
            f"traced op stream diverged from golden snapshot {path} "
            f"({_count_delta(want.get('ops', {}), counts)}); if intentional, re-run "
            f"with --update-snapshots and commit the diff")
