"""Atomic, async checkpointing (ported from `repro.checkpoint.checkpointer`,
with the same on-disk contract).

Layout:  <dir>/step_<N>/
           manifest.json       — step, extra, and every leaf's path, shape
                                 and dtype
           leaf_<i>.npy        — one file per leaf; bf16 stored as a raw
                                 uint16 view (numpy has no bf16), its true
                                 dtype in the manifest
           COMMIT              — written last; a step dir without COMMIT is
                                 ignored (atomicity against mid-write failure)

A state is a tree of dicts and dataclasses (`QTensor`, `PackedWeight`)
with tensor leaves; leaf paths are written as JAX writes
them (``['params']/['w']``, ``.q`` for a dataclass field). Non-tensor
fields (a dataclass's shape or K) are static: restore takes them from the
template.

Async: ``save(..., blocking=False)`` copies every leaf to host memory first
(the trainer updates its parameters in place right after), then writes on
a daemon thread; ``wait()`` joins before the next save or program exit.
Restore onto device shardings waits for the port of `dist`.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading

import numpy as np
import torch

_SENTINEL = "COMMIT"


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


def _flatten(tree, path=()):
    """Yield (path string, tensor) in a fixed order (sorted dict keys)."""
    if isinstance(tree, torch.Tensor):
        yield "/".join(path), tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (f"[{k!r}]",))
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _flatten(getattr(tree, f.name), path + (f".{f.name}",))


def _rebuild(tree, leaves, path=()):
    """`tree` with each tensor leaf replaced by ``leaves[path]``."""
    if isinstance(tree, torch.Tensor):
        return leaves["/".join(path)]
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, path + (f"[{k!r}]",)) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), leaves, path + (f".{f.name}",))
            for f in dataclasses.fields(tree) if f.init})
    return tree


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy that later in-place updates of `t` cannot reach."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_host(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    t = torch.from_numpy(arr)
    if _dtype_name(t.dtype) != dtype_name:
        raise ValueError(f"leaf stored as {arr.dtype}, manifest says {dtype_name}")
    return t


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, state, extra: dict | None = None, blocking=True):
        self.wait()
        flat = list(_flatten(state))
        entries = [{"path": p, "shape": list(t.shape), "dtype": _dtype_name(t.dtype)}
                   for p, t in flat]
        host = [_to_host(t) for _, t in flat]

        def _write():
            tmp = os.path.join(self.dir, f".tmp_step_{step}")
            final = os.path.join(self.dir, f"step_{step}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            for i, arr in enumerate(host):
                np.save(os.path.join(tmp, f"leaf_{i}.npy"), arr)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump({"step": step, "extra": extra or {}, "leaves": entries}, f)
            with open(os.path.join(tmp, _SENTINEL), "w") as f:
                f.write("ok")
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            self._gc()

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                os.path.join(self.dir, name, _SENTINEL)
            ):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: int | None = None):
        """template: a tree matching the saved structure; its tensor leaves
        give the shapes to check and the device to load onto (the CPU for
        ``meta`` tensors). → (state, extra)"""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        saved = {e["path"]: i for i, e in enumerate(manifest["leaves"])}
        leaves = {}
        for p, ab in _flatten(template):
            if p not in saved:
                raise KeyError(f"checkpoint missing leaf {p}")
            i = saved[p]
            t = _from_host(np.load(os.path.join(d, f"leaf_{i}.npy")),
                           manifest["leaves"][i]["dtype"])
            if tuple(t.shape) != tuple(ab.shape):
                raise ValueError(f"shape mismatch for {p}: {tuple(t.shape)} vs {tuple(ab.shape)}")
            leaves[p] = t if ab.device.type == "meta" else t.to(ab.device)
        return _rebuild(template, leaves), manifest.get("extra", {})
