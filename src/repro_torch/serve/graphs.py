"""Serving steps captured once per static shape as CUDA graphs, with the
cache donated: the port's counterpart of the JAX engine's
``jax.jit(step, donate_argnums=(1,))``.

A `StepGraphs` runs a step ``fn(params, cache, *inputs) -> (out, new_cache)``:

* Key: (entry name, the inputs' shapes and dtypes, the effective mpGeMM
  routing (`kernels.ops.dispatch_config`: impl, fusion), the plan cache's
  generation (`kernels.autotune.generation`)). A new routing or a new plan
  is a new graph, as a new static argument is a new trace in JAX.
* Warm-up: a key's first call runs eagerly and its result is the step's
  real result. It builds the kernels, fills the autotune memo and grows the
  split-K workspace, none of which may happen inside a capture.
* Inputs: every tensor input is a static buffer of this object, filled by
  `upload` (one non-blocking copy, from the host or the device). The
  capture reads the buffers in place, so filling them is the whole input
  copy; a replay raises if an input is not the buffer it was captured on.
* Capture: the key's second call captures the step on a side stream into
  one memory pool shared by this object's graphs, then replays it. Every
  later call replays.
* Donation: the graph reads and writes the caller's cache tensors in
  place. A leaf the step returns as a new tensor (a layer's advanced
  ``idx``, an SSM layer's ``conv`` and ``state``) is copied back into the
  donated tensor inside the graph (`write_back`), so the cache keeps its
  storage and the model code stays the mirror of the JAX code. The
  returned cache is the donated list itself.
* Before each replay a host-only check raises if a cache leaf's storage
  differs from the one captured: an eager path that rebound a leaf would
  otherwise leave the graph writing a tensor nobody reads.
* Launch counters: each kernel wrapper's ``.launches`` delta during the
  capture (`kernels.LAUNCH_COUNTERS`) is taken back and added again on
  every replay, so a replayed step counts the launches it makes.
  `chip_smoke.py` holds these counts to the kernel records of a device
  trace of the replays.
* Outputs: a replay returns the graph's static outputs, valid until the
  next replay of ANY key of this object: its graphs share one pool and
  replay in any order, so one graph's replay may write where another's
  outputs lie. A caller consumes an output (in stream order) before the
  next step, or clones it.
* Failures raise; nothing falls back to eager.

With ``enabled=False``, or on a device other than ``cuda`` (where there is
no graph to capture), every call runs eagerly with the same donation and
write-back: the counterpart of ``jax.disable_jit``. Tests pass a stand-in
`capture` to exercise the bookkeeping on the CPU.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.kernels import LAUNCH_COUNTERS, autotune
from repro_torch.kernels import ops as kernel_ops


def leaf_ptrs(cache: list) -> tuple:
    """The storage address of every cache leaf, layer by layer."""
    return tuple(leaf.data_ptr() for layer in cache for leaf in layer.values())


def write_back(donated: list, new: list) -> list:
    """Copy every leaf that `new` (a step's returned cache) holds as
    another tensor than `donated`'s into the donated tensor, in place.
    → donated."""
    if new is donated:
        return donated
    if len(new) != len(donated):
        raise ValueError(f"a step returned {len(new)} cache layers for {len(donated)}")
    for i, (old_layer, new_layer) in enumerate(zip(donated, new)):
        for key, leaf in new_layer.items():
            old = old_layer.get(key)
            if old is None:
                raise ValueError(f"layer {i}: the step returned a cache leaf {key!r} "
                                 "the donated cache lacks")
            if leaf is old:
                continue
            if leaf.shape != old.shape:
                raise ValueError(f"layer {i}: cache leaf {key!r} came back as "
                                 f"{tuple(leaf.shape)}, donated {tuple(old.shape)}")
            if leaf.data_ptr() != old.data_ptr() or leaf.stride() != old.stride():
                old.copy_(leaf)
    return donated


#: device index → the stream every capture there runs on
_CAPTURE_STREAMS: dict = {}


def _capture_stream() -> torch.cuda.Stream:
    """The device's capture stream, made once. cuBLAS keeps a workspace per
    stream, allocated at its first product there: one small product of
    each type the steps multiply in makes it here, outside any capture,
    rather than in a graph's pool (which it would then keep alive)."""
    dev = torch.cuda.current_device()
    side = _CAPTURE_STREAMS.get(dev)
    if side is None:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for dtype in (torch.float32, torch.bfloat16):
                a = torch.ones((16, 16), dtype=dtype, device="cuda")
                a @ a
        torch.cuda.current_stream().wait_stream(side)
        _CAPTURE_STREAMS[dev] = side
    return side


def cuda_capture(body: Callable, pool):
    """Capture `body()` into a new `torch.cuda.CUDAGraph` on the device's
    capture stream, allocating from `pool`. → (graph, body's result). A
    failed capture is ended and its error raised."""
    graph = torch.cuda.CUDAGraph()
    side = _capture_stream()
    torch.cuda.synchronize()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph.capture_begin(pool=pool)
        try:
            out = body()
        except BaseException:
            with contextlib.suppress(RuntimeError):
                graph.capture_end()
            raise
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    return graph, out


@dataclasses.dataclass
class _Graph:
    graph: object            # a torch.cuda.CUDAGraph (or a test's stand-in)
    inputs: tuple            # the static input tensors the graph reads
    out: object              # its static outputs
    leaves: tuple            # `leaf_ptrs` of the donated cache at capture
    launches: dict           # kernel wrapper → launches per replay


class StepGraphs:
    """One engine's (and its drafter's) step graphs, their static buffers
    and memory pool. ``captures[entry]`` / ``replays[entry]`` count each
    entry's captures and replays."""

    def __init__(self, device, *, enabled: bool = True, capture: Callable | None = None):
        self.device = torch.device(device)
        if capture is None and self.device.type == "cuda":
            capture = cuda_capture
        self._capture = capture
        self.enabled = bool(enabled) and capture is not None
        self.graphs: dict = {}
        self.warm: set = set()
        self.captures: collections.Counter = collections.Counter()
        self.replays: collections.Counter = collections.Counter()
        self._buffers: dict = {}
        self._pool = None

    # -- static input buffers ------------------------------------------
    def upload(self, name: str, src) -> torch.Tensor:
        """Fill this object's persistent device buffer for (`name`, `src`'s
        shape and dtype) from a host array or a tensor on any device with
        one non-blocking copy. → the buffer, a step's input: a graph
        captured on it reads it in place, so filling it is the whole
        input copy."""
        src = torch.from_numpy(np.ascontiguousarray(src)) if isinstance(src, np.ndarray) else src
        key = (name, tuple(src.shape), src.dtype)
        buf = self._buffers.get(key)
        if buf is None:
            buf = self._buffers[key] = torch.empty(key[1], dtype=src.dtype, device=self.device)
        buf.copy_(src, non_blocking=True)
        return buf

    # -- steps ---------------------------------------------------------
    def key(self, entry: str, inputs: tuple) -> tuple:
        d = kernel_ops.dispatch_config()
        shapes = tuple((tuple(t.shape), t.dtype) if isinstance(t, torch.Tensor) else t
                       for t in inputs)
        return entry, shapes, (d.impl, d.fusion), autotune.generation()

    @staticmethod
    def eager(fn: Callable, params, cache: list, *inputs):
        """One step run eagerly, its new cache leaves written back into
        `cache`. → (out, cache)."""
        out, new = fn(params, cache, *inputs)
        return out, write_back(cache, new)

    def __call__(self, entry: str, fn: Callable, params, cache: list, *inputs):
        """Run step `entry` (``fn(params, cache, *inputs) -> (out,
        new_cache)``) with `cache` donated. → (out, cache)."""
        if not self.enabled:
            return self.eager(fn, params, cache, *inputs)
        key = self.key(entry, inputs)
        g = self.graphs.get(key)
        if g is None:
            if key not in self.warm:
                self.warm.add(key)
                return self.eager(fn, params, cache, *inputs)
            g = self._record(key, fn, params, cache, inputs)
        return self._replay(key, g, cache, inputs), cache

    def _record(self, key: tuple, fn: Callable, params, cache: list, inputs: tuple) -> _Graph:
        def body():
            out, new = fn(params, cache, *inputs)
            write_back(cache, new)
            return out

        if self._pool is None and self.device.type == "cuda":
            self._pool = torch.cuda.graph_pool_handle()
        counters = list(LAUNCH_COUNTERS.values())
        before = [fn_.launches for fn_ in counters]
        try:
            graph, out = self._capture(body, self._pool)
        finally:
            # nothing ran: the launches come back with each replay
            deltas = {}
            for fn_, n in zip(counters, before):
                if fn_.launches != n:
                    deltas[fn_] = fn_.launches - n
                fn_.launches = n
        g = _Graph(graph, inputs, out, leaf_ptrs(cache), deltas)
        self.graphs[key] = g
        self.captures[key[0]] += 1
        return g

    def _replay(self, key: tuple, g: _Graph, cache: list, inputs: tuple):
        if leaf_ptrs(cache) != g.leaves:
            raise RuntimeError(
                f"step graph {key[0]!r}: a cache leaf's storage differs from the one "
                "captured (an eager path rebound it instead of writing in place)")
        if any(isinstance(t, torch.Tensor) and t is not s for s, t in zip(g.inputs, inputs)):
            raise RuntimeError(
                f"step graph {key[0]!r}: an input is not the buffer the graph was captured "
                "on (stage every tensor input with StepGraphs.upload)")
        g.graph.replay()
        for fn_, d in g.launches.items():
            fn_.launches += d
        self.replays[key[0]] += 1
        return g.out

    def clear(self) -> None:
        """Drop every graph and warm-up mark (the buffers stay): the next
        calls warm up and capture again."""
        self.graphs.clear()
        self.warm.clear()
