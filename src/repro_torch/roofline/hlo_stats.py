"""Step statistics read from the port's own op stream (the counterpart of
`repro.roofline.hlo_stats`, which parses the HLO text of a compiled XLA
module). The port has no compiler, so this module does not read HLO: it
runs a step eagerly on fake tensors and records every operation as it is
dispatched.

`trace_step(fn, *args)` runs ``fn(*args)`` — a serving step, or a training
step with its ``.backward()`` and its optimizer update — under a
`TorchDispatchMode` inside the `FakeTensorMode` that owns the fake
arguments (no data, no launch, no allocation on any device). Each
operation below autograd is one `Trace.ops` entry: the op's name, its
operands' and results' shapes and dtypes (scalars as they are), whether it
is a view and whether it writes in place. A dispatch mode, not `make_fx`:
it sees autograd's backward ops and DTensor's local ops and functional
collectives (`_c10d_functional.*`) as they run. The kernels appear as
their `torch.library` operators (``repro_torch::*``, `kernels._library`),
one entry per launch. Live bytes follow the fake storages' lifetimes,
the arguments' included: eager frees a storage on its last reference (an
optimizer's old moments as it replaces them), so the step's peak is the
peak of the bytes live in storages, and the peak less the arguments is
what the step adds, as `torch.cuda.max_memory_allocated` less the memory
allocated before it reads on the card.

`step_stats(trace)` is a pure function of the recorded list and memory
summary (the counterpart of ``parse_hlo_stats(text)``): a saved trace
(`Trace.to_json`) is reanalyzed offline. Its `HloStats` keeps the JAX
module's fields where they mean the same thing:

- ``dot_flops``: 2·|result|·|contraction| of every product (``mm``,
  ``bmm``, ``addmm``, ``baddbmm``, ``addbmm``, ``_int_mm``, ``mv``,
  ``dot``);
- ``kernel_flops`` / ``kernel_bytes``: the mpGeMM operators' `mpgemm_cost`
  and flash's FLOPs (4·B·H·D over the valid query-key pairs) and its
  q/k/v/o bytes;
- ``traffic_bytes``: the eager port's counterpart of the JAX traffic model.
  Every non-view op materializes in eager PyTorch: it charges its operands
  plus its result; a view charges 0; ``index_select``, ``gather`` and
  ``index`` charge twice their result (read the rows, write them); an
  in-place write into part of a buffer (``index_put_``, ``index_copy_``,
  ``scatter_``…) charges three times the update (JAX's dynamic-update-
  slice rule); a kernel operator charges its ``kernel_bytes``; a
  collective charges nothing here (its bytes are the link's);
- ``collectives``: the result bytes and count of each kind, under the JAX
  names (``all-reduce``, ``all-gather``, ``reduce-scatter``,
  ``all-to-all``, and ``collective-permute`` for an all-to-all that sends
  each rank's block whole to one peer); ``wait_tensor`` is free;
  ``collective_bytes`` sums them;
- ``launches``: kernel operators by name;
- ``memory``: ``argument_size_in_bytes`` (the step's input storages),
  ``output_size_in_bytes`` (its returned tensors' storages, inputs updated
  in place among them, as XLA counts a donated output),
  ``alias_size_in_bytes`` (input storages written in place: the cache,
  parameters, optimizer state) and ``temp_size_in_bytes`` (the step's peak
  of live bytes less its arguments: the intermediates, its outputs among
  them while they live, net of the arguments it frees).

``n_whiles`` and ``unknown_trip_whiles`` have no counterpart and are None:
an eager trace unrolls the Python loop over the layers, so every op is
already counted as often as it runs and there is no trip count to find.

For the dataflow passes of `repro_torch.lint.ir`, each op record also
carries ``"ids"``: ``{"in": [[tensor id, storage id, device], ...], "out":
[...]}``, its tensor operands (in the order of their flattened arguments)
and results, numbered per trace over tensor objects and storages (a view
shares its base's storage id; an in-place op returns its operand's tensor
id). `Trace.arguments` and `Trace.outputs` number the step's own tensors
the same way, and `Trace.stopped` names the op at which a trace on fake
tensors stopped (`trace_step_partial`: a data-dependent op, which a fake
tensor cannot answer). `step_stats` reads none of these: a record without
them (an older `Trace.to_json`) gives the same statistics.
"""
from __future__ import annotations

import dataclasses
import json
import math
import time
import weakref
from collections import Counter

import numpy as np
import torch
from torch._subclasses.fake_tensor import (
    DataDependentOutputException,
    DynamicOutputShapeException,
    FakeTensor,
)
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakIdKeyDictionary

#: what stops a trace on fake tensors: an op whose result depends on data
DATA_DEPENDENT = (DataDependentOutputException, DynamicOutputShapeException)

#: ops whose result aliases an operand (no bytes moved), besides the
#: schema's own view flag
_VIEWS = frozenset({
    "view", "_unsafe_view", "t", "transpose", "permute", "expand", "slice", "select",
    "unsqueeze", "squeeze", "as_strided", "alias", "detach", "unflatten", "view_as_real",
    "view_as_complex", "split", "split_with_sizes", "chunk", "unbind", "narrow", "diagonal",
    "lift_fresh", "_reshape_alias"})
_GATHERS = frozenset({"index_select", "gather", "index"})
#: in-place writes into part of a buffer → the position of the update
_PARTIAL_WRITES = {"index_put_": 2, "_index_put_impl_": 2, "index_copy_": 3, "index_add_": 3,
                   "scatter_": 3, "scatter_add_": 3, "scatter_reduce_": 3}
_DOTS = frozenset({"mm", "bmm", "addmm", "baddbmm", "addbmm", "_int_mm", "mv", "dot"})
#: `_c10d_functional` ops by JAX's collective names
_COLLECTIVES = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
                "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
                "all_gather_into_tensor": "all-gather",
                "all_gather_into_tensor_coalesced": "all-gather",
                "all_gather_into_tensor_out": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "reduce_scatter_tensor_coalesced": "reduce-scatter",
                "all_to_all_single": "all-to-all"}
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                    "collective-permute")
COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional")
KERNEL_NAMESPACE = "repro_torch"
_MPGEMM_FUSED = frozenset({"ternary_decode_gemm_fused", "vlut_lookup_gemm_fused",
                           "ternary_decode_gemm_fused_grouped", "vlut_lookup_gemm_fused_grouped"})


# --------------------------------------------------------------------------
# the record
# --------------------------------------------------------------------------
def _desc(x):
    """A JSON-able description of an op's argument or result: a tensor as
    ["T", shape, dtype name], a list or tuple element-wise, a scalar as it
    is, anything else as its string."""
    if isinstance(x, torch.Tensor):
        return ["T", list(x.shape), str(x.dtype).removeprefix("torch.")]
    if isinstance(x, (list, tuple)):
        return [_desc(v) for v in x]
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    return str(x)


def _is_tensor(d) -> bool:
    return isinstance(d, list) and len(d) == 3 and d[0] == "T"


def _tensors(d) -> list:
    """The tensor descriptions in a (nested) description."""
    if _is_tensor(d):
        return [d]
    if isinstance(d, list):
        return [t for v in d for t in _tensors(v)]
    return []


def _itemsize(dtype: str) -> int:
    return getattr(torch, dtype).itemsize


def nbytes(d) -> int:
    """Bytes of the tensors of a description (each at its own numel)."""
    return sum(math.prod(t[1]) * _itemsize(t[2]) for t in _tensors(d))


@dataclasses.dataclass
class Trace:
    """One traced step: its ops in dispatch order (dicts with "op" — the
    schema's name, e.g. "aten::mm" —, "args", "out", "view", "inplace"),
    its memory summary (bytes: "argument", "output", "alias", "peak_temp":
    the peak of live bytes less the arguments)
    and the trace's wall seconds; the step's argument and result tensors
    ([tensor id, storage id, device, shape, dtype] each), and the op a
    partial trace stopped at (module docstring)."""
    ops: list
    memory: dict
    seconds: float = 0.0
    arguments: list = dataclasses.field(default_factory=list)
    outputs: list = dataclasses.field(default_factory=list)
    stopped: dict | None = None

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, text: str) -> "Trace":
        return cls(**json.loads(text))


def _storage_key(t: torch.Tensor):
    return t.untyped_storage()._cdata


def _leaf_tensors(tree) -> list:
    """The plain tensors of a step's arguments or results: tensors (a
    DTensor's local shard), lists, tuples, dicts and dataclasses (a
    `PackedWeight`) recursively, and an `nn.Module`'s parameters and
    buffers."""
    from torch.distributed.tensor import DTensor

    out: list = []

    def walk(x):
        if isinstance(x, DTensor):
            out.append(x._local_tensor)
        elif isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, torch.nn.Module):
            for t in [*x.parameters(), *x.buffers()]:
                walk(t)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))

    walk(tree)
    return out


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages of a tree's tensors (`_leaf_tensors`):
    a step's arguments or results, fake or real, counted as the trace
    counts them."""
    seen = {}
    for t in _leaf_tensors(tree):
        seen.setdefault(_storage_key(t), t.untyped_storage().nbytes())
    return sum(seen.values())


class _Recorder(TorchDispatchMode):
    """Records each op below autograd and DTensor (a DTensor op is passed
    on, `NotImplemented`, so that its local ops and collectives come back
    here as plain tensors) and the live bytes of every storage: the
    arguments' from the start, each new one from the op that makes it,
    each until its last reference goes."""

    def __init__(self, arg_tensors: list):
        super().__init__()
        self.ops: list = []
        self.written: set = set()
        self.live: dict = {}
        self.live_bytes = 0
        self.on = True
        self.stopped = None
        self._tids = WeakIdKeyDictionary()
        self._sids: dict = {}
        self._n_tids = self._n_sids = 0
        for t in arg_tensors:
            self._track(t.untyped_storage())
        self.args = dict(self.live)
        self.peak = self.live_bytes
        self.arguments = [[*self.ids(t), list(t.shape), str(t.dtype).removeprefix("torch.")]
                          for t in arg_tensors]

    def ids(self, t: torch.Tensor) -> list:
        """[tensor id, storage id, device] of `t`, numbered in this trace."""
        tid = self._tids.get(t)
        if tid is None:
            tid = self._tids[t] = self._n_tids
            self._n_tids += 1
        st = t.untyped_storage()
        key = st._cdata
        sid = self._sids.get(key)
        if sid is None:
            sid = self._sids[key] = self._n_sids
            self._n_sids += 1
            weakref.finalize(st, self._sids.pop, key, None)
        return [tid, sid, str(t.device)]

    def _track(self, st) -> None:
        key = st._cdata
        if key in self.live:
            return
        self.live[key] = st.nbytes()
        self.live_bytes += self.live[key]
        weakref.finalize(st, self._free, key)

    def _free(self, key):
        if self.on and key in self.live:
            self.live_bytes -= self.live.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        schema = func._schema
        try:
            out = func(*args, **kwargs)
        except DATA_DEPENDENT as e:
            self.stopped = {"op": schema.name, "error": type(e).__name__}
            raise
        ns, _, name = schema.name.partition("::")
        if ns == "prim" or not any(isinstance(t, FakeTensor)
                                   for t in tree_flatten((args, kwargs, out))[0]):
            return out                  # not the step's: real host tensors, or no tensor
        inplace = schema.is_mutable
        if inplace:
            for a, v in zip(schema.arguments, args):
                if a.alias_info is not None and a.alias_info.is_write:
                    for t in tree_flatten(v)[0]:
                        if isinstance(t, torch.Tensor):
                            self.written.add(_storage_key(t))
        self.ops.append({"op": schema.name, "args": _desc(list(args)),
                         "kwargs": {k: _desc(v) for k, v in kwargs.items()},
                         "out": _desc(out), "view": bool(func.is_view) or name in _VIEWS,
                         "inplace": inplace,
                         "ids": {"in": [self.ids(t) for t in tree_flatten((args, kwargs))[0]
                                        if isinstance(t, torch.Tensor)],
                                 "out": [self.ids(t) for t in tree_flatten(out)[0]
                                         if isinstance(t, torch.Tensor)]}})
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self._track(t.untyped_storage())
        self.peak = max(self.peak, self.live_bytes)
        return out


def fake_module(module: torch.nn.Module, device, mode) -> torch.nn.Module:
    """A copy of a meta-device module (e.g. `launch.steps.meta_model`) with
    every parameter and buffer an unwritten fake tensor of `mode` on
    `device`, strides kept: a step's model to trace, with no allocation."""
    import copy

    out = copy.deepcopy(module)                 # outside the mode: still meta
    with mode:
        return out._apply(lambda t: torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                                        device=device))


def fake_mode_of(tensors):
    """The `FakeTensorMode` that owns the fake tensors among `tensors`."""
    from torch._guards import detect_fake_mode

    mode = detect_fake_mode(tensors)
    if mode is None:
        raise ValueError("trace_step takes fake tensors (built under a FakeTensorMode)")
    return mode


def _trace(fn, args, kwargs, partial: bool) -> tuple[Trace, object]:
    arg_tensors = _leaf_tensors((args, kwargs))
    mode = fake_mode_of(arg_tensors)
    rec = _Recorder(arg_tensors)
    del arg_tensors                  # the step alone decides what its arguments outlive
    arg_bytes = sum(rec.args.values())
    t0 = time.perf_counter()
    result = None
    try:
        with mode, rec:
            result = fn(*args, **kwargs)
    except DATA_DEPENDENT:
        if not partial:
            raise
    seconds = time.perf_counter() - t0
    rec.on = False
    out_bytes = storage_bytes(result)
    alias = sum(n for k, n in rec.args.items() if k in rec.written)
    memory = {"argument": arg_bytes, "output": out_bytes, "alias": alias,
              "peak_temp": rec.peak - arg_bytes}
    outputs = [[*rec.ids(t), list(t.shape), str(t.dtype).removeprefix("torch.")]
               for t in _leaf_tensors(result)]
    return Trace(rec.ops, memory, seconds, rec.arguments, outputs, rec.stopped), result


def trace_step(fn, *args, **kwargs) -> tuple[Trace, object]:
    """Run ``fn(*args, **kwargs)`` on its fake arguments and record it:
    → (`Trace`, fn's result). The arguments' tensors (module parameters
    and buffers, dicts, lists, dataclasses, DTensors' local shards) are
    the step's arguments: live from the start, until the step drops its
    last reference (temp = the peak less the arguments)."""
    return _trace(fn, args, kwargs, partial=False)


def trace_step_partial(fn, *args, **kwargs) -> tuple[Trace, object]:
    """`trace_step`, except that a data-dependent op (``.item()``,
    ``nonzero``, a boolean mask: what a fake tensor cannot answer) ends
    the trace instead of raising: → (the ops up to it, with
    `Trace.stopped` naming it, None)."""
    return _trace(fn, args, kwargs, partial=True)


# --------------------------------------------------------------------------
# the statistics (a pure function of the record)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class HloStats:
    dot_flops: float = 0.0
    kernel_flops: float = 0.0
    kernel_bytes: float = 0.0
    traffic_bytes: float = 0.0
    collectives: dict = dataclasses.field(default_factory=dict)
    launches: dict = dataclasses.field(default_factory=dict)
    memory: dict = dataclasses.field(default_factory=dict)
    unknown_trip_whiles: int | None = None
    n_whiles: int | None = None

    @property
    def collective_bytes(self) -> float:
        return sum(v["bytes"] for v in self.collectives.values())

    @property
    def flops(self) -> float:
        """Every counted FLOP: the library products and the kernels."""
        return self.dot_flops + self.kernel_flops

    def row(self) -> dict:
        return {**dataclasses.asdict(self), "collective_bytes": self.collective_bytes}


def _shape(d) -> list:
    return d[1]


def dot_flops(op: dict) -> float:
    """2·|result|·|contraction| of a product op (0 for any other op)."""
    name = op["op"].partition("::")[2]
    if name not in _DOTS:
        return 0.0
    args = [a for a in op["args"] if _is_tensor(a)]
    res = math.prod(_shape(op["out"]))
    # the contraction is the last dim of the (last) left operand: mm, bmm,
    # _int_mm, mv, dot take (lhs, rhs); addmm, baddbmm, addbmm (bias, lhs, rhs);
    # addbmm sums its batch too, so its contraction is batch × K
    lhs = _shape(args[-2] if len(args) >= 2 else args[0])
    return 2.0 * res * lhs[-1] * (lhs[0] if name == "addbmm" else 1)


def _flash_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """Valid (query, key) pairs of the flash kernel's mask: key j of query
    i when j <= i (causal) and i - j < window (windowed)."""
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(sq, dtype=np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())


def kernel_cost(op: dict) -> tuple[float, float]:
    """(FLOPs, HBM bytes) of one kernel operator: `mpgemm_cost` of each
    expert's product (fused or integer), flash's 4·B·H·D per valid pair
    and its q, k, v and output bytes."""
    from repro_torch.roofline.analysis import mpgemm_cost

    name = op["op"].partition("::")[2]
    args = op["args"]
    if name == "flash_attention":
        q, k, v, causal, window = args[0], args[1], args[2], args[3], args[4]
        b, h, sq, d = _shape(q)
        pairs = _flash_pairs(sq, _shape(k)[2], bool(causal), int(window))
        return 4.0 * b * h * d * pairs, float(nbytes([q, k, v, op["out"]]))
    packed, g = _shape(args[0]), int(args[4] if name in _MPGEMM_FUSED else args[2])
    e = packed[0] if len(packed) == 3 else 1
    m, kg = packed[-2], packed[-1]
    n = _shape(args[1])[-2] if name in _MPGEMM_FUSED else _shape(args[1])[-1]
    flops, bytes_ = mpgemm_cost(m, kg * g, n, g, fused=name in _MPGEMM_FUSED)
    return e * flops, e * bytes_


def collective_kind(op: dict) -> str | None:
    """The JAX name of a functional collective, else None. An
    ``all_to_all_single`` whose input goes whole to one peer (one nonzero
    input split: `funcol.permute_tensor`) is a collective-permute."""
    ns, _, name = op["op"].partition("::")
    if ns not in COLLECTIVE_NAMESPACES:
        return None
    if name == "all_to_all_single":
        splits = op["args"][2] if len(op["args"]) > 2 else None
        if isinstance(splits, list) and sum(1 for v in splits if v) == 1:
            return "collective-permute"
    return _COLLECTIVES.get(name)


def op_traffic(op: dict) -> float:
    """The eager traffic model's bytes of one op (module docstring)."""
    ns, _, name = op["op"].partition("::")
    if op["view"] or ns in COLLECTIVE_NAMESPACES or not _tensors(op["out"]):
        return 0.0
    if ns == KERNEL_NAMESPACE:
        return kernel_cost(op)[1]
    if name in _GATHERS:
        return 2.0 * nbytes(op["out"])
    if name in _PARTIAL_WRITES:
        pos = _PARTIAL_WRITES[name]
        upd = op["args"][pos] if len(op["args"]) > pos else None
        if _is_tensor(upd):
            return 3.0 * nbytes(upd)
        # a scalar fill (scatter_.value): the index's rows in self's dtype
        idx, self_ = op["args"][2], op["args"][0]
        return 3.0 * math.prod(_shape(idx)) * _itemsize(self_[2])
    return float(nbytes(op["args"]) + nbytes(list(op["kwargs"].values())) + nbytes(op["out"]))


def step_stats(trace: Trace) -> HloStats:
    """The step's statistics from its record (module docstring)."""
    st = HloStats()
    launches: Counter = Counter()
    for op in trace.ops:
        ns, _, name = op["op"].partition("::")
        st.dot_flops += dot_flops(op)
        if ns == KERNEL_NAMESPACE:
            f, b = kernel_cost(op)
            st.kernel_flops += f
            st.kernel_bytes += b
            launches[name] += 1
        st.traffic_bytes += op_traffic(op)
    from repro_torch.roofline.analysis import collective_bytes

    st.collectives = {k: v for k, v in collective_bytes(trace.ops).items() if v["count"]}
    st.launches = dict(launches)
    m = trace.memory
    st.memory = {"argument_size_in_bytes": m["argument"], "output_size_in_bytes": m["output"],
                 "alias_size_in_bytes": m["alias"], "temp_size_in_bytes": m["peak_temp"]}
    return st
