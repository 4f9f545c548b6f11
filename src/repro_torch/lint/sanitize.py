"""Runtime sanitizer mode + the steady-state growth guard (the port's
counterpart of `repro.lint.sanitize`).

`enable_sanitizers()` pushes a `TorchFunctionMode` that mirrors JAX's three
strict modes for every torch function and tensor method called under it:

* rank promotion raises (``jax_numpy_rank_promotion="raise"``): a
  broadcasting op (`BROADCASTING`: elementwise arithmetic, comparisons,
  `where`) whose tensor operands have different non-zero ranks;
* dtype promotion is strict (``jax_numpy_dtype_promotion="strict"``): two
  tensor operands of a broadcasting op with different dtypes (Python
  scalars are exempt, as JAX's weak types; `where`'s condition is not an
  operand);
* debug-NaNs (``jax_debug_nans``): a floating result holding a NaN raises
  (not on fake or meta tensors, which hold no data; not on `empty`-style
  allocations, which are unwritten). On the card each check reads the
  result back: a sanitized run is a debugging lane, not a timed one.

Each raises `SanitizerError`. The lane is the port's own tests, which call
`enable_sanitizers()` themselves; `sanitizers_requested` reads
``REPRO_SANITIZE`` as the JAX package does.

`CompileGuard` is the dynamic complement of lint rule R2. What a step pays
again when it meets a new shape is planning, buffers and, on the card, a
CUDA-graph capture (`serve.graphs`, the counterpart of a JAX compile); the
guard snapshots counters of that growth, runs N steady-state steps, and
asserts none grew. `guard_entries(engine)` gives the counters
(`growth_probes`): the misses of the `lru_cache`d plan functions,
`autotune`'s memo size and trial count, `_build`'s builds and loads, the
split-K workspace's bytes on the engine's device, and each step entry's
graph captures ("capture.<entry>"). An entry
may also be an `lru_cache`d function (its misses) or a `Probe`; any other
callable (a step entry) is tracked as 0, as the JAX guard tracks a
callable without a compile cache.
"""
from __future__ import annotations

import os
from typing import Callable, Mapping

import torch
from torch.overrides import TorchFunctionMode

#: broadcasting ops by name (torch functions, tensor methods, in-place
#: forms and operator dunders) whose operands the rank and dtype rules read
_BINARY = ("add", "sub", "subtract", "mul", "multiply", "div", "divide", "true_divide",
           "floor_divide", "remainder", "fmod", "pow", "maximum", "minimum", "fmax", "fmin",
           "atan2", "eq", "ne", "lt", "le", "gt", "ge", "greater", "less", "greater_equal",
           "less_equal", "not_equal", "logical_and", "logical_or", "logical_xor",
           "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_left_shift",
           "bitwise_right_shift", "hypot", "copysign", "logaddexp", "xlogy", "lerp")
_DUNDERS = ("add", "radd", "iadd", "sub", "rsub", "isub", "mul", "rmul", "imul", "truediv",
            "rtruediv", "itruediv", "floordiv", "rfloordiv", "ifloordiv", "mod", "rmod",
            "imod", "pow", "rpow", "ipow", "and", "rand", "iand", "or", "ror", "ior", "xor",
            "rxor", "ixor", "lshift", "rlshift", "ilshift", "rshift", "rrshift", "irshift",
            "eq", "ne", "lt", "le", "gt", "ge")
BROADCASTING = frozenset(
    [*_BINARY, *(f"{n}_" for n in _BINARY), *(f"__{n}__" for n in _DUNDERS), "where"])
#: allocations whose result is unwritten (never NaN-checked)
_UNWRITTEN = frozenset({"empty", "empty_like", "new_empty", "empty_strided",
                        "new_empty_strided"})
ENV = "REPRO_SANITIZE"


class SanitizerError(ValueError):
    """A sanitizer's rule was broken (raised from the op that broke it)."""


def _name(func) -> str:
    return getattr(func, "__name__", "")


def _operands(name: str, args: tuple, kwargs: dict) -> list:
    """The value operands of a broadcasting call (tensors and scalars)."""
    vals = list(args) + [kwargs[k] for k in ("other", "input", "exponent") if k in kwargs]
    if name == "where":
        vals = vals[1:3]              # the condition is not an operand
    return vals


class _Sanitizer(TorchFunctionMode):
    def __init__(self, debug_nans: bool):
        super().__init__()
        self.debug_nans = debug_nans

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = _name(func)
        if name in BROADCASTING:
            tensors = [v for v in _operands(name, args, kwargs) if isinstance(v, torch.Tensor)]
            ranks = sorted({t.dim() for t in tensors if t.dim() > 0})
            if len(ranks) > 1:
                raise SanitizerError(
                    f"rank promotion in `{name}`: operands of rank {ranks} "
                    f"({[tuple(t.shape) for t in tensors]}) — add the axes explicitly "
                    f"(unsqueeze / [None]), as the JAX package's strict mode requires")
            dtypes = sorted({str(t.dtype) for t in tensors})
            if len(dtypes) > 1:
                raise SanitizerError(
                    f"dtype promotion in `{name}`: operands of {dtypes} — cast "
                    f"explicitly, as the JAX package's strict mode requires")
        out = func(*args, **kwargs)
        if self.debug_nans and name not in _UNWRITTEN:
            _check_nans(name, out)
        return out


def _check_nans(name: str, out) -> None:
    from torch._subclasses.fake_tensor import FakeTensor

    for t in out if isinstance(out, (tuple, list)) else (out,):
        if (isinstance(t, torch.Tensor) and t.is_floating_point() and t.numel()
                and not isinstance(t, FakeTensor) and t.device.type != "meta"
                and bool(torch.isnan(t).any())):
            raise SanitizerError(f"debug-NaNs: `{name}` produced a NaN "
                                 f"(shape {tuple(t.shape)}, {t.dtype})")


def enable_sanitizers(*, debug_nans: bool = True) -> dict:
    """Push the sanitizer mode; → the state `restore_sanitizers` takes."""
    mode = _Sanitizer(bool(debug_nans))
    mode.__enter__()
    return {"mode": mode}


def restore_sanitizers(prev: Mapping) -> None:
    """Pop the mode `enable_sanitizers` pushed (modes nest: LIFO)."""
    prev["mode"].__exit__(None, None, None)


def sanitizers_requested(env: Mapping[str, str] | None = None) -> bool:
    env = os.environ if env is None else env
    return env.get(ENV, "0") not in ("", "0", "false")


# --------------------------------------------------------------------------
# the steady-state guard
# --------------------------------------------------------------------------
class Probe:
    """A growth counter: ``Probe(fn)()`` → int(fn())."""

    def __init__(self, fn: Callable[[], int]):
        self.fn = fn

    def __call__(self) -> int:
        return int(self.fn())


def _size(entry) -> int:
    """An entry's growth: a `Probe`'s count, an `lru_cache`d function's
    misses, else 0 (an opaque callable)."""
    if isinstance(entry, Probe):
        return entry()
    info = getattr(entry, "cache_info", None)
    if callable(info):
        return int(info().misses)
    return 0


def growth_probes(device=None) -> dict[str, Probe]:
    """What grows when a step meets a new shape: the plan functions'
    misses, autotune's memo and trials, the library's builds and loads,
    and (with `device`) the split-K workspace's bytes there."""
    from repro_torch.kernels import _build, _splitk, autotune
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ternary_decode_gemm as tdg
    from repro_torch.kernels import vlut_lookup_gemm as vlg

    probes = {f"plan.{fn.__name__}": Probe(lambda fn=fn: fn.cache_info().misses)
              for fn in (tdg.decode_plan, tdg.grouped_decode_plan, vlg.lut_plan,
                         vlg.grouped_lut_plan, fa.flash_plan)}
    probes["autotune.memo"] = Probe(lambda: len(autotune.default_cache().memo))
    probes["autotune.trials"] = Probe(lambda: autotune.tune.trials)
    probes["build.builds"] = Probe(lambda: _build.build.compiles)
    probes["build.loads"] = Probe(lambda: _build.load.cache_info().misses)
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:      # the workspace's key: cuda:<n>
            dev = torch.device("cuda", torch.cuda.current_device())

        def workspace() -> int:
            cur = _splitk._WORKSPACE.get(dev)
            return 0 if cur is None else sum(t.numel() * t.element_size() for t in cur)

        probes[f"splitk.{dev}"] = Probe(workspace)
    return probes


class CompileGuard:
    """Assert that nothing a step plans or allocates grows after warm-up.

        guard = CompileGuard(guard_entries(engine))
        ... warm-up ticks ...
        guard.arm()
        ... steady-state ticks ...
        guard.assert_steady()   # raises AssertionError naming the culprit
    """

    def __init__(self, entries: Mapping[str, Callable]):
        self.entries = dict(entries)
        self._baseline: dict[str, int] | None = None

    def sizes(self) -> dict[str, int]:
        return {name: _size(fn) for name, fn in self.entries.items()}

    def arm(self) -> dict[str, int]:
        self._baseline = self.sizes()
        return dict(self._baseline)

    def new_compiles(self) -> dict[str, int]:
        assert self._baseline is not None, "arm() before assert/new_compiles"
        now = self.sizes()
        return {name: now[name] - self._baseline[name] for name in self.entries
                if now[name] > self._baseline[name]}

    def assert_steady(self, what: str = "steady state") -> None:
        grew = self.new_compiles()
        assert not grew, (
            f"growth during {what}: "
            + ", ".join(f"{k} (+{v})" for k, v in sorted(grew.items()))
            + " — a shape that varies per step is re-planning the launches or "
              "growing a buffer (lint rule R2 class)")


def guard_entries(obj) -> dict[str, Callable]:
    """The growth probes of an object that serves steps (an `Engine`, a
    `ModelDrafter`: anything with ``step_entries()``), the split-K
    workspace of its device and, where it runs its steps through a
    `serve.graphs.StepGraphs` (``obj.graphs``), each entry's captures
    included; {} for anything else."""
    if not callable(getattr(obj, "step_entries", None)):
        return {}
    probes = growth_probes(getattr(obj, "device", None))
    graphs = getattr(obj, "graphs", None)
    if graphs is not None:
        prefix = getattr(obj, "graph_prefix", "")
        for name in obj.step_entries():
            probes[f"capture.{prefix}{name}"] = Probe(
                lambda key=prefix + name: graphs.captures[key])
    return probes
