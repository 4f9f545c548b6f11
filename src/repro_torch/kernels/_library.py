"""The kernels as `torch.library` operators, in the ``repro_torch``
namespace, so that a trace of a step sees each launch as one operation.

Each kernel entry point (the four single mpGeMM entries, the four grouped
ones and the flash forward) is an operator with three implementations:

- a fake one: the output's shape, dtype and strides, no launch, no change
  to a ``launches`` counter (`torch.library.register_fake`; it also serves
  the meta device);
- a CUDA one: the wrapper's launch function as it is (the plan from
  `autotune.get_plan` unless one is given, the split-K workspace, the
  counter; a failed build raises);
- a CPU one: the plain version.

The wrappers launch directly on real CUDA tensors and take the plain
version on real CPU tensors; they go through the operator only for a fake
tensor (`traced`), that is, inside a trace. The dispatcher's hop
costs more host time than a launch may add at serving's 224 launches a
forward (the port's step statistics and `chip_smoke.py` phase 18 measure
it), and both routes call the same launch function.

A launch plan crosses an operator's schema as an ``int[]?`` of its
dataclass's fields in order (`plan_fields`, `plan_from`): every plan field
is an int or a bool.
"""
from __future__ import annotations

import dataclasses

import torch
from torch._subclasses.fake_tensor import FakeTensor

NAMESPACE = "repro_torch"


def traced(t: torch.Tensor) -> bool:
    """Does `t` take the operator's route? A fake tensor (a trace under
    `FakeTensorMode`): it has no data to launch on. (A meta tensor is
    refused as any non-CUDA device is.)"""
    return isinstance(t, FakeTensor)


def plan_fields(plan) -> list[int] | None:
    """A plan dataclass as the operator's ``int[]?``: its fields in order,
    bools as 0/1; None stays None (the launch asks `autotune.get_plan`)."""
    if plan is None:
        return None
    return [int(getattr(plan, f.name)) for f in dataclasses.fields(plan)]


def plan_from(cls, fields):
    """`plan_fields`'s inverse for the plan class `cls`."""
    if fields is None:
        return None
    return cls(*(bool(v) if f.type in ("bool", bool) else int(v)
                 for f, v in zip(dataclasses.fields(cls), fields)))


def define(name: str, schema: str, *, cpu, cuda, fake):
    """Register ``repro_torch::<name>`` with its three implementations;
    → the operator (``torch.ops.repro_torch.<name>``)."""
    op = torch.library.custom_op(f"{NAMESPACE}::{name}", cpu, mutates_args=(),
                                 device_types="cpu", schema=schema)
    op.register_kernel("cuda")(cuda)
    op.register_fake(fake)
    return op
