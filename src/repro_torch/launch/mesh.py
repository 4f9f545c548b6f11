"""Device meshes (ported from `repro.launch.mesh`).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` with named dims
("data", "model") or ("pod", "data", "model"), built on an explicit device
type over the default process group, which must have exactly the mesh's
size (`torch.distributed.init_process_group` first). `ShapeMesh` is the
shape-only stand-in (names and sizes, no process group, no devices): the
sharding rules and the dry run take either.

A JAX mesh's ``.shape`` is a dict by name; a `DeviceMesh`'s is a tuple in
dim order. `mesh_axes` reads either as ``{name: size}``, and `batch_axes` /
`axis_size` read sizes by name through it.

`fake_mesh(shape)` is the real `DeviceMesh` of a `ShapeMesh` in one
process, over a fake process group of the mesh's world size: collectives
run nowhere (and on fake tensors are never called), so DTensor code runs
as rank 0 of a 256- or 512-device mesh would, for the dry run's traces.
"""
from __future__ import annotations

import contextlib
import math

PRODUCTION_SHAPE = {"data": 16, "model": 16}
PRODUCTION_MULTI_POD = {"pod": 2, "data": 16, "model": 16}


class ShapeMesh:
    """Named mesh dims and their sizes, without devices or a process group
    (the DeviceMesh attributes the rules read: ``mesh_dim_names``,
    ``shape``, ``size()``)."""

    def __init__(self, **axes: int):
        self.mesh_dim_names = tuple(axes)
        self.shape = tuple(int(n) for n in axes.values())

    def size(self) -> int:
        return math.prod(self.shape)

    def __repr__(self) -> str:
        dims = ", ".join(f"{n}={s}" for n, s in zip(self.mesh_dim_names, self.shape))
        return f"ShapeMesh({dims})"


def mesh_axes(mesh) -> dict[str, int]:
    """{axis name: size} of a DeviceMesh, a ShapeMesh, or any object with
    JAX's ``axis_names`` and a ``shape`` dict."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return {n: int(mesh.shape[n]) for n in mesh.axis_names}


def mesh_size(mesh) -> int:
    return math.prod(mesh_axes(mesh).values())


def production_shape(*, multi_pod: bool = False) -> ShapeMesh:
    """The production mesh's shape: 16×16 = 256 chips a pod; 2 pods."""
    return ShapeMesh(**(PRODUCTION_MULTI_POD if multi_pod else PRODUCTION_SHAPE))


def small_shape(n_data: int = 4, n_model: int = 2, *, multi_pod: bool = False) -> ShapeMesh:
    """The reduced mesh's shape (8 devices by default)."""
    if multi_pod:
        return ShapeMesh(pod=2, data=n_data // 2, model=n_model)
    return ShapeMesh(data=n_data, model=n_model)


def _device_mesh(shape: ShapeMesh, device_type: str | None):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            f"a {shape} needs a process group of {shape.size()} ranks: call "
            "torch.distributed.init_process_group first")
    if dist.get_world_size() != shape.size():
        raise ValueError(f"the process group has {dist.get_world_size()} ranks, "
                         f"the mesh {shape} needs {shape.size()}")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, shape.shape, mesh_dim_names=shape.mesh_dim_names)


def _register_fake_backend() -> None:
    """Register c10d's "fake" backend (`FakeProcessGroup`: every
    collective a no-op) unless it is: the port's own copy of what
    ``torch.testing``'s fake process group does."""
    import torch.distributed as dist
    from torch._C._distributed_c10d import FakeProcessGroup

    if "FAKE" in getattr(dist.Backend, "_plugins", {}):
        return

    def create(common_opts, backend_opts):
        if hasattr(FakeProcessGroup, "_create_internal"):
            return FakeProcessGroup._create_internal(common_opts.group_rank,
                                                     common_opts.group_size, backend_opts)
        return FakeProcessGroup(common_opts.group_rank, common_opts.group_size)

    dist.Backend.register_backend("fake", create, extended_api=True, devices=["cpu", "cuda"])


@contextlib.contextmanager
def fake_mesh(shape: ShapeMesh, device_type: str | None = None):
    """The `DeviceMesh` of `shape` (named dims) on `device_type` (default:
    cuda where there is one, else cpu) over a fake process group of
    ``shape.size()`` ranks, this process rank 0; the group is destroyed on
    exit, so a sweep enters one context a cell (world sizes 256, 512, 8)
    and nothing is left for later code in the process. Refuses to run
    where a process group already exists."""
    import torch.distributed as dist

    if dist.is_initialized():
        raise RuntimeError("fake_mesh: a process group is already initialized")
    _register_fake_backend()
    dist.init_process_group("fake", rank=0, world_size=shape.size(), store=dist.HashStore())
    try:
        yield _device_mesh(shape, device_type)
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False, device_type: str | None = None):
    """16×16 = 256 devices a pod; 2 pods = 512 multi-pod. `device_type`:
    "cuda" or "cpu" (default: cuda where there is one)."""
    return _device_mesh(production_shape(multi_pod=multi_pod), device_type)


def make_small_mesh(n_data: int = 4, n_model: int = 2, *, multi_pod: bool = False,
                    device_type: str | None = None):
    """A reduced mesh (tests, one card: ``make_small_mesh(1, 1)``)."""
    return _device_mesh(small_shape(n_data, n_model, multi_pod=multi_pod), device_type)


def batch_axes(mesh) -> tuple[str, ...]:
    """Mesh axes that jointly shard the batch / FSDP dimension."""
    names = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def axis_size(mesh, names) -> int:
    if isinstance(names, str):
        names = (names,)
    sizes = mesh_axes(mesh)
    out = 1
    for n in names:
        out *= sizes.get(n, 1)
    return out
