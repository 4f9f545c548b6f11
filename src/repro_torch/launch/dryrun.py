"""Multi-pod dry run (ported from `repro.launch.dryrun`): the distribution
configuration of every (arch × shape × mesh) cell, with no device.

For each cell this
  1. takes the mesh's shape (16×16 single-pod, 2×16×16 multi-pod, or the
     small 4×2 one) as a `ShapeMesh`;
  2. builds the cell's abstract state on the meta device (no allocation)
     with its `NamedSharding`s from the `dist.sharding` rules: params and
     AdamW state for train_4k, packed serving params and the bf16 cache
     (sized to the cell's sequence) for the prefill and decode cells, and
     the inputs, and records each part's bytes on one device, from each
     leaf's local shard shape (the JAX dry run's ``_per_device_bytes``);
  3. builds the same state as fake tensors placed as DTensors on the real
     `DeviceMesh` of that shape over a fake process group (`fake_mesh`),
     and traces the cell's step on them (`roofline.hlo_stats.trace_step`):
     the QAT training step (forward, backward, AdamW) for train_4k, the
     greedy prefill or decode step for the serving cells, under
     ``use_sharding_ctx``. Serving runs the "xla" mpGeMM impl there, as
     the JAX dry run compiles it (its default off the TPU: the shardable
     streamed decode);
  4. records the trace's statistics (`step_stats`): the roofline's three
     terms on one H100's peaks from the trace's per-device FLOPs (library
     products and kernels), its eager traffic and its collective bytes;
     ``memory_analysis`` from the trace's live bytes; ``lower_s``, the
     trace's seconds. The trace is saved under ``results/graphs/``
     (lzma-compressed JSON) so the statistics can be recomputed offline,
     as the JAX dry run saves its HLO.

``compile_s``, ``xla_cost_analysis`` and ``hlo_bytes`` stay null: no
compiler runs. ``n_whiles`` and ``unknown_trip_whiles`` are null too: an
eager trace unrolls the layers (`hlo_stats`).

The fake tensors sit on the cuda device where torch is built with CUDA,
else on the cpu (a CPU-only build's autograd aborts the process on a fake
cuda tensor); no code of the steps branches on the device type except the
kernels' wrappers, which send fake tensors of either device to the same
operators.

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k
  python -m repro_torch.launch.dryrun --all --multi-pod both --out dryrun.jsonl
"""
from __future__ import annotations

import argparse
import contextlib
import json
import lzma
import os
import sys
import time
import traceback

import torch

from repro_torch.configs import SHAPES, cell_is_applicable, get_config, list_archs
from repro_torch.dist.sharding import (
    distribute,
    distribute_tree,
    local_bytes,
    map_with_names,
    param_shardings,
    use_sharding_ctx,
)
from repro_torch.launch.mesh import (
    ShapeMesh,
    fake_mesh,
    mesh_axes,
    mesh_size,
    production_shape,
    small_shape,
)
from repro_torch.launch.steps import (
    abstract_cache,
    abstract_serve_params,
    abstract_train_state,
    input_specs,
    make_decode_step,
    make_prefill_step,
    make_train_step,
    meta_model,
)
from repro_torch.optim import AdamWConfig
from repro_torch.roofline.analysis import Roofline, count_params, model_flops
from repro_torch.roofline.hlo_stats import fake_module, step_stats, trace_step

#: what the port cannot produce without a compiler
COMPILE_FIELDS = ("xla_cost_analysis", "hlo_bytes", "n_whiles", "unknown_trip_whiles",
                  "compile_s")
GRAPHS_DIR = os.path.join("results", "graphs")


def cell_bytes(cfg, shape, mesh) -> dict[str, int]:
    """Bytes on one device of each part of the cell's state: params, opt
    (train) or cache (serving), and inputs."""
    out: dict[str, int] = {}
    if shape.kind == "train":
        state, shard = abstract_train_state(cfg, AdamWConfig(), mesh)
        out["params"] = local_bytes(state["params"], shard["params"])
        out["opt"] = local_bytes(state["opt"], shard["opt"])
    else:
        enc_len = shape.seq_len // cfg.enc_frame_ratio if cfg.family == "encdec" else 0
        params, pshard = abstract_serve_params(cfg, mesh)
        cache, cshard = abstract_cache(cfg, mesh, shape.global_batch, shape.seq_len, enc_len)
        out["params"] = local_bytes(params, pshard)
        out["cache"] = local_bytes(cache, cshard)
    batch, bshard = input_specs(cfg, shape, mesh)
    out["inputs"] = local_bytes(batch, bshard)
    return out


def _fake(t: torch.Tensor, device: str) -> torch.Tensor:
    """An unwritten fake tensor like the meta tensor `t` (under the mode)."""
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=device)


def _placed_model(cfg, mesh, device: str, mode, *, packed: bool):
    """The cell's model (dense for training, packed for serving) as fake
    tensors, every parameter and packed buffer a DTensor placed by the
    `dist.sharding` rules (a packed linear's three buffers by its
    `PackedWeight`'s spec)."""
    from repro_torch.bridge import named_leaves

    model = fake_module(meta_model(cfg, packed=packed), device, mode)
    with mode:
        leaves = named_leaves(model)
        shard = param_shardings(leaves, mesh, cfg)
        for name, leaf in leaves.items():
            owner, attr = name.rsplit(".", 1)
            mod = model.get_submodule(owner)
            if attr == "pw":
                for f in ("packed5", "packed4", "scale"):
                    setattr(mod, f, distribute(getattr(leaf, f), getattr(shard[name], f)))
            else:
                setattr(mod, attr, torch.nn.Parameter(distribute(leaf.detach(), shard[name]),
                                                      requires_grad=not packed))
    return model


def _placed_tree(tree, shardings, device: str, mode):
    """A tree of meta tensors as fake DTensors placed by `shardings`."""
    with mode:
        return distribute_tree(map_with_names(lambda _, t: _fake(t, device), tree), shardings)


#: DTensor's metadata computations (shard shapes and offsets, redistribution
#: plans), run with the fake mode unset: (module, attribute)
_DTENSOR_METADATA = (
    ("torch.distributed.tensor._utils", "_compute_local_shape_and_global_offset"),
    ("torch.distributed.tensor._redistribute", "_gen_transform_infos_non_cached"),
)
#: DTensor's propagation of an op's global shape, stride and dtype: it runs
#: the op on global-shaped fake tensors (once a schema, then cached), which
#: is no part of the step and is not recorded (class, method)
_DTENSOR_GLOBAL_META = (
    ("torch.distributed.tensor._sharding_prop",
     "ShardingPropagator._propagate_tensor_meta_non_cached"),
)
#: where DTensor's sharding propagation prices a candidate strategy
_DTENSOR_COSTS = (
    ("torch.distributed.tensor._collective_utils", "redistribute_cost"),
    ("torch.distributed.tensor._ops.utils", "redistribute_cost"),
    ("torch.distributed.tensor._utils", "redistribute_cost"),
)


@contextlib.contextmanager
def _dtensor_for_tracing(greedy_prices: bool = True):
    """DTensor adapted to a trace on fake tensors.

    DTensor computes shard shapes and offsets, in its redistribution plans
    too, with small index tensors that it reads back (``int(offsets[0])``,
    ``.tolist()``); under a `FakeTensorMode` those tensors are fake and the
    read raises. These computations take shapes and placements only: they
    run with the fake mode unset, their index tensors real, tiny, and no
    part of the step (`trace_step` records only ops on fake tensors).
    DTensor derives an op's global output shape by running the op on
    global-shaped fake tensors the first time it meets the op's schema:
    that runs with every dispatch mode unset (its own fake mode), so the
    trace neither records it nor counts its global-sized bytes.

    Its sharding propagation prices every candidate strategy of an op by
    planning the redistribution it would need; where a strided shard
    appears (a flattened batch and sequence) DTensor plans by a graph
    search over placements, which on the 3-D multi-pod mesh takes minutes
    a cell when run for every candidate. The prices alone are taken from
    its greedy planner (its default for placements in default order); the
    redistributions that run are planned as DTensor plans them.
    Propagation picks each op's strategy by those prices, so a greedy price
    could pick another strategy than the graph search's: `greedy_prices`
    False keeps DTensor's own prices (the tests trace small-mesh cells both
    ways and hold the op streams equal). A patch target this torch lacks
    raises: the trace would otherwise run unpatched, or differently."""
    import importlib

    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import _redistribute
    from torch.utils._python_dispatch import _disable_current_modes

    pricing: list = []

    def untraced(fn):
        def wrapped(*args, **kwargs):
            with _disable_current_modes():
                return fn(*args, **kwargs)
        return wrapped

    def on_host(fn):
        def wrapped(*args, **kwargs):
            with unset_fake_temporarily():
                return fn(*args, **kwargs)
        return wrapped

    def priced(fn):
        def wrapped(*args, **kwargs):
            pricing.append(True)
            try:
                return fn(*args, **kwargs)
            finally:
                pricing.pop()
        return wrapped

    def planned(fn):
        def wrapped(src_spec, dst_spec, *args, **kwargs):
            if pricing:
                try:
                    with unset_fake_temporarily():
                        return _redistribute.get_redistribute_planner(
                            src_spec.device_mesh, src_spec.tensor_meta,
                        ).generate_greedy_transform_infos(src_spec, dst_spec)
                except Exception:   # noqa: BLE001 — a spec only the graph search plans
                    pass
            return fn(src_spec, dst_spec, *args, **kwargs)
        return wrapped

    patches = [(m, a, on_host) for m, a in _DTENSOR_METADATA]
    patches += [(m, a, untraced) for m, a in _DTENSOR_GLOBAL_META]
    if greedy_prices:
        patches += [(m, a, priced) for m, a in _DTENSOR_COSTS]
        patches.append(("torch.distributed.tensor._redistribute", "_gen_transform_infos",
                        planned))
    targets, missing = [], []
    for mod_name, attr, wrap in patches:
        owner = importlib.import_module(mod_name)
        *path, attr = attr.split(".")
        for name in path:
            owner = getattr(owner, name, None)
        if owner is None or not hasattr(owner, attr):
            missing.append(f"{mod_name}.{'.'.join([*path, attr])}")
        targets.append((owner, attr, wrap))
    if missing:
        raise RuntimeError(f"torch {torch.__version__} lacks what the dry run's trace "
                           f"adapts: {', '.join(missing)}")
    saved = []
    for owner, attr, wrap in targets:
        fn = getattr(owner, attr)
        saved.append((owner, attr, fn))
        setattr(owner, attr, wrap(fn))
    try:
        yield
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)


#: the most elements of an index tensor `_HostIndices` makes on the host
HOST_INDEX_NUMEL = 1 << 24


def _called_from_dtensor() -> bool:
    """Is the nearest caller outside torch's dispatch machinery DTensor's
    own code (``torch/distributed/``)? A step's code, or anything else,
    answers no."""
    frame = sys._getframe(2)
    while frame is not None:
        name = frame.f_code.co_filename.replace("\\", "/")
        if "/torch/distributed/" in name:
            return True
        if "/torch/" not in name and name != __file__:
            return False
        frame = frame.f_back
    return False


def _host_indices():
    """A dispatch mode under which the cpu index tensors DTensor's own code
    makes from Python values (``arange``; ``tensor`` of a list is real
    already) are made for real on the host, not faked, and so is what is
    computed from such host tensors alone: DTensor builds the index tensors
    that reorder a strided shard's gathered blocks that way and reads them
    back (``.tolist()``), which a fake tensor cannot. They carry shapes
    and positions, not the step's data; every tensor the step itself makes
    stays fake."""
    from torch._subclasses.fake_tensor import FakeTensor, unset_fake_temporarily
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    from torch.distributed.tensor import DTensor

    class _HostIndices(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented       # DTensor's own ops then come back here
            kwargs = kwargs or {}
            tensors = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
            if tensors and not any(isinstance(t, FakeTensor) for t in tensors):
                with unset_fake_temporarily():          # host tensors in, host tensors out
                    return func(*args, **kwargs)
            out = func(*args, **kwargs)
            if (func.overloadpacket is torch.ops.aten.arange and out.device.type == "cpu"
                    and out.numel() <= HOST_INDEX_NUMEL and _called_from_dtensor()):
                with unset_fake_temporarily():
                    return func(*args, **kwargs)
            return out

    return _HostIndices()


def trace_cell(cfg, shape, mesh, device: str, *, greedy_prices: bool = True):
    """Trace the cell's step on fake DTensors over `mesh` → (`Trace`,
    `HloStats`). `greedy_prices`: `_dtensor_for_tracing`'s."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.kernels.ops import dispatch_override

    # real host index tensors (`_host_indices`) meet fake ones: allowed
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    batch, bshard = input_specs(cfg, shape, mesh)
    batch = _placed_tree(batch, bshard, device, mode)
    if shape.kind == "train":
        model = _placed_model(cfg, mesh, device, mode, packed=False)
        state, shard = abstract_train_state(cfg, AdamWConfig(), mesh)
        opt = _placed_tree(state["opt"], shard["opt"], device, mode)
        step = make_train_step(cfg, AdamWConfig())
        state = {"params": dict(model.named_parameters()), "opt": opt}
        args = (model, state, batch)
    else:
        enc_len = shape.seq_len // cfg.enc_frame_ratio if cfg.family == "encdec" else 0
        model = _placed_model(cfg, mesh, device, mode, packed=True)
        cache, cshard = abstract_cache(cfg, mesh, shape.global_batch, shape.seq_len, enc_len)
        cache = _placed_tree(cache, cshard, device, mode)
        if shape.kind == "prefill":
            step, args = make_prefill_step(cfg, device=device), (model, cache, batch)
        else:
            step, args = make_decode_step(cfg, device=device), (model, cache, batch["tokens"])

    def run(*a):
        with (use_sharding_ctx(mesh, cfg), implicit_replication(), _dtensor_for_tracing(greedy_prices),
              _host_indices(), dispatch_override(impl="xla")):
            return step(*a)

    trace, _ = trace_step(run, *args)
    return trace, step_stats(trace)


def trace_shape(mesh: ShapeMesh, shape) -> ShapeMesh:
    """The mesh a cell's step is traced on: `mesh`, or, on a multi-pod
    mesh whose pod and data axes shard every batch together (the cell's
    global batch divides over both, so no rule falls back to "data"
    alone), the same devices with pod and data merged into one "data"
    axis of pod x data ranks. Each device then holds the same shards and
    each collective spans the same ranks (one collective over pod x data
    where the 3-D mesh issues one over each); DTensor's placement search
    over three mesh dims takes more than 15 minutes a training cell."""
    axes = mesh_axes(mesh)
    if "pod" not in axes or shape.global_batch % (axes["pod"] * axes["data"]):
        return mesh
    return ShapeMesh(data=axes["pod"] * axes["data"], model=axes["model"])


def _save_graph(rec: dict, trace) -> None:
    """The cell's recorded op list, lzma-compressed JSON under
    ``results/graphs/`` (the JAX dry run's ``_save_hlo``), for offline
    reanalysis (`Trace.from_json`, `step_stats`)."""
    os.makedirs(GRAPHS_DIR, exist_ok=True)
    path = os.path.join(GRAPHS_DIR, f"{rec['arch']}_{rec['shape']}_{rec['mesh']}.json.xz")
    with open(path, "wb") as f:
        f.write(lzma.compress(trace.to_json().encode(), preset=1))
    rec["graph_path"] = path


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False, small_mesh: bool = False,
             verbose: bool = True) -> dict:
    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    rec: dict = {
        "arch": arch, "shape": shape_name,
        "mesh": ("small" if small_mesh else ("2x16x16" if multi_pod else "16x16")),
    }
    if not cell_is_applicable(arch, shape_name):
        rec.update(status="skipped", reason="full-attention arch: long_500k N/A")
        return rec
    t0 = time.perf_counter()
    mesh = (small_shape(multi_pod=multi_pod) if small_mesh
            else production_shape(multi_pod=multi_pod))
    chips = mesh_size(mesh)
    cfg = cfg.with_(max_cache_len=shape.seq_len)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    try:
        parts = cell_bytes(cfg, shape, mesh)
        state = parts["params"] + parts.get("opt", 0) + parts.get("cache", 0)
        n_total, n_active = count_params(cfg)
        flops = model_flops(cfg, shape, n_total, n_active)
        build_s = time.perf_counter() - t0
        with fake_mesh(trace_shape(mesh, shape), device) as dmesh:
            trace, stats = trace_cell(cfg, shape, dmesh, device)
        rl = Roofline(
            arch=arch, shape=shape_name, mesh=rec["mesh"], chips=chips,
            flops_per_device=stats.flops, bytes_per_device=stats.traffic_bytes,
            coll_bytes_per_device=stats.collective_bytes, coll_detail=stats.collectives,
            model_flops_total=flops, min_bytes_per_device=float(state),
        )
        rec.update(
            status="ok", chips=chips,
            state_bytes_per_device=state,
            bytes_per_device=parts,
            params_total=n_total, params_active=n_active,
            roofline=rl.row(),
            memory_analysis=stats.memory,
            step_stats={"dot_flops": stats.dot_flops, "kernel_flops": stats.kernel_flops,
                        "traffic_bytes": stats.traffic_bytes, "launches": stats.launches,
                        "ops": len(trace.ops)},
            build_s=round(build_s, 2),
            lower_s=round(trace.seconds, 2),
            **{k: None for k in COMPILE_FIELDS},
        )
        _save_graph(rec, trace)
        if verbose:
            ma = stats.memory
            print(f"[OK] {arch} × {shape_name} × {rec['mesh']}: "
                  f"trace={rec['lower_s']}s ops={len(trace.ops)} "
                  f"state/dev={state / 2**30:.2f}GiB "
                  f"temp/dev={ma['temp_size_in_bytes'] / 2**30:.2f}GiB "
                  f"dominant={rl.dominant} terms=({rl.compute_s:.4f},{rl.memory_s:.4f},"
                  f"{rl.collective_s:.4f})s frac={rl.roofline_fraction:.3f}")
    except Exception as e:  # noqa: BLE001 — recorded, the sweep continues
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[FAIL] {arch} × {shape_name} × {rec['mesh']}: {e}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=[*SHAPES, None])
    ap.add_argument("--multi-pod", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--small-mesh", action="store_true", help="the 4×2 mesh's shape")
    ap.add_argument("--out", default=None, help="append JSONL results here")
    args = ap.parse_args(argv)

    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    pods = {"single": [False], "multi": [True], "both": [False, True]}[args.multi_pod]

    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in pods:
                rec = run_cell(arch, shape, multi_pod=mp, small_mesh=args.small_mesh)
                n_fail += rec["status"] == "error"
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(rec) + "\n")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
