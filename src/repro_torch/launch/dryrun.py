"""Multi-pod dry run (ported from `repro.launch.dryrun`): the distribution
configuration of every (arch × shape × mesh) cell, with no device.

For each cell this
  1. takes the mesh's shape (16×16 single-pod, 2×16×16 multi-pod, or the
     small 4×2 one) as a `ShapeMesh`: no process group, no devices;
  2. builds the cell's abstract state on the meta device (no allocation)
     with its `NamedSharding`s from the `dist.sharding` rules: params and
     AdamW state for train_4k, packed serving params and the bf16 cache
     (sized to the cell's sequence) for the prefill and decode cells, and
     the inputs;
  3. records each part's bytes on one device, from each leaf's local shard
     shape (the JAX dry run's ``_per_device_bytes``), `count_params`,
     `model_flops` and the roofline terms on one H100's peaks, with the
     model's FLOPs spread evenly over the devices and each device's state
     bytes as its memory traffic.

The JAX dry run then lowers and compiles each cell's step with XLA and
reads the compiled module: its memory analysis, its cost analysis and its
collectives from the HLO. No compiler lowers the port, so those fields —
``memory_analysis``, ``xla_cost_analysis``, ``hlo_bytes``, ``n_whiles``,
``lower_s``, ``compile_s`` and the roofline's collective term — are
written as null.

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k
  python -m repro_torch.launch.dryrun --all --multi-pod both --out dryrun.jsonl
"""
from __future__ import annotations

import argparse
import json
import time
import traceback

from repro_torch.configs import SHAPES, cell_is_applicable, get_config, list_archs
from repro_torch.dist.sharding import local_bytes
from repro_torch.launch.mesh import mesh_size, production_shape, small_shape
from repro_torch.launch.steps import (
    abstract_cache,
    abstract_serve_params,
    abstract_train_state,
    input_specs,
)
from repro_torch.optim import AdamWConfig
from repro_torch.roofline.analysis import Roofline, count_params, model_flops

#: what the port cannot produce without a compiled module
COMPILE_FIELDS = ("memory_analysis", "xla_cost_analysis", "hlo_bytes", "n_whiles",
                  "unknown_trip_whiles", "lower_s", "compile_s")


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
    try:
        parts = cell_bytes(cfg, shape, mesh)
        state = parts["params"] + parts.get("opt", 0) + parts.get("cache", 0)
        n_total, n_active = count_params(cfg)
        flops = model_flops(cfg, shape, n_total, n_active)
        rl = Roofline(
            arch=arch, shape=shape_name, mesh=rec["mesh"], chips=chips,
            flops_per_device=flops / chips, bytes_per_device=float(state),
            coll_bytes_per_device=None, coll_detail=None,
            model_flops_total=flops, min_bytes_per_device=float(state),
        )
        rec.update(
            status="ok", chips=chips,
            state_bytes_per_device=state,
            bytes_per_device=parts,
            params_total=n_total, params_active=n_active,
            roofline=rl.row(),
            build_s=round(time.perf_counter() - t0, 2),
            **{k: None for k in COMPILE_FIELDS},
        )
        if verbose:
            print(f"[OK] {arch} × {shape_name} × {rec['mesh']}: "
                  f"state/dev={state / 2**30:.2f}GiB "
                  f"inputs/dev={parts['inputs'] / 2**20:.2f}MiB "
                  f"dominant={rl.dominant} terms=({rl.compute_s:.4f},{rl.memory_s:.4f},"
                  f"null)s frac={rl.roofline_fraction:.3f}")
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
