#!/usr/bin/env python3
"""Tune the tensor-core flash kernel's constants on the card.

    python3 tools/flash_tune.py

Builds variants of `src/repro_torch/csrc/flash_attention.cu` that differ
only in the tensor-core kernel's keys per tile (kBK: 16, 32, 64), its K/V
buffers (kStages: 2, 3) and its launch bound's blocks per SM at DP <= 64
(1, or 4 = at most 128 registers a thread), each by nvcc into its own
library (in parallel); checks each against the plain version at the
training shape of smollm-360m (B 8, S 512, H 15, KV 5, D 64, causal, bf16,
the model's transposed views), and times each there and at S 2048 (device
ms under CUDA-graph replay), beside `F.scaled_dot_product_attention` as a
yardstick. Prints one line per variant with its -Xptxas -v registers and
spill bytes; the table goes to chiprun_out/flash_tune.json. Needs a card
and nvcc.
"""
from __future__ import annotations

import ctypes
import dataclasses
import itertools
import json
import pathlib
import re
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SHIPPED = (32, 2, 4)      # (kBK, kStages, blocks per SM at DP <= 64) of the source
SHAPES = {"train": (8, 512, 15, 5, 64), "s2048": (1, 2048, 15, 5, 64)}   # (B, S, H, KV, D)


def variant_source(src: str, bk: int, stages: int, minb: int) -> str:
    head, tc = src.split("namespace tc {")
    subs = ((r"constexpr int kBK = \d+;", f"constexpr int kBK = {bk};"),
            (r"constexpr int kStages = \d+;", f"constexpr int kStages = {stages};"),
            (r"DP <= 64 \? \d+ : 1\)", f"DP <= 64 ? {minb} : 1)"))
    for pat, rep in subs:
        tc, n = re.subn(pat, rep, tc)
        assert n == 1, pat
    return head + "namespace tc {" + tc


def ptxas_mma(log: str) -> dict:
    """registers and spill bytes of the DP 64 tensor-core instantiation."""
    out, entry = {}, False
    for line in log.splitlines():
        if "Compiling entry" in line:
            entry = "flash_mma_kernelILi64E" in line
        elif entry and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            out["spill_bytes"] = nums[1] + nums[2]
        elif entry and "registers" in line:
            out["registers"] = int(line.split("Used ")[1].split()[0])
    return out


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("flash_tune: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    src = (_build.CSRC / "flash_attention.cu").read_text()
    work = pathlib.Path(tempfile.mkdtemp(prefix="flash_tune-"))
    nvcc = _build._nvcc()
    variants = list(itertools.product((16, 32, 64), (2, 3), (1, 4)))
    procs = {}
    for v in variants:
        d = work / "bk{}_s{}_mb{}".format(*v)
        d.mkdir()
        (d / "f.cu").write_text(variant_source(src, *v))
        procs[v] = subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-shared", str(d / "f.cu"),
                                     "-o", str(d / "lib.so")],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, regs = {}, {}
    for v, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for variant {v}:\n{log[-3000:]}")
        regs[v] = ptxas_mma(log)
        lib = ctypes.CDLL(str(work / "bk{}_s{}_mb{}".format(*v) / "lib.so"))
        lib.flash_attention_fwd.argtypes = _build._FLASH_ARGTYPES
        lib.flash_attention_fwd.restype = ctypes.c_int
        libs[v] = lib

    gen = torch.Generator(device="cuda").manual_seed(0)

    def device_ms(fn, reps=50):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        graph.replay()
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            graph.replay()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / reps

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    rows = []
    for shape_name, (b, s, h, kv, d) in SHAPES.items():
        q, k, v = (torch.randn((b, s, n, d), generator=gen, device="cuda")
                   .to(torch.bfloat16).transpose(1, 2) for n in (h, kv, kv))
        out = torch.empty_like(q)
        want = fa.flash_attention_plain(q, k, v, causal=True)
        bound = 2.0 ** -7 * max(1.0, want.float().abs().max().item())
        base = fa.plan_for(q, k, v, out, causal=True, window=0)
        qc, kc, vc = (t.contiguous() for t in (q, k, v))
        sdpa = device_ms(lambda: F.scaled_dot_product_attention(qc, kc, vc, is_causal=True,
                                                                 enable_gqa=True))
        for var, lib in libs.items():
            bk, stages, _ = var
            plan = dataclasses.replace(base, bk=bk, stages=stages,
                                       smem=2 * base.dp * (base.bq + 2 * stages * bk))

            def launch(lib=lib, plan=plan):
                rc = lib.flash_attention_fwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, kv, s, s, d,
                    *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                    1, 0, d ** -0.5, 0.0, 1, plan.bq, plan.bk, plan.dp, plan.stages,
                    int(plan.aligned), plan.smem, torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"variant {var}: CUDA error {rc}")

            launch()
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs().max().item()
            if not err <= bound:
                raise AssertionError(f"variant {var} at {shape_name}: |diff| {err} > {bound}")
            row = {"shape": shape_name, "bk": bk, "stages": stages, "blocks_per_sm": var[2],
                   "shipped": var == SHIPPED, **regs[var], "max_abs_err": err,
                   "ms": device_ms(launch), "sdpa_ms": sdpa}
            rows.append(row)
            print(f"{shape_name} kBK {bk} kStages {stages} min blocks {var[2]}: "
                  f"{row['ms']:.4f} ms (sdpa {sdpa:.4f}), {row.get('registers')} registers, "
                  f"{row.get('spill_bytes')} spill bytes" + ("  <- shipped" if row["shipped"] else ""),
                  flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "flash_tune.json").write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
