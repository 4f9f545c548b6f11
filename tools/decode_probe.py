#!/usr/bin/env python3
"""Probe what bounds the grouped ternary-decode kernel on the card.

    python3 tools/decode_probe.py

Builds variants of `src/repro_torch/csrc/ternary_decode_gemm.cu` that
differ only in `decode_grouped_kernel` (source substitutions, each checked
to apply), each by nvcc into its own library (in parallel), and times
each at deepseek-v3's routed expert segments (E 256, C 16, random codes:
w1 M 2048 x KG 1432 and w2 M 7168 x KG 408, g 5), integer and fused (bf16),
as device ms under CUDA-graph replay, on random rows and on a decode step's
rows (token 0 of the first 32 experts real, every other row 0). A variant
that keeps the function is checked bit for bit against the plain version
(16 experts at a time) on both kinds of rows; a probe that removes a part
(the copies, the decode, the mma) gives wrong sums and is only timed:

- shipped: the source as it is;
- no_skip: a block whose staged slice is all zero streams its codes all
  the same (the zero-tile skip taken back);
- one_copy: every lane reads one copy of the trit table (the 16
  interleaved copies taken back);
- no_zero_test: the fused prologue divides zero activations too (plain
  IEEE `v / s`, slow on a zero dividend) instead of taking them as 0;
- no_copy: the loop issues no copies (the slot keeps stale codes): the
  loop without its memory stream;
- no_decode: the A words are the raw code words (no table, no permutes);
- no_mma: each mma replaced by XORs into the accumulators;
- stream: no decode, no mma, no B reads: the copies and the loop;
- alu_decode: trits by arithmetic on 16-bit lanes (q = (x * 171) >> 9,
  r = x - 3q), no table;
- table32: decode_kernel's 32-bit table in 32 lane copies (one bank a
  lane), trit 4 by byte-wise compares;
- l2_hint: the copies with the L2 256-byte prefetch hint (the L2 fetches
  the 256 bytes around each copy: a row's next steps);
- warps8: 8 warps a block (256 threads, up to 255 registers) with two
  slots a warp;
- step64: two slots of 64 K-groups a warp: each row read 64 bytes at a
  time, twice the waits;
- step64_ahead: the same with the next step's copy in flight while this
  one is decoded (streaming ahead).
The two-slot variants keep the shipped shared bytes, so the shipped plan
launches them.

Prints one line per variant, shape and kind of rows with its -Xptxas -v
registers and spill bytes (G 5, integer and bf16 -> bf16); the table goes
to chiprun_out/decode_probe.json. Needs a card and nvcc.
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

MMA = "                mma_s8(acc[h][nt], a[j], b.x, b.y);"
DECODE = "              decode_word2<G>(tk, cur[r], tr);"
B_LOAD = """                const uint2 b = *reinterpret_cast<const uint2*>(
                    aq + (j * gp.bn + nt * 8 + gid) * gp.rs + kk0 + s * kSub + 8 * tq);"""
COPY_LINE = "        issue();                              // item it"
WAIT = """        __syncwarp();                         // item it - 1's reads of the slot are done
        issue();                              // item it
        cp_async_wait_all();                  // item it has landed (this lane's copies)
        __syncwarp();                         // ... the warp's"""
# two slots a warp, taking turns by item, in the shipped ring bytes' room
TWO_SLOTS = [
    ("return (size_t)kGWarps * kGSlot; }", "return (size_t)kGWarps * 2 * kGSlot; }"),
    ("  int8_t* slot = aq + (size_t)G * gp.bn * gp.rs + (size_t)warp * kGSlot;",
     "  int8_t* const ring = aq + (size_t)G * gp.bn * gp.rs + (size_t)warp * 2 * kGSlot;\n"
     "  int8_t* slot = ring;"),
    ("                  src, p.KG, slot, lane);", "                  src, p.KG, ring + (it_issue % 2) * kGSlot, lane);"),
    ("        __syncwarp();                         // ... the warp's\n",
     "        __syncwarp();                         // ... the warp's\n        slot = ring + (it % 2) * kGSlot;\n"),
]
STEP64 = [("constexpr int kGStep = 128;", "constexpr int kGStep = 64; ")] + TWO_SLOTS
AHEAD = [(WAIT, """        cp_async_wait_all();
        __syncwarp();
        issue();                              // item it + 1, into the slot item it - 1 held"""),
         ("    __syncthreads();                          // s_scale",
          "    issue();\n    __syncthreads();                          // s_scale"),
         ("    if (skip) {\n", "    if (skip) {\n      cp_async_wait_all();\n")]
NO_MMA = (MMA, "                acc[h][nt][0] ^= a[j][0] ^ b.x, acc[h][nt][1] ^= a[j][1] ^ b.y, "
               "acc[h][nt][2] ^= a[j][2], acc[h][nt][3] ^= a[j][3];")
NO_DECODE = (DECODE, "              for (int jj = 0; jj < G; ++jj) tr[jj] = cur[r] + jj;")
NO_B = (B_LOAD, "                const uint2 b = make_uint2(j * 3 + nt, kk0 + s);")
ALU_DECODE = (DECODE, """              {
                uint32_t e = cur[r] & 0x00ff00ffu, o = (cur[r] >> 8) & 0x00ff00ffu;
                for (int jj = 0; jj < G; ++jj) {
                  const uint32_t qe = ((e * 171u) >> 9) & 0x007f007fu;
                  const uint32_t qo = ((o * 171u) >> 9) & 0x007f007fu;
                  tr[jj] = (((o - 3u * qo) * 256u + (e - 3u * qe)) + 0x7f7f7f7fu) ^ 0x80808080u;
                  e = qe, o = qo;
                }
              }""")
TABLE32 = [
    (DECODE, """              {
                const uint32_t* t32 = reinterpret_cast<const uint32_t*>(table) + lane;
                uint32_t lo[4];
                for (int i = 0; i < 4; ++i) lo[i] = t32[((cur[r] >> (8 * i)) & 0xff) * 32];
                uint32_t t4[4];
                transpose4(lo, t4);
                for (int jj = 0; jj < 4 && jj < G; ++jj) tr[jj] = t4[jj];
                if constexpr (G == 5) {
                  const uint32_t w = cur[r], wl = w & 0x7f7f7f7fu;
                  const uint32_t s81 = wl + 0x2f2f2f2fu, s162 = wl + 0x5e5e5e5eu, s243 = wl + 0x0d0d0d0du;
                  const uint32_t m81 = (w & 0xafafafafu) | ((w | 0xafafafafu) & s81);
                  const uint32_t m162 = (w & 0x5e5e5e5eu) | ((w | 0x5e5e5e5eu) & s162);
                  const uint32_t m243 = (w & 0x0d0d0d0du) | ((w | 0x0d0d0d0du) & s243);
                  const uint32_t u = ((m81 >> 7) & 0x01010101u) + ((m162 >> 7) & 0x01010101u) +
                                     2 * ((~m243 >> 7) & 0x01010101u);
                  tr[4] = (u + 0x7d7d7d7du) ^ 0x80808080u;
                }
              }"""),
    ("    t[i] = make_uint2(lo, (uint32_t)(uint8_t)(int8_t)(r % 3 - 1));", "    t[i] = make_uint2(lo, lo);"),
]
L2_HINT = [("cp.async.cg.shared.global [", "cp.async.cg.shared.global.L2::256B ["),
           ("cp.async.ca.shared.global [", "cp.async.ca.shared.global.L2::256B [")]
VARIANTS = {
    "shipped": ([], True),
    "no_skip": ([("const bool skip = !__syncthreads_or(nz != 0);",
                  "const bool skip = !__syncthreads_or(nz != 0) && false;")], True),
    "one_copy": ([("const uint2* tk = table + (lane & (kGCopies - 1));", "const uint2* tk = table;")], True),
    "no_zero_test": ([("return v == 0.f ? (int8_t)0 : quantize(v, s);", "return quantize(v, s);")], True),
    "no_copy": ([(COPY_LINE, "        ++it_issue;\n        cp_async_commit();")], False),
    "no_decode": ([NO_DECODE], False),
    "no_mma": ([NO_MMA], False),
    "stream": ([NO_DECODE, NO_MMA, NO_B], False),
    "alu_decode": ([ALU_DECODE], True),
    "table32": (TABLE32, True),
    "l2_hint": (L2_HINT, True),
    "warps8": ([("constexpr int kGWarps = 16;", "constexpr int kGWarps = 8; ")] + TWO_SLOTS, True),
    "step64": (STEP64, True),
    "step64_ahead": (STEP64 + AHEAD, True),
}
#: (E, M, KG, g, C) of deepseek-v3's two routed g=5 segments
SHAPES = {"w1": (256, 2048, 1432, 5, 16), "w2": (256, 7168, 408, 5, 16)}
#: experts holding a real row (token 0) on a decode step's rows
DECODE_ROWS = 32


def variant_source(src: str, subs) -> str:
    """The source with each (old, new) substituted in the grouped kernel's
    part of the file (constants, helpers and kernel: after decode_kernel)."""
    head, tail = src.split("// The grouped kernel (`ternary_decode_gemm_fused_grouped`,", 1)
    for old, new in subs:
        n = tail.count(old)
        assert n >= 1, old[:80]
        tail = tail.replace(old, new)
    return head + "// The grouped kernel (`ternary_decode_gemm_fused_grouped`," + tail


def ptxas_g5(log: str) -> dict:
    """registers and spill bytes of the G 5 integer and bf16 instantiations."""
    out, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry" in line:
            name = line.split("'")[1]
            entry = ("int" if "ILi5EaiE" in name else "bf16" if "ILi5E13__nv_bfloat16S" in name
                     else None) if "decode_grouped_kernel" in name else None
        elif entry and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            out.setdefault(entry, {})["spill_bytes"] = nums[1] + nums[2]
        elif entry and "registers" in line:
            out.setdefault(entry, {})["registers"] = int(line.split("Used ")[1].split()[0])
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("decode_probe: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.core import act_token_scale
    from repro_torch.kernels import _build, _splitk
    from repro_torch.kernels import ternary_decode_gemm as tdg

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    src = (_build.CSRC / "ternary_decode_gemm.cu").read_text()
    work = ROOT / "build" / "decode_probe"
    shutil.rmtree(work, ignore_errors=True)
    procs = {}
    for name, (subs, _) in VARIANTS.items():
        d = work / name
        d.mkdir(parents=True)
        (d / "ternary_decode_gemm.cu").write_text(variant_source(src, subs))
        shutil.copy(_build.CSRC / "mpgemm_common.cuh", d)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
             str(d / "ternary_decode_gemm.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, regs = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed:\n{log[-4000:]}")
        regs[name] = ptxas_g5(log)
        lib = ctypes.CDLL(str(work / name / "lib.so"))
        for entry in ("ternary_decode_gemm_grouped", "ternary_decode_gemm_fused_grouped"):
            getattr(lib, entry).argtypes = _build._ARGTYPES[entry]
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def device_ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
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

    def chunked(fn, *args, **kw):
        """The plain version 16 experts at a time (no 256 experts' dense
        f32 weights at once)."""
        return torch.cat([fn(*(a[i:i + 16] for a in args), **kw) for i in range(0, args[0].shape[0], 16)])

    rows = {name: {"registers": regs[name]} for name in VARIANTS}
    for shape, (e, m, kg, g, c) in SHAPES.items():
        packed = torch.randint(0, 3 ** g, (e, m, kg), generator=gen, device=dev,
                               dtype=torch.int32).to(torch.uint8)
        a_full = torch.randint(-127, 128, (e, g, kg, c), generator=gen, device=dev,
                               dtype=torch.int32).to(torch.int8)
        x_full = (torch.randn((e, c, kg * g), generator=gen, device=dev) * 3).to(torch.bfloat16)
        a_dec, x_dec = torch.zeros_like(a_full), torch.zeros_like(x_full)
        a_dec[:DECODE_ROWS, ..., 0] = a_full[:DECODE_ROWS, ..., 0]
        x_dec[:DECODE_ROWS, 0] = x_full[:DECODE_ROWS, 0]
        w_scale = torch.rand((e, m), generator=gen, device=dev)
        plan = tdg.grouped_decode_plan(m, kg, c, g, e)
        for kind, a_r, x in (("random", a_full, x_full), ("decode", a_dec, x_dec)):
            a_scale = act_token_scale(x.reshape(e * c, -1).T).reshape(e, c).contiguous()
            want_i = chunked(tdg.ternary_decode_gemm_plain, packed, a_r, g=g)
            want_f = chunked(tdg.ternary_decode_gemm_fused_plain, packed, x, a_scale, w_scale, g=g,
                             out_dtype=torch.bfloat16)
            out_i = torch.empty_like(want_i)
            out_f = torch.empty_like(want_f)
            for name, lib in libs.items():
                p = plan
                if name == "warps8":                      # 8 warps: a block's rows in 256s
                    p = dataclasses.replace(plan, bm=-(-plan.bm // 256) * 256)
                ws, cnt = _splitk.launch_args(p, dev)
                stream = lambda: torch.cuda.current_stream().cuda_stream   # noqa: E731

                def run_int(lib=lib, p=p, ws=ws, cnt=cnt):
                    rc = lib.ternary_decode_gemm_grouped(
                        *_build._int_grouped_args(packed, a_r, out_i, g, ws, cnt),
                        *_build._grouped_decode_plan_args(p), stream())
                    assert rc == 0, rc

                def run_fused(lib=lib, p=p, ws=ws, cnt=cnt):
                    rc = lib.ternary_decode_gemm_fused_grouped(
                        *_build._grouped_args(packed, x, a_scale, w_scale, g, out_f, ws, cnt),
                        *_build._grouped_decode_plan_args(p), stream())
                    assert rc == 0, rc

                row = {"int_ms": device_ms(run_int)}
                exact_i = torch.equal(out_i, want_i)
                row["fused_ms"] = device_ms(run_fused)
                exact_f = torch.equal(out_f, want_f)
                if VARIANTS[name][1] and not (exact_i and exact_f):
                    raise AssertionError(f"{name} at {shape}, {kind} rows: an exact variant differs "
                                         "from the plain version")
                row["exact"] = exact_i and exact_f
                rows[name].setdefault(shape, {})[kind] = row
                print(f"{name:12s} {shape} {kind:6s} rows: integer {row['int_ms']:.4f} ms, fused "
                      f"{row['fused_ms']:.4f} ms"
                      f"{'' if VARIANTS[name][1] else ' (a probe: sums not kept)'}; "
                      f"G 5 registers / spill bytes {regs[name]}", flush=True)
            del want_i, want_f
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "decode_probe.json").write_text(json.dumps({"card": card, "shapes": SHAPES,
                                                       "decode_rows": DECODE_ROWS,
                                                       "variants": rows}, indent=1))
    shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
