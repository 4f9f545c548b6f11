#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0, no result line) on failure:

1. device: the card's name and power limit (nvidia-smi).
2. build: compile every CUDA kernel from `csrc/` (one nvcc per source, in
   parallel).
3. kernels: each fused mpGeMM kernel against its plain PyTorch version on
   the card, at the BitLinear shapes of smollm-360m (M, K) in {(960, 960),
   (320, 960), (2560, 960), (960, 2560)} plus a mixed g=5/g=4 shape
   (K = 964), N in {1, 4, 16, 64, 256} tokens, for f32->f32, bf16->bf16 and
   bf16->f32 (activation->output). Expected difference: exactly 0 (the
   integer core is exact in both, and the f32 epilogue is the same
   operations in the same order). Each fused kernel's split-K traps (both
   launch plans split K across blocks that meet in one shared int32
   workspace with arrival counters): ragged shapes (M 70 and 1000, N 17
   and 33, KG not divisible by the plan's splits, the g=4 segment of one
   K-group), the saturated sum 127*K at the main path's largest split of
   that kernel's plan, every case launched twice back to back with the
   others (bit-equal), and a CUDA graph of all of them replayed 3 times;
   expected difference exactly 0. Each shape's plans (vector-LUT: BM, S,
   chunk, blocks, shared bytes; decode: BM x BN, S, K-groups per step,
   alignment, blocks, shared bytes) and each instantiation's registers and
   spills (-Xptxas -v) are logged. Then the device time of one forward's 224
   launches at each N, beside the bound, the plain version's time and a
   bf16 `torch.matmul` against the dequantized weights (a yardstick only:
   the port never calls it).
4. serve: smollm-360m at full width in bf16 (random weights from a seeded
   generator on the card, packed by `pack_params`), an Engine with 4 slots
   and max_len 256 serving 8 greedy requests (prompts of 16-64 tokens, 16
   new tokens each), once with impl="decode" and once with impl="lookup".
   Checks: every request completes; each kernel was launched exactly 224
   times per forward (32 layers x 7 BitLinears) in its run and never in the
   other (nor any integer kernel); both runs emit the same greedy tokens;
   the prefill logits of one prompt on the card agree with the same
   weights run on the CPU (plain path) within a stated bf16 tolerance.
5. unfused: the unfused pipeline (quantize into int8, de-interleave copy,
   integer kernel into int32 (M, N), dequant), on phase 4's model.
   (a) Each integer kernel (`ternary_decode_gemm`, `vlut_lookup_gemm`)
   against its plain version at the shapes and N of phase 3, plus the
   saturated case (all +1 weights, activations 127: every sum 127*K at
   K = 2560 and 960), and both integer kernels' split-K traps as in phase 3.
   Expected difference: exactly 0. (b) `vlut_mpgemm`
   fused against unfused, both impls: bit-identical on one segment, within
   1e-6 of the output's magnitude at K = 964. (c) Serving as in phase 4
   with `Engine(mpgemm_fusion="unfused")`, once per impl: that impl's
   integer kernel launched exactly 224 times per forward and no other
   mpGeMM kernel, every request completed, the greedy tokens of phase 4.
   (d) Device time per 224-launch forward at each N: each integer kernel
   beside its bound (bytes of packed weights, int8 activations and int32
   output vs int8 operations), its plain version, and `torch._int_mm` on
   the unpacked int8 weights where its shape rules hold (N > 16), else
   phase 3's bf16 `torch.matmul` (yardsticks only: the port never calls
   them); the whole fused and unfused pipelines through `ternary_matmul`
   (the paper's §3.3 fusion ablation), and the bytes fusion avoids. (e)
   The paper's comparison at (M, K) = (2560, 960), N in {1, 4, 16, 64,
   256}: `vlut_gemm` (Algorithm 1 in plain PyTorch), `scalar_lut_gemm`,
   `mad_gemm`, `mad_gemm_int8` and both pipelines of both kernels, each
   checked against `ref_mpgemm` (exact; `mad_gemm`, which skips activation
   quantization, within the JAX suite's rtol 0.1 / atol 0.15) and timed;
   the winner per N.
6. flash: the flash-attention kernel against its plain PyTorch version on
   the card (bf16 with D <= 128 runs the tensor-core kernel, f32 the
   CUDA-core one): smollm-360m's heads (H 15, KV 5, D 64) and odd ones (D
   20, 32, 128; H/KV 1 and 3), S in {1, 17, 256, 512, 2048}, causal or
   not, window 0 or 24, softcap 0 or 20, f32 and bf16, q/k/v read as
   transposed views of the model's (B, S, H, D) tensors. The tensor-core
   kernel's traps, each against the plain version: S 2048 causal with
   window 24 (key tiles skipped at both ends of a query tile's range), the
   contiguous (B, H, S, D) layout, two launches back to back with no sync
   between (and a repeat launch bit-equal to the first), and a CUDA graph
   of the training-shape launch replayed 3 times with new inputs copied in
   before each replay. Each kernel's registers, spills and shared memory
   (-Xptxas -v) are logged. Then the gradients of
   `flash_attention_trainable` against autograd through the plain version,
   and the device time at the training shape (B 8, S 512, causal, bf16)
   beside the bound, the plain version, the f32 kernel at the same shape
   and `scaled_dot_product_attention` (a yardstick only: the port never
   calls it).
7. train: smollm-360m at full width and depth in bf16 with
   attn_impl="flash" and per-layer remat, random weights from a seeded
   generator on the card, 30 QAT steps of B 8 x S 512 on the synthetic
   bigram data (AdamW, lr 3e-4, warmup 5, int8/bf16 moments) through
   `train.Trainer`. (At lr 3e-3 the full-width model's loss rises from the
   6th step on: Adam moves every element of the tied 49152 x 960 table by
   ~lr per step, 15% of its 0.02 init scale.) Checks: every loss finite, the last below the first;
   the flash kernel launched 64 times per step (32 layers x 2: remat runs
   each layer's forward again in backward) and no mpGeMM kernel; the
   checkpoint written at the last step resumes a second Trainer there with
   the same weights; the loss of one sequence on the card agrees with the
   CPU plain path on the same weights, before and after training. Then
   one step under torch.profiler (device-busy share).

8. multi-token serving, run after phase 5 on phase 4's model and prompts
   (4 slots, max_len 256, 16 new tokens). (a) Both fused kernels against
   their plain versions at the five shapes of phase 3 with N in {20, 60}
   (4 slots x (k+1) for chain k 4, 4 x 15 nodes for tree (2, 2); ragged
   across the plans' token tiles), as in phase 3: expected difference
   exactly 0. (b) After a prefill of one prompt, `verify_step` over k+1 = 5
   tokens against 5 `decode_step` calls (logits within VERIFY_RTOL of the
   largest, idx equal), and a tree verify of (2, 2) against the sequential
   decode of each root-to-leaf path; each once more with a fault planted
   (causal mask, ancestor gate dropped) that must read above the bound.
   (c) Nine serving runs, greedy unless named, impl="decode" unless named:
   chunked prefill (chunk 64), chunked with token_budget 96, chain
   speculation k 4 with the n-gram drafter, with the self-drafting oracle
   ModelDrafter, adaptive K, tree (2, 2), chunked + chain, chain with impl="lookup", and the stochastic oracle at
   temperature 0.8. Each run's counts are zeroed just before it; it must
   launch its kernel exactly 224 times per forward (target and drafter
   forwards, counted through `lm_hidden`) and no other kernel, complete
   every request, and (greedy) emit phase 4's tokens, or leave them only
   at a near-tie (TIE_RTOL of the largest whole-prompt logit at the first
   divergent step, logged); the oracle must accept at least 0.9 of its
   drafts. Logged per run: decode tok/s and TTFT p50 on host clocks
   (ServeStats, whole run), tokens and nodes per step, acceptance, mean
   draft k, chunk steps, and the token counts N the mpGeMM launches saw.
   Then one chain and one tree step of 4 full slots under torch.profiler
   (device time by kernel, busy share), as phase 4's decode step.

Output: a `kernels` JSON line and the card's line before the last line,
which is {"ok": true, "device": {...}}. Details go to
chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import contextlib
import copy
import json
import math
import pathlib
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_S = 3.35e12     # H100 SXM device memory rate
INT8_OPS_S = 1979e12      # H100 SXM dense int8 tensor-core peak
SHAPES = [(960, 960), (320, 960), (2560, 960), (960, 2560)]
MIXED_SHAPE = (960, 964)  # 192 g=5 groups + 1 g=4 group
TOKENS = (1, 4, 16, 64, 256)
DECODE_N = 4              # one decode step of the 4-slot engine
IMPLS = ("decode", "lookup")
KERNEL_META = {
    "ternary_decode_gemm_fused": dict(
        impl="decode", fusion="fused", source="src/repro_torch/csrc/ternary_decode_gemm.cu",
        replaces="src/repro/kernels/ternary_decode_gemm.py:176"),
    "vlut_lookup_gemm_fused": dict(
        impl="lookup", fusion="fused", source="src/repro_torch/csrc/vlut_lookup_gemm.cu",
        replaces="src/repro/kernels/vlut_lookup_gemm.py:222"),
    "ternary_decode_gemm": dict(
        impl="decode", fusion="unfused", source="src/repro_torch/csrc/ternary_decode_gemm.cu",
        replaces="src/repro/kernels/ternary_decode_gemm.py:129"),
    "vlut_lookup_gemm": dict(
        impl="lookup", fusion="unfused", source="src/repro_torch/csrc/vlut_lookup_gemm.cu",
        replaces="src/repro/kernels/vlut_lookup_gemm.py:171"),
}
# (g, (M, KG)) of the saturated integer checks: all +1 weights, activations
# 127, every sum 127*K (K = 2560 and 960)
SATURATED = ((5, (2560, 512)), (4, (960, 240)))
# The vector-LUT kernels' split-K traps, (M, KG, N, g): ragged M (70,
# 1000), N = 17 and 33, KG not divisible by the plan's splits, the K = 964
# weight's one-group g=4 segment, and smollm-360m's q at a decode step.
LUT_RAGGED = ((70, 13, 17, 5), (1000, 77, 33, 5), (1000, 191, 17, 4), (70, 1, 3, 4),
              (960, 192, 4, 5))
LUT_REPLAYS = 3           # CUDA-graph replays before the outputs are compared
FLASH_REPLAYS = 3         # CUDA-graph replays of the flash launch, each compared
# With two segments the fused pipeline sums one f32 partial per segment and
# the unfused one int32 before a single dequant: f32 rounding apart.
FUSION_RTOL = 1e-6
COMPARE_SHAPE = (2560, 960)   # the paper's comparison: smollm-360m's gate/up
# mad_gemm skips activation quantization: against ref_mpgemm it gets the
# JAX suite's bound (tests/test_vlut_core.py, test_mad_float_close)
MAD_TOL = {"rtol": 0.1, "atol": 0.15}
FLASH_META = dict(source="src/repro_torch/csrc/flash_attention.cu",
                  replaces="src/repro/kernels/flash_attention.py:106")
BF16_FLOPS_S = 989e12     # H100 SXM dense bf16 tensor-core peak
FLASH_HEADS = [(15, 5, 64), (3, 3, 20), (6, 2, 32), (3, 1, 128)]   # (H, KV, D)
FLASH_SEQS = (1, 17, 256, 512, 2048)
FLASH_TRAIN_SHAPE = (8, 512, 15, 5, 64)                           # (B, S, H, KV, D)
# The kernel (online softmax over 64-key tiles, FMA dot products) and its
# plain version (full softmax, einsum) differ only in summation order:
# f32 agrees to ~1e-6 of the output's scale (bound 2e-5); a bf16 output is
# one rounding of two nearly equal f32 values, so the two are at most one
# bf16 ulp apart (2^-7 of the largest output, or of 1 when smaller).
# Gradients: the autograd.Function's backward IS the plain VJP, so only
# run-to-run order in the library's products can differ.
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2.0 ** -7}
FLASH_GRAD_TOL = {"float32": 1e-6, "bfloat16": 2.0 ** -7}
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 8, 512, 30, 3e-4
# Phase 8 (multi-token serving): the token counts N the verify and chunk
# steps give the mpGeMM kernels with 4 slots (4 x (k+1) = 20 for chain k 4,
# 4 x 15 = 60 for tree (2, 2)); ragged across the plans' 16-token tiles.
MT_TOKENS = (20, 60)
SPEC_K = 4
SPEC_TREE = (2, 2)
PREFILL_CHUNK = 64
TOKEN_BUDGET = 96
STOCHASTIC_TEMPERATURE = 0.8
# verify_step against sequential decode, both on the card: both attend the
# bf16 cache; the attention einsums and the head matmul run at other shapes
# (5 or 15 queries against 1), so float sums may go in another order. Bound
# on max |verify - sequential| relative to the largest sequential logit:
# sound runs read 1.83e-7 (chain) and 1.19e-6 (tree) on the H100, and the
# planted faults that check_verify runs (the causal mask or the tree's
# ancestor gate dropped) must read above it.
VERIFY_RTOL = 1e-4
# A greedy run may leave phase 4's tokens only at a near-tie: at the first
# divergent step the whole-prompt reference logits of the two tokens must
# lie within this fraction of the largest logit (a bf16 rounding of the
# largest logit is 2^-8 of it; a bookkeeping fault moves logits by far more).
TIE_RTOL = 1e-2
# the self-drafting oracle drafts with the target's own weights; the card's
# draft and verify forwards differ only at near-ties
ORACLE_MIN_ACCEPT = 0.9
CPU_SEQ = 256
# bf16 model, 32 layers, QAT: the CPU and the card round bf16 intermediates
# after sums in another order, and an int8 activation code at a rounding
# boundary can move by one; the mean CE over 256 tokens moves far less than
# one logit. Bound on |card - cpu| relative to the CPU's loss.
TRAIN_LOSS_RTOL = 0.02
# bf16 model, 32 layers: the card and the CPU round bf16 intermediates
# (norms, attention, residual adds) after sums taken in different orders,
# and a one-ulp change can move an int8 activation code by one; the
# difference grows through the layers. Bound on |card - cpu| relative to
# the largest reference logit.
LOGIT_RTOL = 0.05


def log(msg: str) -> None:
    print(msg, flush=True)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, reps: int = 5) -> float:
    """Device time of the launches `fn` makes, with the host's launch
    overhead excluded: `fn` is captured once in a CUDA graph and the graph
    is replayed between two timing events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                  # warm-up outside the capture
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


def eager_ms(torch, fn, reps: int = 3) -> float:
    """Time of `fn` run eagerly, between two events: the device's time plus
    whatever the host's launch overhead adds — what the serving path pays."""
    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def bitlinear_weights(torch, model, gen) -> dict:
    """{(M, K): PackedWeight}: the model's first-layer weights for the
    main-path shapes, and a random mixed-segment weight for K = 964."""
    from repro_torch.core import pack_weight, ternary_quantize
    from repro_torch.models.common import PackedLinear

    lin0 = [m for m in model.layers[0].modules() if isinstance(m, PackedLinear)]
    weights = {}
    for lin in lin0:
        weights.setdefault((lin.pw.M, lin.pw.K), lin.pw)
    assert sorted(weights) == sorted(SHAPES), sorted(weights)
    w = torch.randn(MIXED_SHAPE, generator=gen, device="cuda")
    tw = ternary_quantize(w)
    weights[MIXED_SHAPE] = pack_weight(tw.values, tw.scale)
    assert weights[MIXED_SHAPE].k4 == 4
    return weights


def plan_row(p) -> dict:
    """A launch plan (`LutPlan` or `DecodePlan`) as a JSON row."""
    row = {"shape": [p.m, p.kg, p.n, p.g], "splits": p.splits, "blocks": p.blocks,
           "smem": p.smem, "kg_divisible_by_splits": p.kg % p.splits == 0}
    for key in ("bm", "bn", "chunk", "kstep", "codes_aligned", "acts_aligned"):
        if hasattr(p, key):
            row[key] = getattr(p, key)
    return row


def kernel_registers(_build, tag: str) -> dict:
    """`-Xptxas -v` of each instantiation whose name holds `tag`: registers
    and spill bytes (stores + loads)."""
    out, entry = {}, None
    for line in _build.build_log().splitlines():
        if "Compiling entry" in line:
            entry = line.split("'")[1] if tag in line else None
            if entry:
                out[entry] = {}
        elif entry and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            out[entry]["spill_bytes"] = nums[1] + nums[2]
        elif entry and "registers" in line:
            out[entry]["registers"] = int(line.split("Used ")[1].split()[0])
    return out


def splitk_traps(torch, name, kern, plain, cases) -> dict:
    """The split-K traps of a kernel, each against its plain version with
    an expected difference of exactly 0. cases: [(args, kwargs)]. (1) Every
    case launched twice, back to back with the other cases and no sync
    between (different shapes share the workspace and counters): both
    launches equal the plain version. (2) One CUDA graph of all cases
    replayed LUT_REPLAYS times (a workspace or counter left dirty would add
    into the next replay): the outputs equal the plain version."""
    wants = [plain(*a, **kw) for a, kw in cases]
    firsts = [kern(*a, **kw) for a, kw in cases]
    seconds = [kern(*a, **kw) for a, kw in cases]
    torch.cuda.synchronize()
    for (a, kw), want, first, second in zip(cases, wants, firsts, seconds):
        if not (torch.equal(first, want) and torch.equal(second, first)):
            raise AssertionError(f"{name}: repeat launches at {tuple(a[0].shape)} x "
                                 f"{tuple(a[1].shape)} differ from the plain version or each other")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [kern(*a, **kw) for a, kw in cases]
    for _ in range(LUT_REPLAYS):
        graph.replay()
    torch.cuda.synchronize()
    for (a, kw), want, out in zip(cases, wants, outs):
        if not torch.equal(out, want):
            raise AssertionError(f"{name}: after {LUT_REPLAYS} graph replays the output at "
                                 f"{tuple(a[0].shape)} x {tuple(a[1].shape)} differs from the plain version")
    del graph
    return {"cases": len(cases), "repeat_launches": 2, "graph_replays": LUT_REPLAYS, "max_abs_err": 0}


def largest_split(plan) -> tuple:
    """(M, KG, N) of the main path's plan with the most K-splits (g=5), by
    `plan(M, KG, N, g)` (`lut_plan` or `decode_plan`)."""
    return max(((m, k // 5, n) for m, k in SHAPES for n in TOKENS),
               key=lambda s: plan(*s, 5).splits)


def decode_plan_for(tdg, m, kg, n, g):
    """The decode plan the main path launches: contiguous operands, word
    loads where KG % 4 == 0."""
    return tdg.decode_plan(m, kg, n, g, codes_aligned=kg % 4 == 0, acts_aligned=kg % 4 == 0)


def fused_kernels() -> dict:
    """{name: (kernel wrapper, plain version)} of the two fused mpGeMM
    kernels."""
    from repro_torch.kernels import ternary_decode_gemm as tdg
    from repro_torch.kernels import vlut_lookup_gemm as vlg

    return {
        "ternary_decode_gemm_fused": (tdg.ternary_decode_gemm_fused, tdg.ternary_decode_gemm_fused_plain),
        "vlut_lookup_gemm_fused": (vlg.vlut_lookup_gemm_fused, vlg.vlut_lookup_gemm_fused_plain),
    }


def fused_vs_plain(torch, kernels, weights, tokens, gen):
    """Each fused kernel against its plain version at every weight shape,
    token count N and activation/output type pair (f32/f32, bf16/bf16,
    bf16/f32). → ({name: max |diff|}, number of checks)."""
    from repro_torch.core import act_token_scale
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    combos = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
              (torch.bfloat16, torch.float32))
    max_err = {name: 0.0 for name in kernels}
    n_checks = 0
    for (m, k), pw in weights.items():
        for n in tokens:
            x32 = torch.randn((n, k), generator=gen, device=dev) * 3.0
            for in_dt, out_dt in combos:
                x = x32.to(in_dt)
                a_scale = act_token_scale(x.T).contiguous()
                for packed, lo, hi, g in ops._segments(pw):
                    for name, (kern, plain) in kernels.items():
                        got = kern(packed, x[:, lo:hi], a_scale, pw.scale, g=g, out_dtype=out_dt)
                        want = plain(packed, x[:, lo:hi], a_scale, pw.scale, g=g, out_dtype=out_dt)
                        torch.cuda.synchronize()
                        assert got.shape == want.shape == (n, m) and got.dtype == out_dt
                        err = (got.float() - want.float()).abs().max().item()
                        max_err[name] = max(max_err[name], err)
                        n_checks += 1
    return max_err, n_checks


def check_kernels(torch, model, cfg):
    """Phase 3: kernels against their plain versions, then timing."""
    from repro_torch.core import act_token_scale
    from repro_torch.core.quantize import INV_Q_MAX
    from repro_torch.kernels import ternary_decode_gemm as tdg
    from repro_torch.kernels import vlut_lookup_gemm as vlg
    from repro_torch.models.common import PackedLinear

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    kernels = fused_kernels()
    weights = bitlinear_weights(torch, model, gen)

    max_err, n_checks = fused_vs_plain(torch, kernels, weights, TOKENS, gen)
    log(f"kernels: {n_checks} kernel-vs-plain checks, max |diff| {max_err}")
    for n in TOKENS:
        log(f"kernels: LUT plans at N={n}: " + "; ".join(
            f"{m}x{k}: BM {p.bm} S {p.splits} chunk {p.chunk} blocks {p.blocks} smem {p.smem}"
            for m, k in SHAPES for p in [vlg.lut_plan(m, k // 5, n, 5)]))
    for name, err in max_err.items():
        if err != 0.0:
            raise AssertionError(f"{name} differs from its plain version by {err} (expected 0)")

    for n in TOKENS:
        log(f"kernels: decode plans at N={n}: " + "; ".join(
            f"{m}x{k}: BM {p.bm} BN {p.bn} S {p.splits} step {p.kstep} blocks {p.blocks} "
            f"smem {p.smem}" for m, k in SHAPES for p in [decode_plan_for(tdg, m, k // 5, n, 5)]))

    # each fused kernel's split-K traps: ragged shapes, repeat and
    # back-to-back launches, graph replays, the saturated sum at the
    # largest split of its plan
    traps = {}
    for name, plan in (("vlut_lookup_gemm_fused", vlg.lut_plan),
                       ("ternary_decode_gemm_fused", lambda *s: decode_plan_for(tdg, *s))):
        kern, plain = kernels[name]
        cases = []
        for m, kg, n, g in LUT_RAGGED:
            packed = torch.randint(0, 3 ** g, (m, kg), generator=gen, device=dev,
                                   dtype=torch.int32).to(torch.uint8)
            x = torch.randn((n, kg * g), generator=gen, device=dev) * 3.0
            w_scale = torch.rand((m,), generator=gen, device=dev)
            for dt in ((torch.float32, torch.bfloat16) if (m, n) == (960, 4) else (torch.float32,)):
                cases.append(((packed, x.to(dt), act_token_scale(x.to(dt).T).contiguous(), w_scale),
                              dict(g=g, out_dtype=dt)))
        m, kg, n = largest_split(plan)
        sat = ((torch.full((m, kg), 3 ** 5 - 1, dtype=torch.uint8, device=dev),
                torch.ones((n, kg * 5), device=dev), torch.full((n,), 1.0, device=dev) * INV_Q_MAX,
                torch.ones((m,), device=dev)), dict(g=5, out_dtype=torch.float32))
        if not torch.equal(kern(*sat[0], **sat[1]), plain(*sat[0], **sat[1])):
            raise AssertionError(f"{name}: saturated sums differ from the plain version")
        t = splitk_traps(torch, name, kern, plain, cases + [sat])
        t["plans"] = [plan_row(plan(*shape)) for shape in LUT_RAGGED]
        t["saturated"] = {"shape": [m, kg, n], "splits": plan(m, kg, n, 5).splits, "sum": 127 * kg * 5}
        if all(row["kg_divisible_by_splits"] for row in t["plans"]):
            raise AssertionError(f"{name}: no trap shape has KG indivisible by its splits")
        log(f"kernels: {name} traps: {t['cases']} cases (ragged, saturated sums 127*K at the "
            f"largest split {t['saturated']}), each launched twice back to back and in a CUDA "
            f"graph replayed {LUT_REPLAYS} times: max |diff| 0")
        for row in t["plans"]:
            log(f"kernels: {name} plan (M, KG, N, g) = {tuple(row['shape'])}: "
                + ", ".join(f"{k} {v}" for k, v in row.items() if k not in ("shape",)))
        traps[name] = t

    # device time of one forward's 224 launches (all 32 layers' weights,
    # so the ~63 MB of packed weights stream from memory as in serving)
    lins = [m for m in model.modules() if isinstance(m, PackedLinear)]
    assert len(lins) == 7 * cfg.n_layers and all(lin.pw.k4 == 0 for lin in lins)  # g=5 only
    dense = [lin.pw.unpack().to(torch.bfloat16).mul_(lin.scale[:, None].to(torch.bfloat16)).T.contiguous()
             for lin in lins]
    per_n = {}
    for n in TOKENS:
        xs = {k: torch.randn((n, k), generator=gen, device=dev).to(torch.bfloat16)
              for k in {lin.pw.K for lin in lins}}
        sc = {k: act_token_scale(x.T).contiguous() for k, x in xs.items()}
        nbytes = sum(lin.packed5.numel() + lin.scale.numel() * 4 + xs[lin.pw.K].numel() * 2
                     + sc[lin.pw.K].numel() * 4 + n * lin.pw.M * 2 for lin in lins)
        nops = sum(2 * n * lin.pw.M * lin.pw.K for lin in lins)
        bound = max(nbytes / HBM_BYTES_S, nops / INT8_OPS_S) * 1e3
        row = {"bytes": nbytes, "int8_ops": nops, "bound_ms": bound,
               "bound_by": "bytes" if nbytes / HBM_BYTES_S >= nops / INT8_OPS_S else "operations"}

        def run(fn, lins=lins, xs=xs, sc=sc):
            for lin in lins:
                fn(lin.packed5, xs[lin.pw.K], sc[lin.pw.K], lin.scale, g=5, out_dtype=torch.bfloat16)

        for name, (kern, plain) in kernels.items():
            row[name] = {"ms": device_ms(torch, lambda: run(kern)),
                         "eager_ms": eager_ms(torch, lambda: run(kern)),
                         "plain_ms": device_ms(torch, lambda: run(plain), reps=1)}
        row["library_ms"] = device_ms(torch, lambda: [xs[lin.pw.K] @ d for lin, d in zip(lins, dense)])
        per_n[n] = row
        log(f"kernels: forward of 224 BitLinears at N={n}: bound {bound:.4f} ms ({row['bound_by']}), "
            + ", ".join(f"{nm} {row[nm]['ms']:.4f} ms (eager {row[nm]['eager_ms']:.4f}, "
                        f"plain {row[nm]['plain_ms']:.4f})" for nm in kernels)
            + f", bf16 matmul yardstick {row['library_ms']:.4f} ms")
    del dense
    return max_err, per_n, weights, traps


def serve(torch, model, cfg, impl: str, prompts, counters, fusion: str = "fused"):
    """Phases 4 and 5, one impl and fusion: warm up, zero the counts, drive
    the main path."""
    from repro_torch.serve import ContinuousBatchingScheduler, Engine, Request

    eng = Engine(model, cfg, max_slots=4, max_len=256, mpgemm_impl=impl,
                 mpgemm_fusion=fusion, device="cuda")
    warm = ContinuousBatchingScheduler(eng)
    warm.submit([Request(rid=-1, prompt=prompts[0][:16], max_new_tokens=2)])
    warm.run_to_completion()
    eng.reset_stats()
    spent = {"prefill": 0.0, "decode": 0.0}

    def timed(fn, key):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)   # add() and decode_once() end in a host sync
            spent[key] += time.perf_counter() - t0
            return out
        return wrapper

    eng.add = timed(eng.add, "prefill")
    eng.decode_once = timed(eng.decode_once, "decode")
    sched = ContinuousBatchingScheduler(eng)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=16) for i, p in enumerate(prompts)]
    for fn in counters.values():
        fn.launches = 0
    sched.submit(reqs)
    stats = sched.run_to_completion()
    launches = {name: fn.launches for name, fn in counters.items()}
    forwards = len(reqs) + stats.decode_steps
    if stats.completed != len(reqs) or any(len(r.generated) != 16 for r in reqs):
        raise AssertionError(f"{impl}/{fusion}: {stats.completed}/{len(reqs)} requests completed")
    return {
        "tokens": [list(map(int, r.generated)) for r in reqs],
        "launches": launches, "forwards": forwards,
        "prefill_tokens": stats.prefill_tokens, "decode_tokens": stats.decode_tokens,
        "decode_steps": stats.decode_steps,
        "prefill_tok_s": stats.prefill_tokens / spent["prefill"],
        "decode_tok_s": stats.decode_tokens / spent["decode"],
        # ServeStats' rates: the same tokens over the whole run's wall time
        "run_prefill_tok_s": stats.prefill_tok_s, "run_decode_tok_s": stats.decode_tok_s,
        "ttft_p50_ms": sorted(stats.ttft_s)[len(stats.ttft_s) // 2] * 1e3,
        "wall_s": stats.wall_s,
    }


def check_unfused(torch, model, cfg, weights, prompts, counters, fused_runs, per_n) -> dict:
    """Phase 5: the unfused pipeline. (a) Each integer kernel against its
    plain version; (b) `vlut_mpgemm` fused against unfused; (c) serving
    through it; (d) the fusion ablation's device times per forward; (e) the
    paper's comparison of methods at (M, K) = COMPARE_SHAPE."""
    from repro_torch.core import (
        act_quant_tokens,
        mad_gemm,
        mad_gemm_int8,
        scalar_lut_gemm,
        vlut_gemm,
    )
    from repro_torch.kernels import ops, ref_mpgemm
    from repro_torch.kernels import ternary_decode_gemm as tdg
    from repro_torch.kernels import vlut_lookup_gemm as vlg
    from repro_torch.models.common import PackedLinear

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    kernels = {
        "ternary_decode_gemm": (tdg.ternary_decode_gemm, tdg.ternary_decode_gemm_plain),
        "vlut_lookup_gemm": (vlg.vlut_lookup_gemm, vlg.vlut_lookup_gemm_plain),
    }

    # (a) kernels against their plain versions: exact integers, diff 0
    max_err = {name: 0 for name in kernels}
    n_checks = 0

    def check(packed, a_r, g):
        nonlocal n_checks
        outs = {}
        for name, (kern, plain) in kernels.items():
            got, want = kern(packed, a_r, g=g), plain(packed, a_r, g=g)
            torch.cuda.synchronize()
            assert got.dtype == want.dtype == torch.int32 and got.shape == want.shape
            max_err[name] = max(max_err[name], (got.long() - want.long()).abs().max().item())
            outs[name] = got
            n_checks += 1
        return outs

    for (m, k), pw in weights.items():
        for n in TOKENS:
            a_q, _ = act_quant_tokens(torch.randn((k, n), generator=gen, device=dev) * 3.0)
            for packed, lo, hi, g in ops._segments(pw):
                check(packed, ops._deinterleave(a_q[lo:hi], g), g)
    for g, (m, kg) in SATURATED:                 # all +1 weights, activations 127
        outs = check(torch.full((m, kg), 3 ** g - 1, dtype=torch.uint8, device=dev),
                     torch.full((g, kg, 16), 127, dtype=torch.int8, device=dev), g)
        for name, out in outs.items():
            if not int(out.min()) == int(out.max()) == 127 * kg * g:
                raise AssertionError(f"{name}: saturated sums {int(out.min())}..{int(out.max())}, "
                                     f"expected {127 * kg * g}")
    log(f"unfused: {n_checks} kernel-vs-plain checks (incl. saturated sums 127*K), "
        f"max |diff| {max_err}")
    for name, err in max_err.items():
        if err != 0:
            raise AssertionError(f"{name} differs from its plain version by {err} (expected 0)")

    # each integer kernel's split-K traps, as phase 3's
    traps = {}
    for name, plan in (("vlut_lookup_gemm", vlg.lut_plan), ("ternary_decode_gemm", tdg.decode_plan)):
        kern, plain = kernels[name]
        cases = []
        for m, kg, n, g in LUT_RAGGED:
            cases.append(((torch.randint(0, 3 ** g, (m, kg), generator=gen, device=dev,
                                         dtype=torch.int32).to(torch.uint8),
                           torch.randint(-127, 128, (g, kg, n), generator=gen, device=dev,
                                         dtype=torch.int32).to(torch.int8)), dict(g=g)))
        m, kg, n = largest_split(plan)
        sat = ((torch.full((m, kg), 3 ** 5 - 1, dtype=torch.uint8, device=dev),
                torch.full((5, kg, n), 127, dtype=torch.int8, device=dev)), dict(g=5))
        out = kern(*sat[0], **sat[1])
        torch.cuda.synchronize()
        if not int(out.min()) == int(out.max()) == 127 * kg * 5:
            raise AssertionError(f"{name}: saturated sums {int(out.min())}..{int(out.max())} "
                                 f"at the largest split, expected {127 * kg * 5}")
        t = splitk_traps(torch, name, kern, plain, cases + [sat])
        t["saturated"] = {"shape": [m, kg, n], "splits": plan(m, kg, n, 5).splits,
                          "sum": 127 * kg * 5}
        log(f"unfused: {name} traps: {t['cases']} cases (ragged, saturated sums 127*K at the "
            f"largest split {t['saturated']}), each launched twice back to back and in a CUDA "
            f"graph replayed {LUT_REPLAYS} times: max |diff| 0")
        traps[name] = t

    # (b) vlut_mpgemm fused against unfused
    fu_err = {impl: 0.0 for impl in IMPLS}
    for (m, k), pw in weights.items():
        for n in TOKENS:
            a = torch.randn((k, n), generator=gen, device=dev) * 3.0
            for impl in IMPLS:
                fused = ops.vlut_mpgemm(pw, a, impl=impl)
                unfused = ops.vlut_mpgemm(pw, a, impl=impl, fusion="unfused")
                err = (fused - unfused).abs().max().item()
                bound = FUSION_RTOL * fused.abs().max().item() if pw.k4 and pw.k5 else 0.0
                if not err <= bound:
                    raise AssertionError(f"{impl}: fused and unfused differ by {err} > {bound} "
                                         f"at M {m} K {k} N {n}")
                fu_err[impl] = max(fu_err[impl], err)
    log(f"unfused: vlut_mpgemm fused vs unfused, bit-identical on one segment, max |diff| "
        f"{fu_err} (K = 964 bound: {FUSION_RTOL} of max |out|)")

    # (c) serving through the unfused pipeline
    runs = {}
    for name, meta in KERNEL_META.items():
        if meta["fusion"] != "unfused":
            continue
        impl = meta["impl"]
        r = serve(torch, model, cfg, impl, prompts, counters, fusion="unfused")
        want = {nm: (224 * r["forwards"] if nm == name else 0) for nm in counters}
        if r["launches"] != want:
            raise AssertionError(f"impl={impl} unfused: launches {r['launches']}, expected {want}")
        if r["tokens"] != fused_runs[impl]["tokens"]:
            raise AssertionError(f"impl={impl}: the unfused pipeline emitted other greedy tokens "
                                 "than the fused one")
        runs[impl] = r
        log(f"serve: impl={impl} fusion=unfused forwards={r['forwards']} launches={r['launches']} "
            f"prefill_tok_s={r['prefill_tok_s']:.1f} decode_tok_s={r['decode_tok_s']:.1f} "
            f"ttft_p50_ms={r['ttft_p50_ms']:.2f} wall_s={r['wall_s']:.3f} (tokens = fused run's)")

    # (d) device time of one forward's 224 BitLinears at each N
    lins = [m for m in model.modules() if isinstance(m, PackedLinear)]
    assert len(lins) == 7 * cfg.n_layers and all(lin.pw.k4 == 0 for lin in lins)  # g=5 only
    w_int8 = [lin.pw.unpack() for lin in lins]                       # (M, K) for torch._int_mm
    per_n_unfused = {}
    for n in TOKENS:
        xs = {k: torch.randn((n, k), generator=gen, device=dev).to(torch.bfloat16)
              for k in {lin.pw.K for lin in lins}}
        a_qs = {k: act_quant_tokens(x.T)[0] for k, x in xs.items()}    # (K, N) int8
        a_rs = {k: ops._deinterleave(q, 5) for k, q in a_qs.items()}
        shapes = [(lin.pw.M, lin.pw.K) for lin in lins]
        nbytes = sum(lin.packed5.numel() + k * n + 4 * m * n for lin, (m, k) in zip(lins, shapes))
        nops = sum(2 * m * n * k for m, k in shapes)
        row = {"bytes": nbytes, "int8_ops": nops,
               "bound_ms": max(nbytes / HBM_BYTES_S, nops / INT8_OPS_S) * 1e3,
               "bound_by": "bytes" if nbytes / HBM_BYTES_S >= nops / INT8_OPS_S else "operations",
               # gemm_bench.py's count: the int8 activation buffer, its
               # de-interleaved copy and the int32 output, each written once
               # and read once
               "bytes_avoided_by_fusion": sum(2 * k * n + 2 * k * n + 2 * 4 * m * n
                                              for m, k in shapes)}

        def run(fn, lins=lins, a_rs=a_rs):
            for lin in lins:
                fn(lin.packed5, a_rs[lin.pw.K], g=5)

        for name, (kern, plain) in kernels.items():
            row[name] = {"ms": device_ms(torch, lambda: run(kern)),
                         "plain_ms": device_ms(torch, lambda: run(plain), reps=1)}

        def pipeline(impl, fusion, lins=lins, xs=xs):
            for lin in lins:
                ops.ternary_matmul(lin.pw, xs[lin.pw.K], impl=impl, fusion=fusion)

        row["pipeline"] = {
            f"{fusion}_{impl}": {
                "ms": device_ms(torch, lambda: pipeline(impl, fusion)),
                "eager_ms": eager_ms(torch, lambda: pipeline(impl, fusion))}
            for impl in IMPLS for fusion in ("fused", "unfused")}
        if n > 16:   # torch._int_mm's shape rules: more than 16 rows, K and M multiples of 8
            qs = {k: q.T.contiguous() for k, q in a_qs.items()}       # (N, K)
            row["library"] = {"call": "torch._int_mm (int8 unpacked weights)", "ms": device_ms(
                torch, lambda: [torch._int_mm(qs[lin.pw.K], w.T) for lin, w in zip(lins, w_int8)])}
        else:
            row["library"] = {"call": "bf16 torch.matmul (phase 3)", "ms": per_n[n]["library_ms"]}
        per_n_unfused[n] = row
        pipe = row["pipeline"]
        log(f"unfused: forward of 224 BitLinears at N={n}: bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}), "
            + ", ".join(f"{nm} {row[nm]['ms']:.4f} ms (plain {row[nm]['plain_ms']:.4f})"
                        for nm in kernels)
            + f", {row['library']['call']} {row['library']['ms']:.4f} ms; pipelines (device/eager ms): "
            + ", ".join(f"{key} {v['ms']:.4f}/{v['eager_ms']:.4f}" for key, v in pipe.items())
            + f"; fusion avoids {row['bytes_avoided_by_fusion'] / 1e6:.2f} MB")
    del w_int8

    # (e) the paper's comparison of methods at one BitLinear shape
    pw = weights[COMPARE_SHAPE]
    methods = {
        "vlut_gemm": lambda a: vlut_gemm(pw, a),
        "scalar_lut_gemm": lambda a: scalar_lut_gemm(pw, a),
        "mad_gemm": lambda a: mad_gemm(pw, a),
        "mad_gemm_int8": lambda a: mad_gemm_int8(pw, a),
    }
    for impl in IMPLS:
        for fusion in ("fused", "unfused"):
            methods[f"{fusion}_{impl}"] = (
                lambda a, impl=impl, fusion=fusion: ops.vlut_mpgemm(pw, a, impl=impl, fusion=fusion))
    compare = {}
    for n in TOKENS:
        a = torch.randn((COMPARE_SHAPE[1], n), generator=gen, device=dev) * 3.0
        want = ref_mpgemm(pw, a)
        row = {}
        for name, fn in methods.items():
            got = fn(a)
            torch.cuda.synchronize()
            err = (got - want).abs()
            if name == "mad_gemm":   # no activation quantization: the JAX suite's bound
                ok = bool((err <= MAD_TOL["atol"] + MAD_TOL["rtol"] * want.abs()).all())
            else:
                ok = torch.equal(got, want)
            if not ok:
                raise AssertionError(f"{name} at N={n} disagrees with ref_mpgemm "
                                     f"(max |diff| {err.max().item()})")
            row[name] = {"ms": device_ms(torch, lambda: fn(a)), "max_abs_err": err.max().item()}
        winner = min(row, key=lambda nm: row[nm]["ms"])
        compare[n] = {"methods": row, "winner": winner}
        log(f"compare: (M, K) = {COMPARE_SHAPE}, N={n}: "
            + ", ".join(f"{nm} {v['ms']:.4f}" for nm, v in row.items())
            + f" ms; winner {winner}")
    return {"max_abs_err": max_err, "checks": n_checks, "splitk_traps": traps,
            "fused_vs_unfused_max_abs_diff": fu_err,
            "serve": runs, "per_tokens": per_n_unfused, "compare": compare}


def device_time_by_kernel(prof, steps: int) -> list:
    """[(device ms per step, kernel name)], largest first: the device-side
    entries of `prof` (CPU ops carry their kernels' time too)."""
    def dev_us(ev):
        return getattr(ev, "self_device_time_total", getattr(ev, "self_cuda_time_total", 0))

    return sorted(((dev_us(ev) / steps / 1e3, ev.key) for ev in prof.key_averages()
                   if str(ev.device_type).endswith("CUDA") and dev_us(ev) > 0), reverse=True)


def profile_decode(torch, model, cfg, prompts, steps: int = 4, spec=None) -> dict:
    """Where a decode step's time goes: `torch.profiler` over `steps`
    batched decode steps of 4 full slots (impl="decode"; with `spec`, each
    step is draft, verify and accept). Device time by kernel, the device's
    busy share of the wall time, and the wall time per step."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import Engine, Request

    eng = Engine(model, cfg, max_slots=4, max_len=256, mpgemm_impl="decode", spec=spec,
                 device="cuda")
    per_step = 1 + (spec.k if spec is not None else 0)     # the most a step emits
    for i, p in enumerate(prompts[:4]):
        assert eng.add(Request(rid=i, prompt=p, max_new_tokens=per_step * (steps + 2) + 2))
    eng.decode_once()
    eng.decode_once()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.decode_once()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps

    by_name = device_time_by_kernel(prof, steps)
    device_ms = sum(ms for ms, _ in by_name)
    return {"wall_ms_per_step": wall_ms, "device_ms_per_step": device_ms,
            "device_busy_share": device_ms / wall_ms if device_ms else None,
            "top_kernels_ms_per_step": [[name[:90], ms] for ms, name in by_name[:8]]}


def clone_cache(cache: list) -> list:
    return [{k: v.clone() for k, v in layer.items()} for layer in cache]


@contextlib.contextmanager
def planted(module, name: str, fn):
    """A fault planted for the duration of one call: module.name = fn."""
    orig = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, orig)


def check_verify(torch, model, cfg, prompt, continuation) -> dict:
    """Phase 8 (b): after a prefill of one prompt, `verify_step` over k+1
    tokens against k+1 `decode_step` calls (logits within VERIFY_RTOL, idx
    equal), and a tree verify of SPEC_TREE against the sequential decode of
    each root-to-leaf path. Each check also runs once with a fault planted
    (chain: the causal mask dropped, so a token sees the ones after it;
    tree: the ancestor gate dropped, so a node sees its siblings and their
    subtrees) and must then read above VERIFY_RTOL."""
    import numpy as np

    from repro_torch.models import attention, decode_step, init_cache, prefill, verify_step
    from repro_torch.spec import build_tree

    dev = torch.device("cuda")
    mask = attention._mask
    with torch.no_grad():
        logits, cache = prefill(model, torch.from_numpy(prompt[None]).to(dev),
                                init_cache(cfg, 1, 256, device=dev), cfg)
        t0 = int(logits[0].argmax())

        def sequential(toks):
            c, out = clone_cache(cache), []
            for t in toks:
                row, c = decode_step(model, torch.tensor([[t]], dtype=torch.int32, device=dev), c, cfg)
                out.append(row[0].float())
            return torch.stack(out), c

        def rel_err(got, want):
            return ((got.float() - want).abs().max() / want.abs().max()).item()

        chain = [t0] + [int(t) for t in continuation[:SPEC_K]]
        seq, seq_cache = sequential(chain)
        ver, ver_cache = verify_step(model, torch.tensor([chain], dtype=torch.int32, device=dev),
                                     clone_cache(cache), cfg)
        chain_err = rel_err(ver[0], seq)
        if not all(torch.equal(a["idx"], b["idx"]) for a, b in zip(seq_cache, ver_cache)):
            raise AssertionError("verify_step and sequential decode left different idx")
        with planted(attention, "_mask", lambda q, kv, causal, window: mask(q, kv, False, window)):
            bad, _ = verify_step(model, torch.tensor([chain], dtype=torch.int32, device=dev),
                                 clone_cache(cache), cfg)
        chain_fault = rel_err(bad[0], seq)
        tree = build_tree(SPEC_K, SPEC_TREE)
        toks = np.random.default_rng(3).integers(0, cfg.vocab, tree.n_nodes).astype(np.int32)
        toks[0] = t0
        paths = [(torch.from_numpy(path).long().to(dev),
                  sequential([int(toks[j]) for j in path])[0]) for path in tree.leaf_paths]

        def tree_verify():
            out, _ = verify_step(model, torch.from_numpy(toks[None]).to(dev), clone_cache(cache),
                                 cfg, tree=tree)
            return max(rel_err(out[0, cols], want) for cols, want in paths)

        tree_err = tree_verify()
        with planted(attention, "tree_step_gate", lambda *a: None):
            tree_fault = tree_verify()
    log(f"multi: verify_step over {len(chain)} tokens vs sequential decode: max |diff| "
        f"{chain_err:.2e} of the largest logit; tree {SPEC_TREE} ({tree.n_nodes} nodes, "
        f"{len(tree.leaf_paths)} paths) {tree_err:.2e} (bound {VERIFY_RTOL}); planted faults "
        f"read {chain_fault:.2e} (chain, causal mask dropped) and {tree_fault:.2e} (tree, "
        f"ancestor gate dropped)")
    for what, err in (("chain", chain_err), ("tree", tree_err)):
        if not err <= VERIFY_RTOL:
            raise AssertionError(f"{what} verify_step differs from sequential decode by {err} "
                                 f"> {VERIFY_RTOL} of the largest logit")
    for what, err in (("chain", chain_fault), ("tree", tree_fault)):
        if not err > VERIFY_RTOL:
            raise AssertionError(f"the {what} check does not see its planted fault: {err} <= "
                                 f"{VERIFY_RTOL} of the largest logit")
    return {"chain_rel_err": chain_err, "tree_rel_err": tree_err, "chain_tokens": len(chain),
            "tree_nodes": tree.n_nodes, "tree_paths": len(tree.leaf_paths), "rtol": VERIFY_RTOL,
            "planted_chain_no_causal_rel_err": chain_fault,
            "planted_tree_no_gate_rel_err": tree_fault}


def near_tie(torch, model, cfg, prompt, ref, got) -> dict:
    """The first step where `got` leaves the reference tokens `ref`: the
    whole-prompt reference logits there (prefill, then decode of ref's
    earlier tokens, on the card); raises unless the two tokens are within
    TIE_RTOL of the largest logit."""
    from repro_torch.models import decode_step, init_cache, prefill_into_slot

    dev = torch.device("cuda")
    t = next(i for i, (a, b) in enumerate(zip(got, ref)) if a != b)
    with torch.no_grad():
        row, cache, _ = prefill_into_slot(model, init_cache(cfg, 1, 256, device=dev), 0, prompt,
                                          cfg, max_len=256)
        for tok in ref[:t]:
            row, cache = decode_step(model, torch.tensor([[tok]], dtype=torch.int32, device=dev),
                                     cache, cfg)
    row = row[0].float()
    gap = abs((row[ref[t]] - row[got[t]]).item())
    scale = row.abs().max().item()
    tie = {"step": t, "ref_token": ref[t], "token": got[t], "gap": gap, "max_abs_logit": scale}
    if gap > TIE_RTOL * scale:
        raise AssertionError(f"greedy divergence at step {t} is no near-tie: {tie}")
    return tie


def serve_multi(torch, model, cfg, prompts, counters, name, *, impl="decode", spec=None,
                temperature=0.0, **kw) -> dict:
    """Phase 8 (c): one serving run with its counts zeroed just before it.
    Every forward (target and drafter) is counted through `lm_hidden`, with
    the token count N = B x S its mpGeMM launches (224 at full depth) see."""
    from repro_torch.models import decoder
    from repro_torch.serve import ContinuousBatchingScheduler, Engine, Request

    eng = Engine(model, cfg, max_slots=4, max_len=256, mpgemm_impl=impl, spec=spec,
                 temperature=temperature, seed=7, device="cuda", **kw)
    n_hist: dict = {}
    lm_hidden = decoder.lm_hidden

    def counted(model_, tokens, *a, **k):
        n_hist[tokens.numel()] = n_hist.get(tokens.numel(), 0) + 1
        return lm_hidden(model_, tokens, *a, **k)

    sched = ContinuousBatchingScheduler(eng)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=16) for i, p in enumerate(prompts)]
    for fn in counters.values():
        fn.launches = 0
    decoder.lm_hidden = counted
    try:
        sched.submit(reqs)
        stats = sched.run_to_completion()
    finally:
        decoder.lm_hidden = lm_hidden
    launches = {nm: fn.launches for nm, fn in counters.items()}
    forwards = sum(n_hist.values())
    target = stats.decode_steps + stats.chunk_steps + (0 if eng.prefill_chunk else len(reqs))
    kernel = "vlut_lookup_gemm_fused" if impl == "lookup" else "ternary_decode_gemm_fused"
    per_forward = 7 * cfg.n_layers          # BitLinears: q, k, v, o, gate, up, down
    want = {nm: (per_forward * forwards if nm == kernel else 0) for nm in counters}
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, expected {want}")
    drafter_forwards = forwards - target
    if drafter_forwards < 0 or (drafter_forwards and not (spec and spec.drafter == "model")):
        raise AssertionError(f"{name}: {forwards} forwards counted, {target} target forwards")
    if stats.completed != len(reqs) or any(len(r.generated) != 16 for r in reqs):
        raise AssertionError(f"{name}: {stats.completed}/{len(reqs)} requests completed")
    if not all(0 <= t < cfg.vocab for r in reqs for t in r.generated):
        raise AssertionError(f"{name}: a token outside the vocabulary")
    row = {
        "impl": impl, "spec": None if spec is None else {
            "k": spec.k, "drafter": spec.drafter, "adaptive_k": spec.adaptive_k,
            "tree": spec.tree, "stochastic": spec.stochastic},
        "temperature": temperature, **{k: v for k, v in kw.items()},
        "tokens": [list(map(int, r.generated)) for r in reqs],
        "launches": launches, "forwards": forwards, "target_forwards": target,
        "drafter_forwards": drafter_forwards,
        "mpgemm_tokens_per_launch": {str(n): c * per_forward for n, c in sorted(n_hist.items())},
        "decode_tok_s": stats.decode_tok_s, "prefill_tok_s": stats.prefill_tok_s,
        "ttft_p50_ms": sorted(stats.ttft_s)[len(stats.ttft_s) // 2] * 1e3, "wall_s": stats.wall_s,
        "decode_tokens": stats.decode_tokens, "decode_steps": stats.decode_steps,
        "chunk_steps": stats.chunk_steps, "spec_steps": stats.spec_steps,
        "tokens_per_step": stats.decode_tokens_per_step, "nodes_per_step": stats.nodes_per_step,
        "acceptance": stats.acceptance_rate, "mean_draft_k": stats.mean_draft_k,
        "skip_rate": stats.skip_rate,
    }
    log(f"multi: {name}: forwards {forwards} (drafter {drafter_forwards}), launches "
        f"{launches[kernel]} of {kernel}, N per launch {row['mpgemm_tokens_per_launch']}, "
        f"decode_tok_s {row['decode_tok_s']:.1f}, ttft_p50_ms {row['ttft_p50_ms']:.1f}, "
        f"tok/step {row['tokens_per_step']:.2f}, nodes/step {row['nodes_per_step']:.2f}, "
        f"acceptance {row['acceptance']:.3f}, mean k {row['mean_draft_k']:.2f}, "
        f"chunk steps {row['chunk_steps']}, wall {row['wall_s']:.1f} s")
    return row


def check_multi_token(torch, model, cfg, weights, prompts, counters, ref_tokens) -> dict:
    """Phase 8: multi-token serving on phase 4's model and prompts. (a) Both
    fused kernels against their plain versions at N in MT_TOKENS; (b)
    verify_step against sequential decode; (c) chunked prefill, token
    budget, chain / oracle / adaptive / tree speculation, chunked + chain,
    chain with impl="lookup", and one stochastic run, each checked for
    launches, completion and (greedy) phase 4's tokens under the near-tie
    rule."""
    from repro_torch.kernels import ternary_decode_gemm as tdg
    from repro_torch.kernels import vlut_lookup_gemm as vlg
    from repro_torch.spec import SpecConfig

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(8)
    max_err, n_checks = fused_vs_plain(torch, fused_kernels(), weights, MT_TOKENS, gen)
    log(f"multi: {n_checks} kernel-vs-plain checks at N {MT_TOKENS}, max |diff| {max_err}")
    for n in MT_TOKENS:
        log(f"multi: plans at N={n}: " + "; ".join(
            f"{m}x{k}: decode BM {d.bm} BN {d.bn} S {d.splits} blocks {d.blocks}, "
            f"LUT BM {lp.bm} S {lp.splits} blocks {lp.blocks}" for m, k in SHAPES
            for d, lp in [(decode_plan_for(tdg, m, k // 5, n, 5), vlg.lut_plan(m, k // 5, n, 5))]))
    for name, err in max_err.items():
        if err != 0.0:
            raise AssertionError(f"{name} differs from its plain version by {err} at N {MT_TOKENS}")
    verify = check_verify(torch, model, cfg, prompts[0], ref_tokens[0][1:])

    oracle = dict(drafter="model", draft_params=model, draft_cfg=cfg)
    runs = {
        "chunk": dict(prefill_chunk=PREFILL_CHUNK),
        "chunk_budget": dict(prefill_chunk=PREFILL_CHUNK, token_budget=TOKEN_BUDGET),
        "chain_ngram": dict(spec=SpecConfig(k=SPEC_K)),
        "chain_oracle": dict(spec=SpecConfig(k=SPEC_K, **oracle)),
        "adaptive_ngram": dict(spec=SpecConfig(k=SPEC_K, adaptive_k=True)),
        "tree_ngram": dict(spec=SpecConfig(k=SPEC_K, tree=SPEC_TREE)),
        "chunk_chain_ngram": dict(prefill_chunk=PREFILL_CHUNK, spec=SpecConfig(k=SPEC_K)),
        "chain_ngram_lookup": dict(impl="lookup", spec=SpecConfig(k=SPEC_K)),
        "stochastic_oracle": dict(temperature=STOCHASTIC_TEMPERATURE,
                                  spec=SpecConfig(k=SPEC_K, stochastic=True, **oracle)),
    }
    out = {}
    for name, kw in runs.items():
        row = serve_multi(torch, model, cfg, prompts, counters, name, **kw)
        if not row["temperature"]:
            ties = [near_tie(torch, model, cfg, p, ref, got)
                    for p, ref, got in zip(prompts, ref_tokens, row["tokens"]) if got != ref]
            row["near_ties"] = ties
            log(f"multi: {name}: greedy tokens {'equal phase 4' if not ties else 'leave phase 4 at '}"
                + ", ".join(f"step {t['step']} (gap {t['gap']:.2e} of {t['max_abs_logit']:.3f})"
                            for t in ties))
        out[name] = row
    if out["chain_oracle"]["acceptance"] < ORACLE_MIN_ACCEPT:
        raise AssertionError(f"the oracle drafter accepted {out['chain_oracle']['acceptance']} "
                             f"< {ORACLE_MIN_ACCEPT}")
    profiles = {}
    for name in ("chain_ngram", "tree_ngram"):
        prof = profile_decode(torch, model, cfg, prompts, spec=runs[name]["spec"])
        profiles[name] = prof
        log(f"multi: profile of a {name} step (4 slots): wall {prof['wall_ms_per_step']:.3f} ms, "
            f"device busy {prof['device_ms_per_step']:.3f} ms"
            + (f" ({100 * prof['device_busy_share']:.1f}%)" if prof["device_busy_share"] else
               " (the profiler saw no device time: not measured)"))
        for kname, ms in prof["top_kernels_ms_per_step"][:4]:
            log(f"multi:   {ms:8.4f} ms  {kname}")
    log(f"multi: phase 8 took {time.perf_counter() - t0:.1f} s")
    return {"kernels_max_abs_err": max_err, "kernel_checks": n_checks, "tokens": MT_TOKENS,
            "verify": verify, "tie_rtol": TIE_RTOL, "oracle_min_accept": ORACLE_MIN_ACCEPT,
            "step_profiles": profiles,
            "runs": {k: {kk: vv for kk, vv in v.items() if kk != "tokens"} for k, v in out.items()},
            "seconds": time.perf_counter() - t0}


def flash_inputs(torch, b, s, h, kv, d, dtype, gen, contiguous=False):
    """q (B, H, S, D), k, v (B, KV, S, D): transposed views of (B, S, ., D)
    tensors, as the model passes them (or contiguous (B, ., S, D) ones)."""
    if contiguous:
        return tuple(torch.randn((b, n, s, d), generator=gen, device="cuda").to(dtype)
                     for n in (h, kv, kv))
    return tuple(torch.randn((b, s, n, d), generator=gen, device="cuda").to(dtype).transpose(1, 2)
                 for n in (h, kv, kv))


def flash_registers(_build) -> dict:
    """`-Xptxas -v` of each flash kernel instantiation: registers, spill
    bytes (stores + loads) and static shared memory."""
    out, entry = {}, None
    for line in _build.build_log().splitlines():
        if "Compiling entry" in line:
            entry = line.split("'")[1] if "flash" in line else None
            if entry:
                out[entry] = {}
        elif entry and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            out[entry]["spill_bytes"] = nums[1] + nums[2]
        elif entry and "registers" in line:
            out[entry]["registers"] = int(line.split("Used ")[1].split()[0])
            out[entry]["smem_static"] = int(line.split(" bytes smem")[0].split()[-1]) \
                if "bytes smem" in line else 0
    return out


def flash_check(torch, fa, got, q, k, v, what, **kw) -> float:
    """|got - plain| within FLASH_TOL of the plain version; returns the error."""
    want = fa.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    dt = str(q.dtype).removeprefix("torch.")
    assert got.shape == want.shape and got.dtype == q.dtype and got.stride() == q.stride()
    err = (got.float() - want.float()).abs().max().item()
    bound = FLASH_TOL[dt] * max(1.0, want.float().abs().max().item())
    if not err <= bound:
        raise AssertionError(f"flash ({what}) differs from its plain version by {err} > {bound} "
                             f"at q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype} {kw}")
    return err


def flash_traps(torch, fa, gen) -> dict:
    """The tensor-core kernel's traps (phase 6), each against the plain
    version within FLASH_TOL."""
    errs = {}
    # S 2048, causal, window 24: a middle query tile walks key tiles that
    # start after 0 and end before the last
    q, k, v = flash_inputs(torch, 1, 2048, 15, 5, 64, torch.bfloat16, gen)
    kw = dict(causal=True, window=24, softcap=0.0)
    out = fa.flash_attention(q, k, v, **kw)
    plan = fa.plan_for(q, k, v, out, causal=True, window=24)
    kts = plan.key_tiles(plan.grid[1] // 2)
    assert plan.kernel == "mma" and plan.aligned and 0 < kts.start and kts.stop < 2048 // plan.bk
    errs["s2048_window24"] = flash_check(torch, fa, out, q, k, v, "S 2048 window 24", **kw)
    # the contiguous (B, H, S, D) layout, aligned (D 64) and not (D 20)
    for h, kv, d, s in ((15, 5, 64, 512), (3, 3, 20, 17), (3, 1, 128, 256)):
        q, k, v = flash_inputs(torch, 2, s, h, kv, d, torch.bfloat16, gen, contiguous=True)
        for causal, window in ((True, 0), (False, 24)):
            kw = dict(causal=causal, window=window, softcap=0.0)
            errs[f"contiguous_d{d}_s{s}_{causal}_{window}"] = flash_check(
                torch, fa, fa.flash_attention(q, k, v, **kw), q, k, v, "contiguous", **kw)
    # two launches back to back, no sync between; a repeat launch is bit-equal
    a = flash_inputs(torch, 8, 512, 15, 5, 64, torch.bfloat16, gen)
    c = flash_inputs(torch, 2, 17, 3, 3, 20, torch.bfloat16, gen)
    out_a = fa.flash_attention(*a, causal=True)
    out_c = fa.flash_attention(*c, causal=False, window=24, softcap=20.0)
    out_a2 = fa.flash_attention(*a, causal=True)
    errs["back_to_back_a"] = flash_check(torch, fa, out_a, *a, "back to back", causal=True)
    errs["back_to_back_c"] = flash_check(torch, fa, out_c, *c, "back to back", causal=False,
                                         window=24, softcap=20.0)
    if not torch.equal(out_a, out_a2):
        raise AssertionError("flash: a repeat launch differs from the first")
    # a CUDA graph of the training-shape launch, replayed with new inputs
    q, k, v = a
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fa.flash_attention(q, k, v, causal=True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fa.flash_attention(q, k, v, causal=True)
    for i in range(FLASH_REPLAYS):
        for t, new in zip((q, k, v), flash_inputs(torch, 8, 512, 15, 5, 64, torch.bfloat16, gen)):
            t.copy_(new)
        graph.replay()
        errs[f"graph_replay_{i}"] = flash_check(torch, fa, out, q, k, v, f"graph replay {i}",
                                                causal=True)
    del graph
    return errs


def check_flash(torch) -> dict:
    """Phase 6: the flash kernels against their plain version, the traps,
    the gradients, and the device time at the training shape."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(2)
    max_err, n_checks = 0.0, 0
    for h, kv, d in FLASH_HEADS:
        for s in FLASH_SEQS:
            b = 1 if s >= 2048 else 2
            for dtype in (torch.float32, torch.bfloat16):
                dt = str(dtype).removeprefix("torch.")
                q, k, v = flash_inputs(torch, b, s, h, kv, d, dtype, gen)
                for causal in (True, False):
                    for window in (0, 24):
                        for softcap in (0.0, 20.0):
                            kw = dict(causal=causal, window=window, softcap=softcap)
                            got = fa.flash_attention(q, k, v, **kw)
                            want = fa.flash_attention_plain(q, k, v, **kw)
                            torch.cuda.synchronize()
                            assert got.shape == want.shape and got.dtype == dtype
                            err = (got.float() - want.float()).abs().max().item()
                            bound = FLASH_TOL[dt] * max(1.0, want.float().abs().max().item())
                            if not err <= bound:
                                raise AssertionError(
                                    f"flash differs from its plain version by {err} > {bound} at "
                                    f"B{b} S{s} H{h} KV{kv} D{d} {dtype} {kw}")
                            max_err = max(max_err, err)
                            n_checks += 1
    log(f"flash: {n_checks} kernel-vs-plain checks, max |diff| {max_err:.3g}")
    traps = flash_traps(torch, fa, gen)
    max_err = max(max_err, *traps.values())
    log(f"flash: {len(traps)} trap checks (S 2048 window 24, contiguous layout, back-to-back "
        f"launches, {FLASH_REPLAYS} graph replays with new inputs): max |diff| "
        f"{max(traps.values()):.3g}")

    # gradients of the autograd.Function against autograd through the plain version
    grad_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).removeprefix("torch.")
        q, k, v = (t.detach().requires_grad_() for t in
                   flash_inputs(torch, 2, 256, 15, 5, 64, dtype, gen))
        dout = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
        for window, softcap in ((0, 0.0), (24, 20.0)):
            out = fa.flash_attention_trainable(q, k, v, True, window, softcap)
            g_kern = torch.autograd.grad(out, (q, k, v), dout)
            want = fa.flash_attention_plain(q, k, v, causal=True, window=window, softcap=softcap)
            g_plain = torch.autograd.grad(want, (q, k, v), dout)
            for a, c in zip(g_kern, g_plain):
                err = (a.float() - c.float()).abs().max().item()
                bound = FLASH_GRAD_TOL[dt] * max(1.0, c.float().abs().max().item())
                if not err <= bound:
                    raise AssertionError(f"flash gradient differs by {err} > {bound} ({dtype})")
                grad_err = max(grad_err, err)
    log(f"flash: gradients through flash_attention_trainable vs the plain VJP: max |diff| {grad_err:.3g}")

    # device time at the training shape
    b, s, h, kv, d = FLASH_TRAIN_SHAPE
    q, k, v = flash_inputs(torch, b, s, h, kv, d, torch.bfloat16, gen)
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    flops = 4 * b * h * d * (s * (s + 1) // 2)          # QK^T and PV over the causal pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / BF16_FLOPS_S
    row = {"shape": dict(B=b, S=s, H=h, KV=kv, D=d, causal=True, dtype="bfloat16"),
           "bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    qf, kf, vf = (t.float() for t in (q, k, v))
    row["plan"] = repr(fa.plan_for(q, k, v, torch.empty_like(q), causal=True, window=0))
    row["ms"] = device_ms(torch, lambda: fa.flash_attention(q, k, v, causal=True), reps=20)
    row["plain_ms"] = device_ms(torch, lambda: fa.flash_attention_plain(q, k, v, causal=True))
    row["library_ms"] = device_ms(torch, lambda: F.scaled_dot_product_attention(
        qc, kc, vc, is_causal=True, enable_gqa=True), reps=20)
    row["f32_kernel_ms"] = device_ms(torch, lambda: fa.flash_attention(qf, kf, vf, causal=True),
                                     reps=20)
    row["ms_repeat"] = device_ms(torch, lambda: fa.flash_attention(q, k, v, causal=True), reps=20)
    log(f"flash: B{b} S{s} H{h}/KV{kv} D{d} causal bf16: kernel {row['ms']:.4f} ms "
        f"(repeat {row['ms_repeat']:.4f}), bound {row['bound_ms']:.4f} ms ({row['bound_by']}: "
        f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), plain {row['plain_ms']:.4f} ms, "
        f"sdpa yardstick {row['library_ms']:.4f} ms, f32 (CUDA-core) kernel "
        f"{row['f32_kernel_ms']:.4f} ms; plan {row['plan']}")
    return {"checks": n_checks, "max_abs_err": max_err, "traps": traps,
            "grad_max_abs_err": grad_err, "time": row}


def cpu_loss_check(torch, model, cfg, batch) -> dict:
    """The loss of one sequence (row 0, first CPU_SEQ tokens) on the card
    against the same weights on the CPU (plain path), no gradients."""
    from repro_torch.models import lm_loss

    tok, lab = batch["tokens"][:1, :CPU_SEQ], batch["labels"][:1, :CPU_SEQ]
    with torch.no_grad():
        gpu = lm_loss(model, tok.cuda(), lab.cuda(), cfg)[0].item()
        t0 = time.perf_counter()
        cpu_model = copy.deepcopy(model).to("cpu")
        cpu = lm_loss(cpu_model, tok.cpu(), lab.cpu(), cfg)[0].item()
        cpu_s = time.perf_counter() - t0
    del cpu_model
    if not (math.isfinite(gpu) and abs(gpu - cpu) <= TRAIN_LOSS_RTOL * abs(cpu)):
        raise AssertionError(f"card loss {gpu} and cpu loss {cpu} differ by more than "
                             f"{TRAIN_LOSS_RTOL} relative")
    return {"card": gpu, "cpu": cpu, "cpu_seconds": cpu_s}


def train(torch, counters) -> dict:
    """Phase 7: QAT training of full-width smollm-360m through the flash
    kernel, checkpoint and resume, card vs CPU loss, one profiled step."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, Trainer

    cfg = get_config("smollm-360m").with_(attn_impl="flash")
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    b, s = TRAIN_BATCH, TRAIN_SEQ
    tc = TrainConfig(total_steps=TRAIN_STEPS, checkpoint_every=TRAIN_STEPS // 2, log_every=1,
                     checkpoint_dir=str(ckpt_dir), keep_checkpoints=1, seed=0)
    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=5, total_steps=TRAIN_STEPS)
    dc = DataConfig(vocab=cfg.vocab, seq_len=s, global_batch=b)
    tr = Trainer(cfg, opt, tc, dc, device="cuda")
    n_params = sum(p.numel() for p in tr.model.parameters())
    log(f"train: {cfg.name} {cfg.dtype} attn_impl={cfg.attn_impl} remat={cfg.remat}, "
        f"{cfg.n_layers} layers, {n_params / 1e6:.1f}M parameters, B {b} x S {s}, "
        f"lr {TRAIN_LR}, {TRAIN_STEPS} steps")
    batch0 = {k: torch.from_numpy(x) for k, x in SyntheticLM(dc).batch_at(0).items()}
    before = cpu_loss_check(torch, tr.model, cfg, batch0)
    log(f"train: card vs cpu loss before training (step-1 weights and batch, 1 x {CPU_SEQ} "
        f"tokens): {before['card']:.5f} vs {before['cpu']:.5f} (cpu {before['cpu_seconds']:.1f} s)")

    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    log_rows = tr.run()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    losses = [r["loss"] for r in log_rows]
    step_s = [r["step_time_s"] for r in log_rows]
    want = {name: (2 * cfg.n_layers * TRAIN_STEPS if name == "flash_attention" else 0)
            for name in counters}
    if launches != want:
        raise AssertionError(f"train: launches {launches}, expected {want}")
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train: losses not all finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: last loss {losses[-1]} is not below the first {losses[0]}")
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    res = {"losses": losses, "step_time_s": step_s, "step_ms_median": steady * 1e3,
           "tokens_per_s": b * s / steady, "wall_s": wall, "launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "n_params": n_params,
           "loss_before": before}
    log(f"train: {TRAIN_STEPS} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}; step "
        f"{res['step_ms_median']:.1f} ms (median of steps 2-{TRAIN_STEPS}; step 1 "
        f"{step_s[0] * 1e3:.1f} ms), {res['tokens_per_s']:.0f} tok/s, launches {launches}, "
        f"peak {res['peak_mem_gb']:.1f} GB, wall {wall:.1f} s (checkpoints included)")

    # checkpoint and resume
    tr2 = Trainer(cfg, opt, tc, dc, device="cuda")
    same = all(torch.equal(p, q) for p, q in zip(tr.model.parameters(), tr2.model.parameters()))
    if tr2.step != TRAIN_STEPS or tr2.data.step != TRAIN_STEPS or not same:
        raise AssertionError(f"train: resumed at step {tr2.step} (data {tr2.data.step}), "
                             f"weights equal: {same}")
    res["resumed_step"] = tr2.step
    log(f"train: a second Trainer resumed at step {tr2.step} with equal weights "
        f"({len(list(ckpt_dir.iterdir()))} checkpoint kept)")
    del tr2

    after = cpu_loss_check(torch, tr.model, cfg, batch0)
    res["loss_after"] = after
    log(f"train: card vs cpu loss after training: {after['card']:.5f} vs {after['cpu']:.5f}")

    # one step under the profiler
    batch = {k: torch.from_numpy(x).cuda() for k, x in SyntheticLM(dc).batch_at(TRAIN_STEPS).items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr._step(tr.state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = device_time_by_kernel(prof, 1)
    dev_ms = sum(ms for ms, _ in by_name)
    n_kernels = sum(ev.count for ev in prof.key_averages() if str(ev.device_type).endswith("CUDA"))
    res["profile"] = {"wall_ms": wall_ms, "device_ms": dev_ms, "device_kernels": n_kernels,
                      "device_busy_share": dev_ms / wall_ms if dev_ms else None,
                      "top_kernels_ms": [[name[:90], ms] for ms, name in by_name[:10]]}
    log(f"profile: train step wall {wall_ms:.1f} ms, {n_kernels} device kernels, "
        f"device busy {dev_ms:.1f} ms"
        + (f" ({100 * dev_ms / wall_ms:.1f}%)" if dev_ms else
           " (the profiler saw no device time: not measured)"))
    for name, ms in res["profile"]["top_kernels_ms"]:
        log(f"profile:   {ms:8.3f} ms  {name}")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        import numpy as np

        from repro_torch.configs import get_config
        from repro_torch.kernels import _build
        from repro_torch.kernels import ternary_decode_gemm as tdg
        from repro_torch.kernels.flash_attention import flash_attention
        from repro_torch.kernels.ternary_decode_gemm import (
            ternary_decode_gemm,
            ternary_decode_gemm_fused,
        )
        from repro_torch.kernels.vlut_lookup_gemm import vlut_lookup_gemm, vlut_lookup_gemm_fused
        from repro_torch.models import init_cache, init_lm, pack_params, prefill
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. device
    card = device_line()
    log(f"card: {card}")
    kind = torch.cuda.get_device_name(0)

    # 2. build
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    log(f"build: {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log().splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"build: {line.strip()}")
    for template, tag in (("vector-LUT", "vlut_kernel"), ("decode", "decode_kernel")):
        for entry, r in kernel_registers(_build, tag).items():
            log(f"build: {template} instantiation {entry}: {r.get('registers')} registers, "
                f"{r.get('spill_bytes')} spill bytes")
    for entry, r in flash_registers(_build).items():
        log(f"build: flash instantiation {entry}: {r.get('registers')} registers, "
            f"{r.get('spill_bytes')} spill bytes, {r.get('smem_static')} static shared bytes")

    # model for phases 3 to 5
    cfg = get_config("smollm-360m")
    t0 = time.perf_counter()
    model = pack_params(init_lm(cfg, torch.Generator(device="cuda").manual_seed(0)), cfg)
    torch.cuda.synchronize()
    log(f"model: {cfg.name} {cfg.dtype}, {cfg.n_layers} layers, packed in {time.perf_counter() - t0:.1f} s")

    # 3. kernels
    max_err, per_n, weights, fused_traps = check_kernels(torch, model, cfg)

    # 4. serve
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(16, 65))).astype(np.int32)
               for _ in range(8)]
    counters = {"ternary_decode_gemm_fused": ternary_decode_gemm_fused,
                "vlut_lookup_gemm_fused": vlut_lookup_gemm_fused,
                "ternary_decode_gemm": ternary_decode_gemm,
                "vlut_lookup_gemm": vlut_lookup_gemm,
                "flash_attention": flash_attention}
    runs = {}
    for name, meta in KERNEL_META.items():
        if meta["fusion"] != "fused":
            continue
        r = serve(torch, model, cfg, meta["impl"], prompts, counters)
        want = {nm: (224 * r["forwards"] if nm == name else 0) for nm in counters}
        if r["launches"] != want:
            raise AssertionError(f"impl={meta['impl']}: launches {r['launches']}, expected {want}")
        runs[meta["impl"]] = r
        log(f"serve: impl={meta['impl']} forwards={r['forwards']} launches={r['launches']} "
            f"prefill_tok_s={r['prefill_tok_s']:.1f} decode_tok_s={r['decode_tok_s']:.1f} "
            f"ttft_p50_ms={r['ttft_p50_ms']:.2f} wall_s={r['wall_s']:.3f}")
    if runs["decode"]["tokens"] != runs["lookup"]["tokens"]:
        raise AssertionError("impl=decode and impl=lookup emitted different greedy tokens")

    # the card against the CPU (plain path) on one prompt
    prompt = torch.from_numpy(prompts[0][None, :])
    logits_gpu, _ = prefill(model, prompt.cuda(), init_cache(cfg, 1, 256, device="cuda"), cfg)
    cpu_model = copy.deepcopy(model).to("cpu")
    logits_cpu, _ = prefill(cpu_model, prompt, init_cache(cfg, 1, 256, device="cpu"), cfg)
    logits_gpu = logits_gpu.float().cpu()
    if logits_gpu.shape != (1, cfg.vocab) or not torch.isfinite(logits_gpu).all():
        raise AssertionError(f"bad logits: shape {tuple(logits_gpu.shape)}")
    diff = (logits_gpu - logits_cpu).abs().max().item()
    scale = logits_cpu.abs().max().item()
    log(f"serve: card vs cpu prefill logits: max |diff| {diff:.5f}, max |logit| {scale:.4f}, "
        f"argmax {int(logits_gpu.argmax())} vs {int(logits_cpu.argmax())}")
    if diff > LOGIT_RTOL * scale:
        raise AssertionError(f"card and cpu logits differ by {diff} > {LOGIT_RTOL} * {scale}")

    prof = profile_decode(torch, model, cfg, prompts)
    log(f"profile: decode step (4 slots) wall {prof['wall_ms_per_step']:.3f} ms, device busy "
        f"{prof['device_ms_per_step']:.3f} ms"
        + (f" ({100 * prof['device_busy_share']:.1f}%)" if prof["device_busy_share"] else
           " (the profiler saw no device time: not measured)"))
    for name, ms in prof["top_kernels_ms_per_step"]:
        log(f"profile:   {ms:8.4f} ms  {name}")

    r = runs["decode"]
    log(f"serve: prefill_tok_s={r['prefill_tok_s']:.1f} decode_tok_s={r['decode_tok_s']:.1f} "
        f"ttft_p50_ms={r['ttft_p50_ms']:.2f} wall_s={r['wall_s']:.3f}")

    # 5. unfused
    unfused = check_unfused(torch, model, cfg, weights, prompts, counters, runs, per_n)

    # 8. multi-token serving (on phase 4's model, before it is freed)
    multi = check_multi_token(torch, model, cfg, weights, prompts, counters,
                              runs["decode"]["tokens"])

    del model, cpu_model, weights
    torch.cuda.empty_cache()

    # 6. flash
    flash = check_flash(torch)

    # 7. train
    trained = train(torch, counters)

    def kernel_row(name, meta):
        if meta["fusion"] == "fused":
            row, launches, err = per_n[DECODE_N], runs[meta["impl"]]["launches"], max_err
            library_ms = row["library_ms"]
        else:
            row = unfused["per_tokens"][DECODE_N]
            launches, err = unfused["serve"][meta["impl"]]["launches"], unfused["max_abs_err"]
            library_ms = row["library"]["ms"]
        return {"name": name, "route": "cuda", "source": meta["source"],
                "replaces": meta["replaces"], "launches": launches[name],
                "max_abs_err": float(err[name]), "ms": row[name]["ms"],
                "plain_ms": row[name]["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": library_ms}

    frow = flash["time"]
    kern_line = {"kernels": [
        kernel_row(name, meta) for name, meta in KERNEL_META.items()
    ] + [
        {"name": "flash_attention", "route": "cuda", **FLASH_META,
         "launches": trained["launches"]["flash_attention"], "max_abs_err": flash["max_abs_err"],
         "ms": frow["ms"], "plain_ms": frow["plain_ms"], "bound_ms": frow["bound_ms"],
         "bound_by": frow["bound_by"], "library_ms": frow["library_ms"]},
    ]}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "card": card, "kind": kind, "timing_unit": "mpGeMM: one forward, 224 BitLinear launches (unfused pipelines: 224 BitLinears); compare: one call at (M, K) = (2560, 960); flash: one launch at the training shape; ms/plain_ms/library_ms device time (CUDA graph replay), eager_ms between events around eager launches",
        "per_tokens": per_n, "splitk_fused_traps": fused_traps,
        "decode_plans": {n: [plan_row(decode_plan_for(tdg, m, k // 5, n, 5)) for m, k in SHAPES]
                         for n in TOKENS},
        "lut_registers": kernel_registers(_build, "vlut_kernel"),
        "decode_registers": kernel_registers(_build, "decode_kernel"),
        "flash_registers": flash_registers(_build),
        "serve": {k: {kk: vv for kk, vv in v.items() if kk != "tokens"}
                                       for k, v in runs.items()},
        "unfused": {**unfused, "serve": {k: {kk: vv for kk, vv in v.items() if kk != "tokens"}
                                         for k, v in unfused["serve"].items()}},
        "logits_card_vs_cpu": {"max_abs_diff": diff, "max_abs_logit": scale},
        "decode_profile": prof,
        "multi_token": multi,
        "flash": flash, "train": trained,
        "seconds": time.perf_counter() - t_start,
    }, indent=1))
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kern_line))
    print(f"device: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
