"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (all sources in
parallel, one process each) and linked into one shared library with a plain
C interface, loaded with ``ctypes``. The library lives under
``build/repro_torch_kernels/<hash>/`` at the repository root, keyed by a
hash of the sources and flags, and is built at first use. A missing
``nvcc`` or a failed build raises: nothing falls back to the plain
versions.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
LIB_NAME = "librepro_torch_kernels.so"
#: no --use_fast_math: the quantizer's division must stay IEEE-exact
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_DECODE_PLAN_ARGTYPES = (           # the decode plan (ternary_decode_gemm.cu)
    [ctypes.c_int] * 6               # bm, bn, splits, kstep, codes_aligned, acts_aligned
    + [ctypes.c_longlong]            # dynamic shared bytes
    + [ctypes.c_void_p]              # stream
)
_DECODE_ARGTYPES = (                 # ternary_decode_gemm_fused (ternary_decode_gemm.cu)
    [ctypes.c_void_p] * 7            # packed, a, a_scale, w_scale, out, ws, counters
    + [ctypes.c_int] * 4             # M, KG, N, g
    + [ctypes.c_longlong] * 2        # lda, ldo
    + [ctypes.c_int] * 3             # ws_stride, a_bf16, out_bf16
    + _DECODE_PLAN_ARGTYPES
)
_DECODE_GROUPED_PLAN_ARGTYPES = (    # the grouped decode plan (ternary_decode_gemm.cu)
    [ctypes.c_int] * 3               # bm, splits, ex
    + [ctypes.c_longlong]            # dynamic shared bytes
    + [ctypes.c_void_p]              # stream
)
_DECODE_GROUPED_ARGTYPES = (         # ternary_decode_gemm_fused_grouped (ternary_decode_gemm.cu)
    [ctypes.c_void_p] * 7            # packed, a, a_scale, w_scale, out, ws, counters
    + [ctypes.c_int] * 4             # M, KG, N, g
    + [ctypes.c_longlong] * 2        # lda, ldo
    + [ctypes.c_int] * 4             # ws_stride, a_bf16, out_bf16, E
    + [ctypes.c_longlong] * 5        # expert strides of packed, a, a_scale, w_scale, out
    + _DECODE_GROUPED_PLAN_ARGTYPES
)
_DECODE_INT_ARGTYPES = (             # ternary_decode_gemm (ternary_decode_gemm.cu)
    [ctypes.c_void_p] * 5            # packed, a_r, out, ws, counters
    + [ctypes.c_int] * 4             # M, KG, N, g
    + _DECODE_PLAN_ARGTYPES
)
_DECODE_INT_GROUPED_ARGTYPES = (     # ternary_decode_gemm_grouped (ternary_decode_gemm.cu)
    [ctypes.c_void_p] * 5            # packed, a_r, out, ws, counters
    + [ctypes.c_int] * 5             # M, KG, N, g, E
    + [ctypes.c_longlong] * 3        # expert strides of packed, a_r, out
    + _DECODE_GROUPED_PLAN_ARGTYPES
)
_PLAN_ARGTYPES = (                   # the launch plan (vlut_lookup_gemm.cu)
    [ctypes.c_int] * 3               # bm, splits, chunk
    + [ctypes.c_longlong]            # dynamic shared bytes
    + [ctypes.c_void_p]              # stream
)
_LUT_ARGTYPES = (                    # VLUT_LUT_ENTRY_ARGS (vlut_lookup_gemm.cu)
    [ctypes.c_void_p] * 7            # packed, a, a_scale, w_scale, out, ws, counters
    + [ctypes.c_int] * 4             # M, KG, N, g
    + [ctypes.c_longlong] * 2        # lda, ldo
    + [ctypes.c_int] * 3             # ws_stride, a_bf16, out_bf16
    + _PLAN_ARGTYPES
)
_GROUPED_PLAN_ARGTYPES = (           # the grouped launch plan (vlut_lookup_gemm.cu)
    [ctypes.c_int] * 4               # bm, splits, chunk, experts per block
    + [ctypes.c_longlong]            # dynamic shared bytes
    + [ctypes.c_void_p]              # stream
)
_LUT_GROUPED_ARGTYPES = (            # VLUT_LUT_GROUPED_ENTRY_ARGS (vlut_lookup_gemm.cu)
    [ctypes.c_void_p] * 7            # packed, a, a_scale, w_scale, out, ws, counters
    + [ctypes.c_int] * 4             # M, KG, N, g
    + [ctypes.c_longlong] * 2        # lda, ldo
    + [ctypes.c_int] * 4             # ws_stride, a_bf16, out_bf16, E
    + [ctypes.c_longlong] * 5        # expert strides of packed, a, a_scale, w_scale, out
    + _GROUPED_PLAN_ARGTYPES
)
_LUT_INT_ARGTYPES = (                # VLUT_LUT_INT_ENTRY_ARGS (vlut_lookup_gemm.cu)
    [ctypes.c_void_p] * 5            # packed, a_r, out, ws, counters
    + [ctypes.c_int] * 4             # M, KG, N, g
    + _PLAN_ARGTYPES
)
_LUT_INT_GROUPED_ARGTYPES = (        # VLUT_LUT_INT_GROUPED_ENTRY_ARGS (vlut_lookup_gemm.cu)
    [ctypes.c_void_p] * 5            # packed, a_r, out, ws, counters
    + [ctypes.c_int] * 5             # M, KG, N, g, E
    + [ctypes.c_longlong] * 3        # expert strides of packed, a_r, out
    + _GROUPED_PLAN_ARGTYPES
)
_FLASH_ARGTYPES = (                  # flash_attention_fwd (flash_attention.cu)
    [ctypes.c_void_p] * 4            # q, k, v, o
    + [ctypes.c_int] * 6             # B, H, KV, Sq, Sk, D
    + [ctypes.c_longlong] * 12       # (batch, head, position) strides of q, k, v, o
    + [ctypes.c_int] * 2             # causal, window
    + [ctypes.c_float] * 2           # scale, softcap
    + [ctypes.c_int]                 # bf16
    + [ctypes.c_int] * 5             # the plan: bq, bk, dp, stages, aligned
    + [ctypes.c_longlong]            # the plan's dynamic shared bytes
    + [ctypes.c_void_p]              # stream
)
#: the library's C entries; each returns a cudaError_t (the two occupancy
#: queries: blocks per SM, or -1)
ENTRIES = ("ternary_decode_gemm_fused", "vlut_lookup_gemm_fused",
           "ternary_decode_gemm_fused_grouped", "vlut_lookup_gemm_fused_grouped",
           "ternary_decode_gemm", "vlut_lookup_gemm", "ternary_decode_gemm_grouped",
           "vlut_lookup_gemm_grouped", "vlut_grouped_blocks_per_sm",
           "decode_grouped_blocks_per_sm", "flash_attention_fwd")
#: the ctypes signature of every entry
_ARGTYPES = {
    "ternary_decode_gemm_fused": _DECODE_ARGTYPES,
    "vlut_lookup_gemm_fused": _LUT_ARGTYPES,
    "ternary_decode_gemm_fused_grouped": _DECODE_GROUPED_ARGTYPES,
    "vlut_lookup_gemm_fused_grouped": _LUT_GROUPED_ARGTYPES,
    "ternary_decode_gemm": _DECODE_INT_ARGTYPES,
    "vlut_lookup_gemm": _LUT_INT_ARGTYPES,
    "ternary_decode_gemm_grouped": _DECODE_INT_GROUPED_ARGTYPES,
    "vlut_lookup_gemm_grouped": _LUT_INT_GROUPED_ARGTYPES,
    # g, integer kernel, a_bf16, out_bf16, dynamic shared bytes
    "vlut_grouped_blocks_per_sm": [ctypes.c_int] * 4 + [ctypes.c_longlong],
    "decode_grouped_blocks_per_sm": [ctypes.c_int] * 4 + [ctypes.c_longlong],
    "flash_attention_fwd": _FLASH_ARGTYPES,
}


#: wrapper name → wrapper, for every kernel wrapper that counts its
#: launches; each registers itself where it is defined (`counts_launches`)
LAUNCH_COUNTERS: dict = {}


def counts_launches(fn, kernels: tuple, int_acts: bool = False):
    """Register kernel wrapper `fn` in `LAUNCH_COUNTERS`: ``fn.launches``
    (from 0) counts its launches; ``fn.cuda_kernels`` names the CUDA
    functions each launch runs one of, and ``fn.int_acts`` says whether it
    is their int8-activation instantiation (``signed char`` among the
    template arguments), so a device trace's kernel records can be told
    apart by wrapper. → fn."""
    fn.launches = 0
    fn.cuda_kernels, fn.int_acts = tuple(kernels), bool(int_acts)
    LAUNCH_COUNTERS[fn.__name__] = fn
    return fn


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the repro_torch "
            "CUDA kernels cannot be built"
        )
    return path


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile the kernels unless this source hash is already built; return
    the library's path. ``build.log`` beside it holds nvcc's output
    (``-Xptxas -v``: registers and shared memory of every kernel)."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = _nvcc()
    build.compiles += 1
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(dir=BUILD_ROOT, prefix=".tmp-"))
    try:
        cus = sorted(CSRC.glob("*.cu"))
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(tmp / f"{src.stem}.o")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src in cus
        ]
        logs, failed = [], []
        for src, p in zip(cus, procs):
            out, _ = p.communicate()
            logs.append(f"== {src.name} (rc={p.returncode})\n{out}")
            if p.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp / LIB_NAME),
             *(str(tmp / f"{src.stem}.o") for src in cus)],
            capture_output=True, text=True,
        )
        if link.returncode:
            raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}{link.stderr}")
        (tmp / "build.log").write_text("\n".join(logs))
        try:
            tmp.rename(out_dir)
        except OSError:  # another process finished the same build first
            if not lib.exists():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


build.compiles = 0              # nvcc runs of this process (the steady-state guard's)


def build_log() -> str:
    return (build().parent / "build.log").read_text()


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with argtypes set."""
    lib = ctypes.CDLL(str(build()))
    for name in ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return lib


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _decode_plan_args(plan) -> tuple:
    return (plan.bm, plan.bn, plan.splits, plan.kstep, int(plan.codes_aligned),
            int(plan.acts_aligned), plan.smem)


def launch_decode(packed: torch.Tensor, x: torch.Tensor, a_scale: torch.Tensor,
                  w_scale: torch.Tensor, g: int, out: torch.Tensor, plan, ws, counters) -> None:
    """Call `ternary_decode_gemm_fused` with its launch plan (a
    `DecodePlan`) and, for plan.splits > 1, the zeroed int32 workspace and
    counters, on PyTorch's current stream; raise on any CUDA error the
    launch reports (a plan the kernel refuses included). Arguments are
    validated by the caller."""
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = load().ternary_decode_gemm_fused(
        packed.data_ptr(), x.data_ptr(), a_scale.data_ptr(), w_scale.data_ptr(),
        out.data_ptr(), _ptr(ws), _ptr(counters), packed.shape[0], packed.shape[1],
        x.shape[0], g, x.stride(0), out.stride(0), 1 if w_scale.shape[0] > 1 else 0,
        int(x.dtype == torch.bfloat16), int(out.dtype == torch.bfloat16),
        *_decode_plan_args(plan), stream,
    )
    if rc != 0:
        raise RuntimeError(f"ternary_decode_gemm_fused: CUDA error {rc} at launch ({plan})")


def _grouped_args(packed: torch.Tensor, x: torch.Tensor, a_scale: torch.Tensor,
                  w_scale: torch.Tensor, g: int, out: torch.Tensor, ws, counters) -> tuple:
    """The grouped entries' arguments up to the plan, from packed (E, M, KG),
    x (E, C, K) with unit stride along K, a_scale (E, C), w_scale (E, M) or
    (E, 1) and out (E, C, M), each expert stride in elements."""
    e, m, kg = packed.shape
    return (
        packed.data_ptr(), x.data_ptr(), a_scale.data_ptr(), w_scale.data_ptr(),
        out.data_ptr(), _ptr(ws), _ptr(counters), m, kg, x.shape[1], g, x.stride(1),
        out.stride(1), 1 if w_scale.shape[1] > 1 else 0, int(x.dtype == torch.bfloat16),
        int(out.dtype == torch.bfloat16), e, packed.stride(0), x.stride(0),
        a_scale.stride(0), w_scale.stride(0), out.stride(0),
    )


def _grouped_decode_plan_args(plan) -> tuple:
    return plan.bm, plan.splits, plan.ex, plan.smem


def launch_decode_grouped(packed: torch.Tensor, x: torch.Tensor, a_scale: torch.Tensor,
                          w_scale: torch.Tensor, g: int, out: torch.Tensor, plan, ws,
                          counters) -> None:
    """Call `ternary_decode_gemm_fused_grouped` (E experts in one launch:
    packed (E, M, KG) u8, x (E, C, K) → out (E, C, M)) as `launch_decode`
    calls the single entry, with its `GroupedDecodePlan`."""
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = load().ternary_decode_gemm_fused_grouped(
        *_grouped_args(packed, x, a_scale, w_scale, g, out, ws, counters),
        *_grouped_decode_plan_args(plan), stream,
    )
    if rc != 0:
        raise RuntimeError(f"ternary_decode_gemm_fused_grouped: CUDA error {rc} at launch ({plan})")


def launch_decode_int(packed: torch.Tensor, a_r: torch.Tensor, g: int, out: torch.Tensor,
                      plan, ws, counters) -> None:
    """Call `ternary_decode_gemm` (packed (M, KG) u8, a_r (g, KG, N) i8 →
    out (M, N) i32) as `launch_decode` calls the fused entry."""
    stream = torch.cuda.current_stream(a_r.device).cuda_stream
    rc = load().ternary_decode_gemm(
        packed.data_ptr(), a_r.data_ptr(), out.data_ptr(), _ptr(ws), _ptr(counters),
        packed.shape[0], packed.shape[1], a_r.shape[2], g, *_decode_plan_args(plan), stream,
    )
    if rc != 0:
        raise RuntimeError(f"ternary_decode_gemm: CUDA error {rc} at launch ({plan})")


def _int_grouped_args(packed: torch.Tensor, a_r: torch.Tensor, out: torch.Tensor, g: int,
                      ws, counters) -> tuple:
    """The grouped integer entries' arguments up to the plan, from packed
    (E, M, KG), a_r (E, g, KG, N) and out (E, M, N), each expert stride in
    elements."""
    e, m, kg = packed.shape
    return (packed.data_ptr(), a_r.data_ptr(), out.data_ptr(), _ptr(ws), _ptr(counters),
            m, kg, a_r.shape[3], g, e, packed.stride(0), a_r.stride(0), out.stride(0))


def launch_decode_int_grouped(packed: torch.Tensor, a_r: torch.Tensor, g: int,
                              out: torch.Tensor, plan, ws, counters) -> None:
    """Call `ternary_decode_gemm_grouped` (E experts in one launch: packed
    (E, M, KG) u8, a_r (E, g, KG, N) i8 → out (E, M, N) i32) as
    `launch_decode` calls the fused entry, with its `GroupedDecodePlan`."""
    stream = torch.cuda.current_stream(a_r.device).cuda_stream
    rc = load().ternary_decode_gemm_grouped(
        *_int_grouped_args(packed, a_r, out, g, ws, counters), *_grouped_decode_plan_args(plan),
        stream,
    )
    if rc != 0:
        raise RuntimeError(f"ternary_decode_gemm_grouped: CUDA error {rc} at launch ({plan})")


def launch_lut(packed: torch.Tensor, x: torch.Tensor, a_scale: torch.Tensor,
               w_scale: torch.Tensor, g: int, out: torch.Tensor, plan, ws, counters) -> None:
    """Call `vlut_lookup_gemm_fused` with its launch plan (a `LutPlan`) and,
    for plan.splits > 1, the zeroed int32 workspace and counters, on
    PyTorch's current stream; raise on any CUDA error the launch reports
    (a plan the kernel refuses included). Arguments are validated by the
    caller."""
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = load().vlut_lookup_gemm_fused(
        packed.data_ptr(), x.data_ptr(), a_scale.data_ptr(), w_scale.data_ptr(),
        out.data_ptr(), _ptr(ws), _ptr(counters), packed.shape[0], packed.shape[1],
        x.shape[0], g, x.stride(0), out.stride(0), 1 if w_scale.shape[0] > 1 else 0,
        int(x.dtype == torch.bfloat16), int(out.dtype == torch.bfloat16),
        plan.bm, plan.splits, plan.chunk, plan.smem, stream,
    )
    if rc != 0:
        raise RuntimeError(f"vlut_lookup_gemm_fused: CUDA error {rc} at launch ({plan})")


def launch_lut_grouped(packed: torch.Tensor, x: torch.Tensor, a_scale: torch.Tensor,
                       w_scale: torch.Tensor, g: int, out: torch.Tensor, plan, ws,
                       counters) -> None:
    """Call `vlut_lookup_gemm_fused_grouped` (E experts in one launch:
    packed (E, M, KG) u8, x (E, C, K) → out (E, C, M)) as `launch_lut`
    calls the single entry, with its `GroupedLutPlan`."""
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = load().vlut_lookup_gemm_fused_grouped(
        *_grouped_args(packed, x, a_scale, w_scale, g, out, ws, counters),
        plan.bm, plan.splits, plan.chunk, plan.ex, plan.smem, stream,
    )
    if rc != 0:
        raise RuntimeError(f"vlut_lookup_gemm_fused_grouped: CUDA error {rc} at launch ({plan})")


def launch_lut_int(packed: torch.Tensor, a_r: torch.Tensor, g: int, out: torch.Tensor,
                   plan, ws, counters) -> None:
    """Call `vlut_lookup_gemm` (packed (M, KG) u8, a_r (g, KG, N) i8 → out
    (M, N) i32) as `launch_lut` calls the fused entry."""
    stream = torch.cuda.current_stream(a_r.device).cuda_stream
    rc = load().vlut_lookup_gemm(
        packed.data_ptr(), a_r.data_ptr(), out.data_ptr(), _ptr(ws), _ptr(counters),
        packed.shape[0], packed.shape[1], a_r.shape[2], g,
        plan.bm, plan.splits, plan.chunk, plan.smem, stream,
    )
    if rc != 0:
        raise RuntimeError(f"vlut_lookup_gemm: CUDA error {rc} at launch ({plan})")


def launch_lut_int_grouped(packed: torch.Tensor, a_r: torch.Tensor, g: int, out: torch.Tensor,
                           plan, ws, counters) -> None:
    """Call `vlut_lookup_gemm_grouped` (E experts in one launch: packed
    (E, M, KG) u8, a_r (E, g, KG, N) i8 → out (E, M, N) i32) as
    `launch_lut` calls the fused entry, with its `GroupedLutPlan`."""
    stream = torch.cuda.current_stream(a_r.device).cuda_stream
    rc = load().vlut_lookup_gemm_grouped(
        *_int_grouped_args(packed, a_r, out, g, ws, counters),
        plan.bm, plan.splits, plan.chunk, plan.ex, plan.smem, stream,
    )
    if rc != 0:
        raise RuntimeError(f"vlut_lookup_gemm_grouped: CUDA error {rc} at launch ({plan})")


def grouped_blocks_per_sm(g: int, int_kernel: bool, a_bf16: bool, out_bf16: bool,
                          smem: int) -> int:
    """Blocks of the grouped vector-LUT kernel (that instantiation) that
    fit on one SM with `smem` dynamic shared bytes, as the CUDA runtime
    reports it: the occupancy `grouped_lut_plan` counts waves at."""
    n = load().vlut_grouped_blocks_per_sm(g, int(int_kernel), int(a_bf16), int(out_bf16), smem)
    if n < 0:
        raise RuntimeError(f"vlut_grouped_blocks_per_sm: CUDA error at smem {smem}")
    return n


def decode_grouped_blocks_per_sm(g: int, int_kernel: bool, a_bf16: bool, out_bf16: bool,
                                 smem: int) -> int:
    """Blocks of the grouped decode kernel (that instantiation) that fit on
    one SM with `smem` dynamic shared bytes, as the CUDA runtime reports
    it: the occupancy `grouped_decode_plan` counts waves at."""
    n = load().decode_grouped_blocks_per_sm(g, int(int_kernel), int(a_bf16), int(out_bf16), smem)
    if n < 0:
        raise RuntimeError(f"decode_grouped_blocks_per_sm: CUDA error at smem {smem}")
    return n


def launch_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                 plan, *, causal: bool, window: int, scale: float, softcap: float) -> None:
    """Call `flash_attention_fwd` with its launch plan (a `FlashPlan`) on
    PyTorch's current stream; raise on any CUDA error the launch reports (a
    plan the entry refuses included). q, out (B, H, Sq, D); k, v (B, KV,
    Sk, D); arguments are validated by the caller."""
    b, h, sq, d = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = load().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, k.shape[1], sq, k.shape[2], d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        int(causal), int(window), scale, softcap, int(q.dtype == torch.bfloat16),
        plan.bq, plan.bk, plan.dp, plan.stages, int(plan.aligned), plan.smem, stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd: CUDA error {rc} at launch ({plan})")
