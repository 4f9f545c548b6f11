"""Model-facing mpGeMM entry points (ported from `repro.kernels.ops`).

Every BitLinear of the serving path lands in `ternary_matmul`. `fusion`
picks the pipeline:

- "fused" (the default): one single-pass kernel per packed segment, the
  g=5 segment, then the g=4 one. Per-token activation scales are computed
  once over the full K (`act_token_scale`) and shared by both segments; a
  single-segment weight is written by the kernel straight in the output
  type, a two-segment weight as one f32 partial per segment, summed and
  then cast — the TPU path's rules.
- "unfused": the three-pass pipeline the paper's §3.3 fusion is measured
  against. The activations are quantized once over the full K into an int8
  buffer (`act_quant_tokens`), each segment's slice is copied to the
  de-interleaved (g, K/g, N) layout, the integer kernel writes int32
  (M, N), the segments are summed in int32, and one dequant pass applies
  w_scale × a_scale and casts. With one segment the two pipelines are
  bit-identical; with two they agree to f32 rounding.

`impl` picks the kernel: "decode" (ternary decode + integer dot, the
default) or "lookup" (the paper's vector-LUT). "xla" is the JAX package's
shardable path (its default off the TPU), ported as it computes there:
no kernel of this package, but the codes decoded to trits and one integer
product per chunk of 512 K-groups, summed over the chunks in int32
(`_xla_streamed_decode`). It always runs the unfused pipeline, as in the
JAX package, and only when asked for.

Each kernel launch takes its plan from `autotune.get_plan` (a measured
winner from the plan cache, else the heuristic plan); `segment_mpgemm`
also takes an explicit `plan=`, and `launch_tiles` reports what each
launch will use without ever tuning.

With an `Obs` installed (`repro_torch.obs.install`, done by an `Engine`
built with `obs=`), every `ternary_matmul` / `ternary_matmul_batched` call
records one `mpgemm_dispatch` span and one `repro:mpgemm_dispatch_total`
increment, with (M, K, N, impl, fusion) and, as `tile`, the launch plan of
each packed segment (one entry per kernel launch). A span fires where the
call runs on the host: at each eager call, and at the capture of a serving
step's CUDA graph (`serve.graphs`), whose replays issue none — the JAX
package's semantics, where a jitted step records one span per compiled
shape at trace time. The engine's step spans stay the per-tick record.
Without one installed, a call pays one `current()` lookup.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.distributed.tensor import DTensor

from repro_torch import obs as obs_mod
from repro_torch.core.packing import PackedWeight
from repro_torch.core.quantize import act_quant_tokens, act_token_scale

from . import autotune
from .ternary_decode_gemm import (
    ternary_decode_gemm,
    ternary_decode_gemm_fused,
    ternary_decode_gemm_fused_grouped,
    ternary_decode_gemm_grouped,
)
from .vlut_lookup_gemm import (
    vlut_lookup_gemm,
    vlut_lookup_gemm_fused,
    vlut_lookup_gemm_fused_grouped,
    vlut_lookup_gemm_grouped,
)

IMPLS = ("decode", "lookup", "xla")
#: the K-groups of one integer product of the "xla" impl
XLA_K_CHUNK_GROUPS = 512
_R = 3
FUSIONS = ("fused", "unfused")
_KERNELS = {"decode": ternary_decode_gemm_fused, "lookup": vlut_lookup_gemm_fused}
_GROUPED_KERNELS = {"decode": ternary_decode_gemm_fused_grouped,
                    "lookup": vlut_lookup_gemm_fused_grouped}
_INT_KERNELS = {"decode": ternary_decode_gemm, "lookup": vlut_lookup_gemm}
_INT_GROUPED_KERNELS = {"decode": ternary_decode_gemm_grouped, "lookup": vlut_lookup_gemm_grouped}


@dataclasses.dataclass
class DispatchConfig:
    """Process-wide defaults for `ternary_matmul` routing."""
    impl: str = "decode"
    fusion: str = "fused"


_dispatch = DispatchConfig()
_DISPATCH_FIELDS = tuple(f.name for f in dataclasses.fields(DispatchConfig))


def dispatch_config() -> DispatchConfig:
    return _dispatch


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown mpGeMM impl {impl!r}; have {IMPLS}")


def check_local(*tensors) -> None:
    """The kernels take raw pointers: a DTensor (a sharded weight or
    activation under a mesh) must never reach them. The "xla" impl, plain
    tensor code, takes DTensors (the dry run's sharded serving steps)."""
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(
            "the mpGeMM and flash kernels take local tensors; a DTensor reached "
            "one (run the kernel on local shards, e.g. through local_map)")


def _check_fusion(fusion: str) -> None:
    if fusion not in FUSIONS:
        raise ValueError(f"unknown mpGeMM fusion {fusion!r}; have {FUSIONS}")


_CHECKS = {"impl": _check_impl, "fusion": _check_fusion}


def configure_dispatch(**kw) -> DispatchConfig:
    """Set process-wide dispatch defaults. None values are ignored; unknown
    knobs raise."""
    for k, v in kw.items():
        if k not in _DISPATCH_FIELDS:
            raise TypeError(f"unknown dispatch knob {k!r}; have {_DISPATCH_FIELDS}")
        if v is not None:
            _CHECKS[k](v)
            setattr(_dispatch, k, v)
    return _dispatch


@contextlib.contextmanager
def dispatch_override(**kw):
    """Temporarily override dispatch defaults (None values are ignored)."""
    saved = {f: getattr(_dispatch, f) for f in _DISPATCH_FIELDS}
    try:
        configure_dispatch(**kw)
        yield _dispatch
    finally:
        for f, v in saved.items():
            setattr(_dispatch, f, v)


def _segments(pw: PackedWeight):
    """[(packed, col_start, col_stop, g)] for the non-empty segments."""
    segs = []
    if pw.packed5.shape[-1]:
        segs.append((pw.packed5, 0, pw.k5, 5))
    if pw.packed4.shape[-1]:
        segs.append((pw.packed4, pw.k5, pw.k5 + pw.k4, 4))
    return segs


def _mpgemm_tokens(pw: PackedWeight, x: torch.Tensor, impl: str,
                   out_dtype) -> torch.Tensor:
    """Token-major fused mpGeMM: x (N, K) float → (N, M) out_dtype ("xla":
    the unfused pipeline, never fused)."""
    _check_impl(impl)
    if impl == "xla":
        return _mpgemm_unfused(pw, x.T, impl, out_dtype).T
    if x.shape[1] > 1 and x.stride(1) != 1:
        x = x.contiguous()
    x_f = x if x.is_floating_point() else x.to(torch.float32)
    a_scale = act_token_scale(x_f.T).contiguous()                    # (N,)
    segs = _segments(pw)
    if not segs:
        return torch.zeros((x.shape[0], pw.M), dtype=out_dtype, device=x.device)
    seg_dtype = out_dtype if len(segs) == 1 else torch.float32
    kernel = _KERNELS[impl]
    parts = [
        kernel(packed, x_f[:, lo:hi], a_scale, pw.scale, g=g, out_dtype=seg_dtype)
        for packed, lo, hi, g in segs
    ]
    return parts[0] if len(parts) == 1 else (parts[0] + parts[1]).to(out_dtype)


def _deinterleave(a_q: torch.Tensor, g: int, e: int = 0) -> torch.Tensor:
    """(K, N) → (g, K//g, N) contiguous: A_r[j, k, :] = A[k*g+j, :] (§3.3
    layout). With e > 0 the N columns are e experts' tokens in turn, → (e,
    g, K//g, N/e), the grouped kernels' operand. Only the unfused pipeline
    materializes it, one copy per segment; the fused kernels de-interleave
    in shared memory."""
    k, n = a_q.shape
    if e:
        return a_q.view(k // g, g, e, n // e).permute(2, 1, 0, 3).contiguous()
    return a_q.view(k // g, g, n).permute(1, 0, 2).contiguous()


def _decode_dot(packed: torch.Tensor, a_q: torch.Tensor, g: int) -> torch.Tensor:
    """The "xla" impl's chunk: codes (..., M, KG) decoded to a dense trit
    tile, then one product with a_q (..., KG*g, N) int8 → (..., M, N) int32.
    The product runs in f32, exact: every partial sum is an integer below
    KG*g*127 < 2**24 (`XLA_K_CHUNK_GROUPS` K-groups at most); CUDA
    matmuls keep TF32 off (torch's default), and TF32 would be exact on
    these operands too."""
    places = _R ** torch.arange(g, dtype=torch.int32, device=packed.device)
    trits = torch.div(packed.to(torch.int32)[..., None], places,
                      rounding_mode="floor") % _R - 1               # (..., M, KG, g)
    w_t = trits.reshape(*packed.shape[:-1], packed.shape[-1] * g).to(torch.float32)
    return torch.matmul(w_t, a_q.to(torch.float32)).to(torch.int32)


def _xla_streamed_decode(packed: torch.Tensor, a_q_seg: torch.Tensor, g: int,
                         k_chunk_groups: int = XLA_K_CHUNK_GROUPS) -> torch.Tensor:
    """The JAX package's pure-XLA streamed decode + dot: packed (..., M, KG)
    uint8 × a_q_seg (..., KG*g, N) int8 → (..., M, N) int32, one
    `_decode_dot` per chunk of `k_chunk_groups` K-groups (the transient
    decoded tile stays M × chunk·g), summed over the chunks in int32. The
    last chunk is cut short where JAX pads it with zero codes and zero
    activations (the same sum)."""
    kg = packed.shape[-1]
    out = None
    for c0 in range(0, kg, k_chunk_groups):
        c1 = min(kg, c0 + k_chunk_groups)
        part = _decode_dot(packed[..., c0:c1], a_q_seg[..., c0 * g:c1 * g, :], g)
        out = part if out is None else out + part
    return out


def _segment_gemm_int(packed: torch.Tensor, a_q_seg: torch.Tensor, g: int,
                      impl: str, e: int = 0, plan=None) -> torch.Tensor:
    """Unfused integer segment: packed (M, KG) uint8 × a_q_seg (K, N) int8
    → (M, N) int32, through the chosen integer kernel; with e > 0 stacked
    packed (E, M, KG) and N = E*C tokens, expert by expert, → (E, M, C)
    through ONE launch of the grouped integer kernel. Nothing is padded:
    the kernels mask ragged edges themselves. "xla" launches no kernel
    (`_xla_streamed_decode`, batched over the experts). `plan`: the integer
    kernel's, as its wrapper takes it (passed only when given, so a plain
    version can stand in for the kernel)."""
    if impl == "xla":
        if e:
            k, n = a_q_seg.shape
            return _xla_streamed_decode(packed, a_q_seg.view(k, e, n // e).transpose(0, 1), g)
        return _xla_streamed_decode(packed, a_q_seg, g)
    kernel = _INT_GROUPED_KERNELS[impl] if e else _INT_KERNELS[impl]
    planned = {} if plan is None else {"plan": plan}
    return kernel(packed, _deinterleave(a_q_seg, g, e), g=g, **planned)


def _mpgemm_unfused(pw: PackedWeight, a: torch.Tensor, impl: str, out_dtype,
                    e: int = 0) -> torch.Tensor:
    """The three-pass pipeline: a (K, N) float → (M, N) out_dtype. With
    e > 0, a stacked `pw` and N = E*C tokens, expert e's C in turn → (E, M,
    C): each pass is one call over every expert (the quantizer's scales
    are per token, so one call over all E*C tokens gives each expert's
    bits)."""
    _check_impl(impl)
    a_q, a_scale = act_quant_tokens(a)                               # (K, N) int8
    n = a.shape[1]
    parts = [_segment_gemm_int(packed, a_q[lo:hi], g, impl, e)
             for packed, lo, hi, g in _segments(pw)]
    if not parts:
        shape = (e, pw.M, n // e) if e else (pw.M, n)
        return torch.zeros(shape, dtype=out_dtype, device=a.device)
    acc = parts[0] if len(parts) == 1 else parts[0] + parts[1]      # int32 sum
    if e:
        w_scale, a_scale = pw.scale.expand(e, pw.M)[..., None], a_scale.view(e, 1, n // e)
    else:
        w_scale, a_scale = pw.scale.expand(pw.M)[:, None], a_scale[None, :]
    return ((acc.to(torch.float32) * w_scale) * a_scale).to(out_dtype)


def vlut_mpgemm(pw: PackedWeight, a: torch.Tensor, *, impl: str = "decode",
                out_dtype=torch.float32, fusion: str = "fused") -> torch.Tensor:
    """Kernel-backed mpGeMM with the JAX package's layout: a (K, N) float,
    token-contiguous → (M, N). `fusion` picks the pipeline (module
    docstring)."""
    _check_fusion(fusion)
    if fusion == "unfused" or impl == "xla":
        return _mpgemm_unfused(pw, a, impl, out_dtype)
    return _mpgemm_tokens(pw, a.T.contiguous(), impl, out_dtype).T


def segment_mpgemm(packed: torch.Tensor, a: torch.Tensor, g: int, impl: str, *,
                   fused: bool = True, out_dtype=torch.float32, plan=None) -> torch.Tensor:
    """One homogeneous-g mpGeMM with unit weight scale: packed (M, K//g)
    uint8 × a (K, N) float → (M, N), through the fused kernel or the
    unfused pipeline. `plan`: the launch plan of its one kernel launch, as
    the kernel's wrapper takes it (None: `autotune.get_plan`'s), as the
    JAX version takes `tiles=`."""
    _check_impl(impl)
    if fused and impl != "xla":
        x = a.T.contiguous()                                         # (N, K)
        ones = torch.ones((1,), dtype=torch.float32, device=a.device)
        planned = {} if plan is None else {"plan": plan}
        out = _KERNELS[impl](packed, x, act_token_scale(a).contiguous(), ones, g=g,
                             out_dtype=out_dtype, **planned)
        return out.T
    a_q, a_scale = act_quant_tokens(a)
    out = _segment_gemm_int(packed, a_q, g, impl, plan=plan)
    return (out.to(torch.float32) * a_scale[None, :]).to(out_dtype)


def launch_tiles(pw: PackedWeight, n: int, impl: str, e: int | None = None,
                 fusion: str = "fused") -> list[str]:
    """The launch plan of each packed segment of one call at N tokens (per
    expert, over `e` experts in one grouped launch; None: a single
    launch), one entry per kernel launch: the dispatch span's `tile`, the
    counterpart of the JAX package's autotuned TPU tiles. Each is the plan
    that launch will use, cached or heuristic (`autotune.get_plan`, never
    tuning here), as `autotune.describe` writes it; "e16 " in front of a
    grouped launch's. No tokens, or "xla" (no kernel): no launch."""
    _check_impl(impl)
    if n == 0 or impl == "xla":
        return []
    head = f"e{e} " if e is not None and e > 1 else ""
    kernel = impl if e is None else f"{impl}_grouped"
    return [head + autotune.describe(autotune.get_plan(
                kernel, g, pw.M, packed.shape[-1], n, e=e, fused=fusion == "fused",
                device=packed.device, tune_if_missing=False))
            for packed, _, _, g in _segments(pw)]


def ternary_matmul(pw: PackedWeight, x: torch.Tensor, impl: str | None = None,
                   fusion: str | None = None) -> torch.Tensor:
    """Model-facing packed linear: y (..., M) = x (..., K) · Wᵀ.

    The fused pipeline reads x in its natural token-major layout and writes
    token-major: the two transposes of the TPU path do not exist there. The
    unfused pipeline keeps the JAX layout, (K, N) in and (M, N) out, around
    its passes. Routing comes from the process DispatchConfig unless `impl`
    or `fusion` is given. An installed `Obs` gets one dispatch span per
    call (module docstring)."""
    impl = impl if impl is not None else _dispatch.impl
    fusion = fusion if fusion is not None else _dispatch.fusion
    _check_fusion(fusion)
    if impl != "xla":
        check_local(x, pw.packed5, pw.packed4, pw.scale)
    x2 = x.reshape(-1, x.shape[-1])
    o = obs_mod.current()
    if o is None:
        return _ternary_matmul(pw, x2, impl, fusion).reshape(*x.shape[:-1], pw.M)
    with o.mpgemm_span(m_tokens=x2.shape[0], k=pw.K, n_out=pw.M, impl=impl, fusion=fusion,
                       tiles=launch_tiles(pw, x2.shape[0], impl, fusion=fusion)):
        return _ternary_matmul(pw, x2, impl, fusion).reshape(*x.shape[:-1], pw.M)


def _ternary_matmul(pw: PackedWeight, x2: torch.Tensor, impl: str, fusion: str) -> torch.Tensor:
    """`ternary_matmul` on flattened tokens: x2 (N, K) → (N, M)."""
    if fusion == "unfused" or impl == "xla":
        return _mpgemm_unfused(pw, x2.T, impl, x2.dtype).T
    return _mpgemm_tokens(pw, x2, impl, x2.dtype)


def ternary_matmul_batched(pw: PackedWeight, x: torch.Tensor, impl: str | None = None,
                           fusion: str | None = None) -> torch.Tensor:
    """Stacked expert linears: y (E, C, M) = x (E, C, K) · W[e]ᵀ, from a
    stacked `PackedWeight` (packed5/packed4 (E, M, KG), scale (E, M)). The
    counterpart of ``jax.vmap(ternary_matmul)`` over a MoE layer's experts.

    The fused pipeline keeps `ternary_matmul`'s rules per expert: the
    activation scales are taken per (expert, row) over the full K, a
    single-segment weight is written straight in x's dtype, and a
    two-segment weight gives one f32 partial per segment, summed and then
    cast. The unfused pipeline keeps `_mpgemm_unfused`'s passes, each
    batched over the experts: one quantize over all E*C rows, one
    de-interleave copy and one dequant. Either way each segment is ONE
    grouped launch over all E experts, and an installed `Obs` gets one
    dispatch span per call with M = C, the rows per expert (JAX's vmap
    traces its hook once, with the per-expert rows)."""
    impl = impl if impl is not None else _dispatch.impl
    fusion = fusion if fusion is not None else _dispatch.fusion
    _check_fusion(fusion)
    _check_impl(impl)
    if impl != "xla":
        check_local(x, pw.packed5, pw.packed4, pw.scale)
    o = obs_mod.current()
    if o is None:
        return _ternary_matmul_batched(pw, x, impl, fusion)
    e, c, _ = x.shape
    with o.mpgemm_span(m_tokens=c, k=pw.K, n_out=pw.M, impl=impl, fusion=fusion,
                       tiles=launch_tiles(pw, c, impl, e, fusion)):
        return _ternary_matmul_batched(pw, x, impl, fusion)


def _ternary_matmul_batched(pw: PackedWeight, x: torch.Tensor, impl: str,
                            fusion: str) -> torch.Tensor:
    """`ternary_matmul_batched` after routing: x (E, C, K) → (E, C, M)."""
    e, c, k = x.shape
    if fusion == "unfused" or impl == "xla":
        return _mpgemm_unfused(pw, x.reshape(e * c, k).T, impl, x.dtype, e=e).transpose(1, 2)
    if k > 1 and x.stride(2) != 1:
        x = x.contiguous()
    x_f = x if x.is_floating_point() else x.to(torch.float32)
    a_scale = act_token_scale(x_f.reshape(e * c, k).T).reshape(e, c)     # (E, C)
    segs = _segments(pw)
    if not segs:
        return torch.zeros((e, c, pw.M), dtype=x.dtype, device=x.device)
    seg_dtype = x.dtype if len(segs) == 1 else torch.float32
    kernel = _GROUPED_KERNELS[impl]
    parts = [
        kernel(packed, x_f[..., lo:hi], a_scale, pw.scale, g=g, out_dtype=seg_dtype)
        for packed, lo, hi, g in segs
    ]
    return parts[0] if len(parts) == 1 else (parts[0] + parts[1]).to(x.dtype)
