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
default) or "lookup" (the paper's vector-LUT). The JAX package's "xla"
impl is its shardable dry-run path and waits for the port of `dist`. Its
`tiles=` override and autotuner (`kernels/autotune.py`) choose TPU VMEM
tiles; the port's tile selection is still to come (ROADMAP A 7).
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.core.packing import PackedWeight
from repro_torch.core.quantize import act_quant_tokens, act_token_scale

from .ternary_decode_gemm import ternary_decode_gemm, ternary_decode_gemm_fused
from .vlut_lookup_gemm import vlut_lookup_gemm, vlut_lookup_gemm_fused

IMPLS = ("decode", "lookup")
FUSIONS = ("fused", "unfused")
_KERNELS = {"decode": ternary_decode_gemm_fused, "lookup": vlut_lookup_gemm_fused}
_INT_KERNELS = {"decode": ternary_decode_gemm, "lookup": vlut_lookup_gemm}


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
    if impl == "xla":
        raise NotImplementedError(
            "impl='xla' is the JAX package's shardable dry-run path; it is "
            "not ported yet (it comes with the port of dist)"
        )
    if impl not in IMPLS:
        raise ValueError(f"unknown mpGeMM impl {impl!r}; have {IMPLS}")


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
    """Token-major fused mpGeMM: x (N, K) float → (N, M) out_dtype."""
    _check_impl(impl)
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


def _deinterleave(a_q: torch.Tensor, g: int) -> torch.Tensor:
    """(K, N) → (g, K//g, N) contiguous: A_r[j, k, :] = A[k*g+j, :] (§3.3
    layout). Only the unfused pipeline materializes it, one copy per
    segment; the fused kernels de-interleave in shared memory."""
    k, n = a_q.shape
    return a_q.view(k // g, g, n).permute(1, 0, 2).contiguous()


def _segment_gemm_int(packed: torch.Tensor, a_q_seg: torch.Tensor, g: int,
                      impl: str) -> torch.Tensor:
    """Unfused integer segment: packed (M, KG) uint8 × a_q_seg (K, N) int8
    → (M, N) int32, through the chosen integer kernel. Nothing is padded:
    the kernels mask ragged edges themselves."""
    return _INT_KERNELS[impl](packed, _deinterleave(a_q_seg, g), g=g)


def _mpgemm_unfused(pw: PackedWeight, a: torch.Tensor, impl: str,
                    out_dtype) -> torch.Tensor:
    """The three-pass pipeline: a (K, N) float → (M, N) out_dtype."""
    _check_impl(impl)
    a_q, a_scale = act_quant_tokens(a)                               # (K, N) int8
    parts = [_segment_gemm_int(packed, a_q[lo:hi], g, impl)
             for packed, lo, hi, g in _segments(pw)]
    if not parts:
        return torch.zeros((pw.M, a.shape[1]), dtype=out_dtype, device=a.device)
    acc = parts[0] if len(parts) == 1 else parts[0] + parts[1]      # int32 sum
    w_scale = pw.scale.expand(pw.M)
    return ((acc.to(torch.float32) * w_scale[:, None]) * a_scale[None, :]).to(out_dtype)


def vlut_mpgemm(pw: PackedWeight, a: torch.Tensor, *, impl: str = "decode",
                out_dtype=torch.float32, fusion: str = "fused") -> torch.Tensor:
    """Kernel-backed mpGeMM with the JAX package's layout: a (K, N) float,
    token-contiguous → (M, N). `fusion` picks the pipeline (module
    docstring)."""
    _check_fusion(fusion)
    if fusion == "unfused":
        return _mpgemm_unfused(pw, a, impl, out_dtype)
    return _mpgemm_tokens(pw, a.T.contiguous(), impl, out_dtype).T


def segment_mpgemm(packed: torch.Tensor, a: torch.Tensor, g: int, impl: str, *,
                   fused: bool = True, out_dtype=torch.float32) -> torch.Tensor:
    """One homogeneous-g mpGeMM with unit weight scale: packed (M, K//g)
    uint8 × a (K, N) float → (M, N), through the fused kernel or the
    unfused pipeline. (The JAX version is its autotuner's timing target and
    also takes `tiles=`; the port has no tile choice yet.)"""
    _check_impl(impl)
    if fused:
        x = a.T.contiguous()                                         # (N, K)
        ones = torch.ones((1,), dtype=torch.float32, device=a.device)
        out = _KERNELS[impl](packed, x, act_token_scale(a).contiguous(), ones, g=g,
                             out_dtype=out_dtype)
        return out.T
    a_q, a_scale = act_quant_tokens(a)
    out = _segment_gemm_int(packed, a_q, g, impl)
    return (out.to(torch.float32) * a_scale[None, :]).to(out_dtype)


def ternary_matmul(pw: PackedWeight, x: torch.Tensor, impl: str | None = None,
                   fusion: str | None = None) -> torch.Tensor:
    """Model-facing packed linear: y (..., M) = x (..., K) · Wᵀ.

    The fused pipeline reads x in its natural token-major layout and writes
    token-major: the two transposes of the TPU path do not exist there. The
    unfused pipeline keeps the JAX layout, (K, N) in and (M, N) out, around
    its passes. Routing comes from the process DispatchConfig unless `impl`
    or `fusion` is given."""
    impl = impl if impl is not None else _dispatch.impl
    fusion = fusion if fusion is not None else _dispatch.fusion
    _check_fusion(fusion)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if fusion == "unfused":
        out = _mpgemm_unfused(pw, x2.T, impl, x.dtype).T
    else:
        out = _mpgemm_tokens(pw, x2, impl, x.dtype)
    return out.reshape(*lead, pw.M)
