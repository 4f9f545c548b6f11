"""Model-facing mpGeMM entry points (ported from `repro.kernels.ops`).

Every BitLinear of the serving path lands in `ternary_matmul`, which runs
one fused single-pass kernel per packed segment: the g=5 segment, then the
g=4 one. Per-token activation scales are computed once over the full K
(`act_token_scale`) and shared by both segments; a single-segment weight is
written by the kernel straight in the output type, a two-segment weight as
one f32 partial per segment, summed and then cast — the TPU path's rules.

`impl` picks the kernel: "decode" (ternary decode + integer dot, the
default) or "lookup" (the paper's vector-LUT). The JAX package's "xla"
impl is its shardable dry-run path and waits for the port of `dist`; the
unfused ablation pipeline waits for the unfused kernels.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.core.packing import PackedWeight
from repro_torch.core.quantize import act_token_scale

from .ternary_decode_gemm import ternary_decode_gemm_fused
from .vlut_lookup_gemm import vlut_lookup_gemm_fused

IMPLS = ("decode", "lookup")
_KERNELS = {"decode": ternary_decode_gemm_fused, "lookup": vlut_lookup_gemm_fused}


@dataclasses.dataclass
class DispatchConfig:
    """Process-wide default for `ternary_matmul` routing."""
    impl: str = "decode"


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


def configure_dispatch(**kw) -> DispatchConfig:
    """Set process-wide dispatch defaults. None values are ignored; unknown
    knobs raise."""
    for k, v in kw.items():
        if k not in _DISPATCH_FIELDS:
            raise TypeError(f"unknown dispatch knob {k!r}; have {_DISPATCH_FIELDS}")
        if v is not None:
            _check_impl(v)
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


def vlut_mpgemm(pw: PackedWeight, a: torch.Tensor, *, impl: str = "decode",
                out_dtype=torch.float32) -> torch.Tensor:
    """Kernel-backed mpGeMM with the JAX package's layout: a (K, N) float,
    token-contiguous → (M, N)."""
    return _mpgemm_tokens(pw, a.T.contiguous(), impl, out_dtype).T


def ternary_matmul(pw: PackedWeight, x: torch.Tensor, impl: str | None = None) -> torch.Tensor:
    """Model-facing packed linear: y (..., M) = x (..., K) · Wᵀ.

    Reads x in its natural token-major layout and writes token-major: the
    two transposes of the TPU path do not exist here. Routing comes from
    the process DispatchConfig unless `impl` is given."""
    impl = impl if impl is not None else _dispatch.impl
    lead = x.shape[:-1]
    out = _mpgemm_tokens(pw, x.reshape(-1, x.shape[-1]), impl, x.dtype)
    return out.reshape(*lead, pw.M)
