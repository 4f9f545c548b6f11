"""Plain-torch oracles for the mpGeMM kernels (ported from `repro.kernels.ref`).

The oracle for every Vec-LUT/mpGeMM kernel is the dense ternary matmul in
int32: unpack the trit codes, multiply, accumulate exactly. The integer
product runs as int64 on the host-side CPU path (torch has no int32 matmul
on CUDA), then narrows to int32: exact, since |sum| <= 127*K fits in int32.
"""
from __future__ import annotations

import torch

from repro_torch.core.packing import PackedWeight, unpack_ternary
from repro_torch.core.quantize import act_quant_tokens


def _w_scale(pw: PackedWeight) -> torch.Tensor:
    return pw.scale if pw.scale.shape[-1] == pw.M else pw.scale.expand(pw.M)


def ref_segment_gemm_int(packed: torch.Tensor, a_q: torch.Tensor, g: int) -> torch.Tensor:
    """Dense int32 reference for one homogeneous-g segment.

    packed: (M, K//g) uint8, a_q: (K, N) int8 → (M, N) int32.
    """
    w_t = unpack_ternary(packed, g).to(torch.int64)                 # (M, K)
    return (w_t.cpu() @ a_q.to(torch.int64).cpu()).to(torch.int32).to(packed.device)


def ref_mpgemm_int(pw: PackedWeight, a_q: torch.Tensor) -> torch.Tensor:
    """Dense int32 reference over all segments. a_q: (K, N) int8 → (M, N)."""
    out = torch.zeros((pw.M, a_q.shape[1]), dtype=torch.int32, device=a_q.device)
    if pw.packed5.shape[-1]:
        out = out + ref_segment_gemm_int(pw.packed5, a_q[: pw.k5], 5)
    if pw.packed4.shape[-1]:
        out = out + ref_segment_gemm_int(pw.packed4, a_q[pw.k5:], 4)
    return out


def ref_mpgemm(pw: PackedWeight, a: torch.Tensor) -> torch.Tensor:
    """Float end-to-end reference (per-token int8 act quant + dequant)."""
    a_q, a_scale = act_quant_tokens(a)
    out = ref_mpgemm_int(pw, a_q)
    return out.to(torch.float32) * _w_scale(pw)[:, None] * a_scale[None, :]
