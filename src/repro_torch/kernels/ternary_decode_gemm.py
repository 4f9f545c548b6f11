"""Ternary-decode mpGeMM: the fused kernel and its integer twin, each with
its CUDA kernel's wrapper, its plain PyTorch version and its launch count.

Ports of the TPU kernels `ternary_decode_gemm_fused` and
`ternary_decode_gemm` (src/repro/kernels/ternary_decode_gemm.py). The CUDA
source of both is ``csrc/ternary_decode_gemm.cu``. Unlike the TPU wrapper,
the fused one reads the activations in the token-major (N, K) layout the
model produces and writes (N, M): no transposes, no padding. The integer
one keeps the TPU contract, pre-quantized de-interleaved int8 a_r
(g, KG, N) → int32 (M, N), and pads nothing either.
"""
from __future__ import annotations

import torch

from repro_torch.core.packing import unpack_ternary
from repro_torch.core.quantize import Q_MAX

from . import _build

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def check_fused_args(packed, x, a_scale, w_scale, g: int, out_dtype) -> None:
    """Validate the fused-mpGeMM contract shared by both kernels.

    packed (M, KG) uint8 contiguous; x (N, KG*g) float with unit column
    stride; a_scale (N,) f32 contiguous; w_scale (M,) or (1,) f32 contiguous;
    all on one device."""
    if g not in (4, 5):
        raise ValueError(f"group size g must be 4 or 5, got {g}")
    if packed.dtype != torch.uint8 or packed.ndim != 2 or not packed.is_contiguous():
        raise ValueError(f"packed must be a contiguous (M, KG) uint8 tensor, got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    m, kg = packed.shape
    if x.ndim != 2 or x.shape[1] != kg * g or not x.is_floating_point():
        raise ValueError(f"x must be a float (N, {kg * g}) tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.shape[1] > 1 and x.stride(1) != 1:
        raise ValueError("x must have unit stride along K")
    n = x.shape[0]
    if a_scale.dtype != torch.float32 or tuple(a_scale.shape) != (n,) or not a_scale.is_contiguous():
        raise ValueError(f"a_scale must be a contiguous ({n},) float32 tensor")
    if (w_scale.dtype != torch.float32 or w_scale.ndim != 1
            or w_scale.shape[0] not in (1, m) or not w_scale.is_contiguous()):
        raise ValueError(f"w_scale must be a contiguous ({m},) or (1,) float32 tensor")
    devs = {t.device for t in (packed, x, a_scale, w_scale)}
    if len(devs) != 1:
        raise ValueError(f"all operands must be on one device, got {devs}")
    if out_dtype not in _KERNEL_DTYPES:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")


def check_int_args(packed, a_r, g: int) -> None:
    """Validate the integer-mpGeMM contract shared by both kernels.

    packed (M, KG) uint8 contiguous; a_r (g, KG, N) int8 contiguous with
    a_r[j, kg, n] = a_q[kg*g + j, n]; both on one device."""
    if g not in (4, 5):
        raise ValueError(f"group size g must be 4 or 5, got {g}")
    if packed.dtype != torch.uint8 or packed.ndim != 2 or not packed.is_contiguous():
        raise ValueError(f"packed must be a contiguous (M, KG) uint8 tensor, got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    kg = packed.shape[1]
    if (a_r.dtype != torch.int8 or a_r.ndim != 3 or tuple(a_r.shape[:2]) != (g, kg)
            or not a_r.is_contiguous()):
        raise ValueError(f"a_r must be a contiguous ({g}, {kg}, N) int8 tensor, got "
                         f"{a_r.dtype} {tuple(a_r.shape)}")
    if packed.device != a_r.device:
        raise ValueError(f"all operands must be on one device, got "
                         f"{packed.device} and {a_r.device}")


def check_f32_exact(k: int) -> None:
    """The plain versions take integer dot products in f32: exact while
    every partial sum stays below 2^24, |sum| <= 127*K."""
    if 127 * k >= 2 ** 24:
        raise ValueError(f"K={k}: 127*K >= 2^24, the f32 integer dot is no longer exact")


def quantize_tokens(x: torch.Tensor, a_scale: torch.Tensor) -> torch.Tensor:
    """Per-token int8 quantization of a token-major (N, K) activation, as
    exact integers in f32: f32 cast first, then divide, round half to even,
    clip to +-127 — the kernels' prologue."""
    return torch.round(x.to(torch.float32) / a_scale[:, None]).clamp(-Q_MAX, Q_MAX)


def epilogue(acc: torch.Tensor, w_scale: torch.Tensor, a_scale: torch.Tensor,
             out_dtype) -> torch.Tensor:
    """(acc * w_scale[m]) * a_scale[n] in f32, then one cast — (N, M)."""
    m = acc.shape[1]
    return ((acc.to(torch.float32) * w_scale.expand(m)[None, :])
            * a_scale[:, None]).to(out_dtype)


def ternary_decode_gemm_fused_plain(packed, x, a_scale, w_scale, *, g: int,
                                    out_dtype=torch.float32) -> torch.Tensor:
    """Plain version: decode the trits, one f32 matmul of exact integers."""
    check_f32_exact(x.shape[1])
    q = quantize_tokens(x, a_scale)                                  # (N, K)
    w = unpack_ternary(packed, g).to(torch.float32)                  # (M, K)
    return epilogue(q @ w.T, w_scale, a_scale, out_dtype)


def ternary_decode_gemm_fused(packed, x, a_scale, w_scale, *, g: int,
                              out_dtype=torch.float32) -> torch.Tensor:
    """packed (M, KG) uint8 × x (N, KG*g) float → (N, M) out_dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    add one to ``ternary_decode_gemm_fused.launches``) or raise."""
    check_fused_args(packed, x, a_scale, w_scale, g, out_dtype)
    if x.device.type == "cpu":
        return ternary_decode_gemm_fused_plain(
            packed, x, a_scale, w_scale, g=g, out_dtype=out_dtype)
    if x.device.type != "cuda" or x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"the CUDA kernel takes f32/bf16 CUDA tensors, got "
                         f"{x.dtype} on {x.device}")
    out = torch.empty((x.shape[0], packed.shape[0]), dtype=out_dtype, device=x.device)
    if out.numel() == 0 or packed.shape[1] == 0:
        return out.zero_()
    _build.launch_mpgemm("ternary_decode_gemm_fused", packed, x, a_scale, w_scale, g, out)
    ternary_decode_gemm_fused.launches += 1
    return out


ternary_decode_gemm_fused.launches = 0


def ternary_decode_gemm_plain(packed, a_r, *, g: int) -> torch.Tensor:
    """Plain version of the integer kernel: decode the trits and take the
    exact integer product W (M, K) · A_q (K, N) as one f32 matmul of exact
    integers → (M, N) int32."""
    _, kg, n = a_r.shape
    check_f32_exact(kg * g)
    a_q = a_r.permute(1, 0, 2).reshape(kg * g, n).to(torch.float32)   # (K, N)
    w = unpack_ternary(packed, g).to(torch.float32)                  # (M, K)
    return (w @ a_q).to(torch.int32)


def ternary_decode_gemm(packed, a_r, *, g: int) -> torch.Tensor:
    """packed (M, KG) uint8 × a_r (g, KG, N) int8 → (M, N) int32, exact.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    add one to ``ternary_decode_gemm.launches``) or raise."""
    check_int_args(packed, a_r, g)
    if a_r.device.type == "cpu":
        return ternary_decode_gemm_plain(packed, a_r, g=g)
    if a_r.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {a_r.device}")
    out = torch.empty((packed.shape[0], a_r.shape[2]), dtype=torch.int32, device=a_r.device)
    if out.numel() == 0 or packed.shape[1] == 0:
        return out.zero_()
    _build.launch_mpgemm_int("ternary_decode_gemm", packed, a_r, g, out)
    ternary_decode_gemm.launches += 1
    return out


ternary_decode_gemm.launches = 0
