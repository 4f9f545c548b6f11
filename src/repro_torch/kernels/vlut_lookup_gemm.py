"""Fused vector-LUT mpGeMM (the paper's kernel): the CUDA kernel's wrapper,
its plain PyTorch version and its launch count.

Port of the TPU kernel `vlut_lookup_gemm_fused`
(src/repro/kernels/vlut_lookup_gemm.py). The CUDA source is
``csrc/vlut_lookup_gemm.cu``. Same argument contract as
`ternary_decode_gemm.ternary_decode_gemm_fused`.
"""
from __future__ import annotations

import torch

from repro_torch.core.packing import unpack_ternary

from . import _build
from .ternary_decode_gemm import _KERNEL_DTYPES, check_fused_args, epilogue, quantize_tokens

#: elements of the (N, M, kg-chunk) gather the plain version materializes
_GATHER_CHUNK = 1 << 24


def vlut_lookup_gemm_fused_plain(packed, x, a_scale, w_scale, *, g: int,
                                 out_dtype=torch.float32) -> torch.Tensor:
    """Plain version: build the unified table T[n, kg, e] = S[e] · A_q[n, kg]
    for every trit pattern e, then the literal gather: each code W[m, kg]
    fetches T[:, kg, W[m, kg]], accumulated in int32.

    The table entries are exact small integers (|T| <= 5*127), computed as
    an f32 product of integers and stored as int16, as in the kernel."""
    n, _ = x.shape
    m, kg = packed.shape
    q = quantize_tokens(x, a_scale).reshape(n, kg, g)
    # the sign-enumeration matrix S (3^g, g): row e holds the trits of code
    # e, built on the device (no host copy while the stream is busy)
    codes_all = torch.arange(3 ** g, device=x.device, dtype=torch.uint8)[:, None]
    s = unpack_ternary(codes_all, g).to(torch.float32)
    table = (q @ s.T).to(torch.int16)                                # (N, KG, 3^g)
    codes = packed.to(torch.long)
    acc = torch.zeros((n, m), dtype=torch.int32, device=x.device)
    step = max(1, _GATHER_CHUNK // max(1, n * m))
    for k0 in range(0, kg, step):
        k1 = min(kg, k0 + step)
        cols = torch.arange(k1 - k0, device=x.device)[None, :]
        rows = table[:, k0:k1][:, cols, codes[:, k0:k1]]            # (N, M, c)
        acc += rows.sum(-1, dtype=torch.int32)
    return epilogue(acc, w_scale, a_scale, out_dtype)


def vlut_lookup_gemm_fused(packed, x, a_scale, w_scale, *, g: int,
                           out_dtype=torch.float32) -> torch.Tensor:
    """packed (M, KG) uint8 × x (N, KG*g) float → (N, M) out_dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    add one to ``vlut_lookup_gemm_fused.launches``) or raise."""
    check_fused_args(packed, x, a_scale, w_scale, g, out_dtype)
    if x.device.type == "cpu":
        return vlut_lookup_gemm_fused_plain(
            packed, x, a_scale, w_scale, g=g, out_dtype=out_dtype)
    if x.device.type != "cuda" or x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"the CUDA kernel takes f32/bf16 CUDA tensors, got "
                         f"{x.dtype} on {x.device}")
    out = torch.empty((x.shape[0], packed.shape[0]), dtype=out_dtype, device=x.device)
    if out.numel() == 0 or packed.shape[1] == 0:
        return out.zero_()
    _build.launch_mpgemm("vlut_lookup_gemm_fused", packed, x, a_scale, w_scale, g, out)
    vlut_lookup_gemm_fused.launches += 1
    return out


vlut_lookup_gemm_fused.launches = 0
