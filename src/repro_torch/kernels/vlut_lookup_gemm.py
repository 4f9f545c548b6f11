"""Vector-LUT mpGeMM (the paper's kernel): the fused kernel and its integer
twin, each with its CUDA kernel's wrapper, its plain PyTorch version and its
launch count.

Ports of the TPU kernels `vlut_lookup_gemm_fused` and `vlut_lookup_gemm`
(src/repro/kernels/vlut_lookup_gemm.py). The CUDA source of both is
``csrc/vlut_lookup_gemm.cu``. Same argument contracts as
`ternary_decode_gemm.ternary_decode_gemm_fused` and
`ternary_decode_gemm.ternary_decode_gemm`. The TPU integer kernel's
``lookup`` choice ("onehot" or "serial") is two TPU lowerings of one row
select with equal integers; the port has one, the gather.
"""
from __future__ import annotations

import torch

from repro_torch.core.vlut import sign_matrix_on

from . import _build
from .ternary_decode_gemm import (
    _KERNEL_DTYPES,
    check_fused_args,
    check_int_args,
    epilogue,
    launch_int,
    quantize_tokens,
)

#: elements of the (N, M, kg-chunk) gather the plain version materializes
_GATHER_CHUNK = 1 << 24


def _lut_gather_int(q: torch.Tensor, packed: torch.Tensor, g: int) -> torch.Tensor:
    """The shared core: q (N, KG, g) exact int8 values in f32 → (N, M) int32.

    Build the unified table T[n, kg, e] = S[e] · q[n, kg] for every trit
    pattern e, then the literal gather: each code W[m, kg] fetches
    T[:, kg, W[m, kg]], accumulated in int32. The table entries are exact
    small integers (|T| <= 5*127), computed as an f32 product of integers
    and stored as int16, as in the kernels."""
    n = q.shape[0]
    m, kg = packed.shape
    # built on the device: no host copy while the stream is busy
    s = sign_matrix_on(g, q.device).to(torch.float32)                # (3^g, g)
    table = (q @ s.T).to(torch.int16)                                # (N, KG, 3^g)
    codes = packed.to(torch.long)
    acc = torch.zeros((n, m), dtype=torch.int32, device=q.device)
    step = max(1, _GATHER_CHUNK // max(1, n * m))
    for k0 in range(0, kg, step):
        k1 = min(kg, k0 + step)
        cols = torch.arange(k1 - k0, device=q.device)[None, :]
        rows = table[:, k0:k1][:, cols, codes[:, k0:k1]]            # (N, M, c)
        acc += rows.sum(-1, dtype=torch.int32)
    return acc


def vlut_lookup_gemm_fused_plain(packed, x, a_scale, w_scale, *, g: int,
                                 out_dtype=torch.float32) -> torch.Tensor:
    """Plain version: quantize, the table gather of `_lut_gather_int`, then
    the f32 epilogue."""
    n = x.shape[0]
    q = quantize_tokens(x, a_scale).reshape(n, packed.shape[1], g)
    return epilogue(_lut_gather_int(q, packed, g), w_scale, a_scale, out_dtype)


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


def vlut_lookup_gemm_plain(packed, a_r, *, g: int) -> torch.Tensor:
    """Plain version of the integer kernel: the table gather of
    `_lut_gather_int` on a_r (g, KG, N) int8 → (M, N) int32."""
    q = a_r.permute(2, 1, 0).to(torch.float32)                       # (N, KG, g)
    return _lut_gather_int(q, packed, g).T.contiguous()


def vlut_lookup_gemm(packed, a_r, *, g: int) -> torch.Tensor:
    """packed (M, KG) uint8 × a_r (g, KG, N) int8 → (M, N) int32, exact.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    add one to ``vlut_lookup_gemm.launches``) or raise."""
    check_int_args(packed, a_r, g)
    if a_r.device.type == "cpu":
        return vlut_lookup_gemm_plain(packed, a_r, g=g)
    return launch_int("vlut_lookup_gemm", vlut_lookup_gemm, packed, a_r, g)


vlut_lookup_gemm.launches = 0
