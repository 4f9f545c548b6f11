"""Baseline mpGeMM methods the paper compares against (§2.2, §5.1), ported
from `repro.core.baselines`. Plain PyTorch reference code, not kernels.

* scalar_lut_gemm  — T-MAC-style scalar LUT: one table *per token*, N×
  repeated 1→1 lookups (paper Fig. 1(b-1)), with the per-token
  feature-major table layout — the memory-access pattern the paper
  diagnoses. The JAX vmap over tokens is a batch dimension here, taken in
  chunks of tokens to bound the gather's memory.
* mad_gemm         — llama.cpp-style MAD: dequantize the packed weights to a
  dense matrix at use time, then multiply-add (paper §2.2.1).
* mad_gemm_int8    — bitnet.cpp-style int8 MAD: unpacked int8 weights ×
  int8 activations → int32 through `torch._int_mm`, zero-padded to its
  shape rules (exact).

The integer methods quantize with `act_quant_tokens`, which for f32
activations gives the bits of the JAX baselines' own jitted quantizer.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .packing import PackedWeight
from .quantize import act_quant_tokens
from .vlut import sign_matrix_on, vlut_gemm

#: elements of the (tokens, M, K/g) gather one scalar-LUT chunk materializes
_SCALAR_CHUNK = 1 << 24


def _w_scale(pw: PackedWeight) -> torch.Tensor:
    return pw.scale.expand(pw.M)


def _segment_scalar(packed: torch.Tensor, a_q: torch.Tensor, g: int) -> torch.Tensor:
    """N independent tables + N independent lookup passes (the 1→1
    paradigm). packed (M, Kg), a_q (K, N) int8 → (M, N) int32."""
    m, kg = packed.shape
    n = a_q.shape[1]
    s = sign_matrix_on(g, a_q.device).to(torch.float32)             # (3^g, g)
    # each token's own feature-major table T_n (Kg, 3^g)
    a_grp = a_q.T.reshape(n, kg, g).to(torch.float32)               # (N, Kg, g)
    tables = (a_grp @ s.T).to(torch.int16)                          # (N, Kg, 3^g)
    ks = torch.arange(kg, device=a_q.device)[None, :]
    codes = packed.to(torch.long)
    out = torch.empty((m, n), dtype=torch.int32, device=a_q.device)
    step = max(1, _SCALAR_CHUNK // max(1, m * kg))
    for n0 in range(0, n, step):
        vals = tables[n0:n0 + step][:, ks, codes]                   # (c, M, Kg): 1→1 lookups
        out[:, n0:n0 + step] = vals.sum(-1, dtype=torch.int32).T
    return out


def scalar_lut_gemm(pw: PackedWeight, a: torch.Tensor) -> torch.Tensor:
    """T-MAC-style scalar-LUT mpGeMM. a: (K, N) float → (M, N) f32."""
    a_q, a_scale = act_quant_tokens(a)
    out = torch.zeros((pw.M, a.shape[1]), dtype=torch.int32, device=a.device)
    if pw.packed5.shape[-1]:
        out += _segment_scalar(pw.packed5, a_q[:pw.k5], 5)
    if pw.packed4.shape[-1]:
        out += _segment_scalar(pw.packed4, a_q[pw.k5:], 4)
    return out.to(torch.float32) * _w_scale(pw)[:, None] * a_scale[None, :]


def mad_gemm(pw: PackedWeight, a: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
    """MAD-based mpGeMM: unpack → dequantize → dense multiply-add (llama.cpp
    TQ1_0/TQ2_0 analogue). a: (K, N) float → (M, N) f32."""
    w = pw.unpack().to(compute_dtype) * _w_scale(pw)[:, None].to(compute_dtype)
    return (w @ a.to(compute_dtype)).to(torch.float32)


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def int_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (N, K) int8 · w (M, K) int8 ᵀ → (N, M) int32 through
    `torch._int_mm`, zero-padded to its shape rules (more than 16 rows of
    a, K and M multiples of 8): zero rows and columns add nothing, so the
    result is exact."""
    n, k = a.shape
    m = w.shape[0]
    n_p, k_p, m_p = max(n, 17), _round_up(k, 8), _round_up(m, 8)
    if (n_p, k_p) != (n, k):
        a = F.pad(a, (0, k_p - k, 0, n_p - n))
    if (m_p, k_p) != (m, k):
        w = F.pad(w, (0, k_p - k, 0, m_p - m))
    return torch._int_mm(a.contiguous(), w.contiguous().T)[:n, :m]


def mad_gemm_int8(pw: PackedWeight, a: torch.Tensor) -> torch.Tensor:
    """MAD with int8 activations and int8 ternary weights (bitnet.cpp I2_S
    analogue): unpack (no dequant) then int8×int8→int32 dot."""
    a_q, a_scale = act_quant_tokens(a)
    out = int_mm(a_q.T, pw.unpack()).T                               # (M, N) int32
    return out.to(torch.float32) * _w_scale(pw)[:, None] * a_scale[None, :]


def dense_gemm_f32(w: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Unquantized dense GEMM (upper-accuracy reference)."""
    return w.to(torch.float32) @ a.to(torch.float32)


def lut_gemm_auto(pw: PackedWeight, a: torch.Tensor, n_switch: int = 8) -> torch.Tensor:
    """Paper §6.3: switch between scalar and vector LUT by parallel-token
    count — scalar-LUT below `n_switch` tokens, vector-LUT from there."""
    if a.shape[1] < n_switch:
        return scalar_lut_gemm(pw, a)
    return vlut_gemm(pw, a)
