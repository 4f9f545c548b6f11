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

`lut_plan` is the kernels' launch plan: rows per block, K-splits and the
K-groups of each shared-memory chunk, chosen on the host from (M, KG, N, g)
so that the grid fills the card; the split-K sums meet in a zeroed int32
workspace that the wrappers own (`_splitk.launch_args`, shared with the
decode kernels).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core.vlut import sign_matrix_on

from . import _build, _splitk
from .ternary_decode_gemm import (
    _KERNEL_DTYPES,
    check_fused_args,
    check_int_args,
    epilogue,
    quantize_tokens,
)

#: elements of the (N, M, kg-chunk) gather the plain version materializes
_GATHER_CHUNK = 1 << 24

# The launch plan's constants (the kernel's are in csrc/vlut_lookup_gemm.cu)
WAVE = 132                  # SMs of an H100: blocks in one wave
BN = 16                     # tokens per block tile
BM_UNIT = 128               # rows per block are a multiple of this
#: most rows per block: 256 up to 64 tokens, then 512 (the better of the
#: plans timed on the card at smollm-360m's shapes). A thread keeps
#: BM * token lanes / 256 rows of 4 sums in registers (at most 8 rows)
BM_MAX = ((64, 256), (None, 512))
#: dynamic shared memory a plan aims for: two blocks fit on one SM (of the
#: 227 KB a block may take)
SMEM_BUDGET = 110 * 1024


def tok_lanes(nv: int) -> int:
    """Token lanes of a tile with `nv` valid tokens (4 tokens each)."""
    return 1 if nv <= 4 else (2 if nv <= 8 else 4)


def _round16(x: int) -> int:
    return (x + 15) // 16 * 16


def lut_smem_bytes(g: int, bm: int, chunk: int, bnt: int) -> int:
    """Dynamic shared memory of one block, as `lut_layout` in the kernel
    computes it: the table [chunk][3^g][bnt] int16, the int8 activations
    [chunk*g][bnt] and the codes [chunk/4][bm] in 32-bit words of 4 K-groups."""
    return (_round16(chunk * 3 ** g * bnt * 2) + _round16(chunk * g * bnt)
            + _round16(bm * -(-chunk // 4) * 4))


@dataclasses.dataclass(frozen=True)
class LutPlan:
    """The launch of one vector-LUT kernel call: block (x, y, z) owns rows
    `rows(x)`, tokens `tokens(y)` and K-groups `kgroups(z)`, and builds its
    table `chunk` K-groups at a time."""
    m: int
    kg: int
    n: int
    g: int
    bm: int
    splits: int
    chunk: int
    smem: int

    @property
    def m_tiles(self) -> int:
        return -(-self.m // self.bm)

    @property
    def n_tiles(self) -> int:
        return -(-self.n // BN)

    @property
    def blocks(self) -> int:
        return self.m_tiles * self.n_tiles * self.splits

    def rows(self, x: int) -> tuple[int, int]:
        return x * self.bm, min(self.m, (x + 1) * self.bm)

    def tokens(self, y: int) -> tuple[int, int]:
        return y * BN, min(self.n, (y + 1) * BN)

    def kgroups(self, z: int) -> tuple[int, int]:
        return _split_bound(z, self.kg, self.splits), _split_bound(z + 1, self.kg, self.splits)


def _split_bound(z: int, kg: int, splits: int) -> int:
    """First K-group of split z: z*KG/S, rounded down to a multiple of 4
    where KG % 4 == 0 and S <= KG/4, so a chunk's codes start on a 32-bit
    word (`split_bound` in the kernel)."""
    b = z * kg // splits
    return b & ~3 if kg % 4 == 0 and 4 * splits <= kg else b


@functools.lru_cache(maxsize=4096)
def lut_plan(m: int, kg: int, n: int, g: int) -> LutPlan:
    """The launch of one call, from its shape (cached: the serving path asks
    for the same few shapes at every step):

    - BM: `BM_MAX` for this many tokens, or M rounded up to 128 rows;
    - S = 1 where M-tiles × token tiles fill a wave (132 blocks); else the
      most splits that keep the grid within two waves (S ≤ KG);
    - chunk: the K-groups one block's shared memory holds within
      `SMEM_BUDGET` (a multiple of 4 where the splits are aligned), at
      most the longest K-slice.

    The kernel's chunk loop walks a longer K-slice chunk by chunk."""
    bnt = 4 * tok_lanes(min(n, BN))
    cap = next(bm for most, bm in BM_MAX if most is None or n <= most)
    bm = min(cap, -(-m // BM_UNIT) * BM_UNIT)
    tiles = -(-m // bm) * -(-n // BN)
    fit = max(1, (SMEM_BUDGET - 48) // (3 ** g * bnt * 2 + g * bnt + bm))
    splits = 1 if tiles >= WAVE else min(kg, 2 * WAVE // tiles)
    longest = max(_split_bound(z + 1, kg, splits) - _split_bound(z, kg, splits)
                  for z in range(splits))
    chunk = min(longest, fit)
    if chunk > 4 and kg % 4 == 0 and 4 * splits <= kg:
        chunk -= chunk % 4
    while chunk > 1 and lut_smem_bytes(g, bm, chunk, bnt) > SMEM_BUDGET:
        chunk -= 1
    return LutPlan(m, kg, n, g, bm, splits, chunk, lut_smem_bytes(g, bm, chunk, bnt))


def _launch_args(plan: LutPlan, device: torch.device):
    return _splitk.launch_args(plan, device)


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
    plan = lut_plan(*packed.shape, x.shape[0], g)
    _build.launch_lut(packed, x, a_scale, w_scale, g, out, plan, *_launch_args(plan, x.device))
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
    if a_r.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {a_r.device}")
    out = torch.empty((packed.shape[0], a_r.shape[2]), dtype=torch.int32, device=a_r.device)
    if out.numel() == 0 or packed.shape[1] == 0:
        return out.zero_()
    plan = lut_plan(*packed.shape, a_r.shape[2], g)
    _build.launch_lut_int(packed, a_r, g, out, plan, *_launch_args(plan, a_r.device))
    vlut_lookup_gemm.launches += 1
    return out


vlut_lookup_gemm.launches = 0
