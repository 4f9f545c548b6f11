"""Ternary-decode mpGeMM: the fused kernel and its integer twin, each with
its CUDA kernel's wrapper, its plain PyTorch version and its launch count.

Ports of the TPU kernels `ternary_decode_gemm_fused` and
`ternary_decode_gemm` (src/repro/kernels/ternary_decode_gemm.py). The CUDA
source of both is ``csrc/ternary_decode_gemm.cu``: one int8 tensor-core
product per trit, as the TPU kernel's MXU core. Unlike the TPU wrapper,
the fused one reads the activations in the token-major (N, K) layout the
model produces and writes (N, M): no transposes, no padding. The integer
one keeps the TPU contract, pre-quantized de-interleaved int8 a_r
(g, KG, N) → int32 (M, N), and pads nothing either.

`decode_plan` is the kernels' launch plan: the block's rows and tokens,
the K-splits and the K-groups per step, chosen on the host from
(M, KG, N, g) so that the grid fills the card, and the alignment claims
that allow word loads. The split-K sums meet in the zeroed int32 workspace
both mpGeMM templates share (`_splitk`).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core.packing import unpack_ternary
from repro_torch.core.quantize import Q_MAX

from . import _build, _splitk

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)

# The launch plan's constants (the kernel's are in csrc/ternary_decode_gemm.cu)
WAVE = 132                  # SMs of an H100: blocks in one wave
SUB = 32                    # K-groups of one k32 tensor-core product
MAX_STEP = 64               # K-groups staged per step, at most
#: (most tokens, rows BM, tokens BN) of a block, one m16 tile per warp and
#: two n8 tiles: 4 warps at decode N; 8 warps at prefill N, so that each
#: quantized activation tile feeds twice the rows (32 or 64 tokens a block
#: timed slower on the card at smollm-360m's shapes)
TILES = ((16, 64, 16), (None, 128, 16))


def row_bytes(kstep: int) -> int:
    """Shared bytes of one (trit, token) row of a step (`decode_row_bytes`
    in the kernel): 8 or 24 words modulo 32, so that a half-warp's 8-byte
    B loads fall on distinct bank pairs."""
    return kstep + 32 if kstep % 64 == 0 else kstep


def decode_smem_bytes(g: int, bn: int, kstep: int) -> int:
    """Dynamic shared memory of one block: the step's int8 activations
    [g][bn][row_bytes(kstep)]."""
    return g * bn * row_bytes(kstep)


def _split_bound(z: int, kg: int, splits: int) -> int:
    """First K-group of split z: z*KG/S rounded down to a multiple of 32
    where 32*S <= KG, else of 4 where KG % 4 == 0 and 4*S <= KG; split S
    ends at KG (`split_bound` in the kernel)."""
    if z >= splits:
        return kg
    b = z * kg // splits
    a = 32 if 32 * splits <= kg else (4 if kg % 4 == 0 and 4 * splits <= kg else 1)
    return b - b % a


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """The launch of one decode-kernel call: block (x, y, z) owns rows
    `rows(x)`, tokens `tokens(y)` and K-groups `kgroups(z)`, which it walks
    `kstep` K-groups at a time. `codes_aligned`: the codes are read as
    32-bit words; `acts_aligned`: the activations as 16-byte (f32), 8-byte
    (bf16) or 4-byte (a_r) vectors."""
    m: int
    kg: int
    n: int
    g: int
    bm: int
    bn: int
    splits: int
    kstep: int
    codes_aligned: bool
    acts_aligned: bool
    smem: int

    @property
    def m_tiles(self) -> int:
        return -(-self.m // self.bm)

    @property
    def n_tiles(self) -> int:
        return -(-self.n // self.bn)

    @property
    def blocks(self) -> int:
        return self.m_tiles * self.n_tiles * self.splits

    def rows(self, x: int) -> tuple[int, int]:
        return x * self.bm, min(self.m, (x + 1) * self.bm)

    def tokens(self, y: int) -> tuple[int, int]:
        return y * self.bn, min(self.n, (y + 1) * self.bn)

    def kgroups(self, z: int) -> tuple[int, int]:
        return _split_bound(z, self.kg, self.splits), _split_bound(z + 1, self.kg, self.splits)

    def steps(self, z: int) -> list[tuple[int, int]]:
        """The K-groups of each step of split z."""
        lo, hi = self.kgroups(z)
        return [(k, min(hi, k + self.kstep)) for k in range(lo, hi, self.kstep)]


@functools.lru_cache(maxsize=4096)
def decode_plan(m: int, kg: int, n: int, g: int, *, codes_aligned: bool = False,
                acts_aligned: bool = False) -> DecodePlan:
    """The launch of one call, from its shape and alignment claims (cached:
    the serving path asks for the same few shapes at every step):

    - BM x BN: `TILES` for this many tokens;
    - S = 1 where M-tiles × token tiles fill a wave (132 blocks); else the
      most splits that keep the grid within two waves, at most KG (KG/4
      where KG % 4 == 0, so that every K-slice starts on a code word);
    - K-groups per step: 32, or 64 where a K-slice is longer than 32.

    The alignment claims come from `fused_aligned` / `int_aligned`; the
    default claims none (byte and element loads)."""
    bm, bn = next((bm, bn) for most, bm, bn in TILES if most is None or n <= most)
    tiles = -(-m // bm) * -(-n // bn)
    cap = kg // 4 if kg % 4 == 0 else kg
    splits = 1 if tiles >= WAVE else max(1, min(cap, 2 * WAVE // tiles))
    longest = max(_split_bound(z + 1, kg, splits) - _split_bound(z, kg, splits)
                  for z in range(splits))
    kstep = SUB if longest <= SUB else MAX_STEP
    return DecodePlan(m, kg, n, g, bm, bn, splits, kstep, codes_aligned, acts_aligned,
                      decode_smem_bytes(g, bn, kstep))


def fused_aligned(packed: torch.Tensor, x: torch.Tensor) -> tuple[bool, bool]:
    """The fused kernel's alignment claims: codes as words where KG % 4 == 0
    and the codes' base is 4-byte aligned; activations as 4-element vectors
    where, besides KG % 4 == 0 (every K-slice then starts on a multiple of
    4 features), x's row stride is a multiple of 4 elements and its base is
    aligned to 4 elements. The K = 964 weight's one-K-group g=4 segment and
    its `x[:, 960:964]` slice claim neither."""
    kg = packed.shape[1]
    codes = kg % 4 == 0 and packed.data_ptr() % 4 == 0
    acts = (kg % 4 == 0 and x.stride(0) % 4 == 0
            and x.data_ptr() % (4 * x.element_size()) == 0)
    return codes, acts


def int_aligned(packed: torch.Tensor, a_r: torch.Tensor) -> tuple[bool, bool]:
    """The integer kernel's alignment claims: codes as for `fused_aligned`;
    a_r in 4-byte words of 4 tokens where KG % 4 == 0, N % 4 == 0 and a_r's
    base is 4-byte aligned."""
    kg = packed.shape[1]
    codes = kg % 4 == 0 and packed.data_ptr() % 4 == 0
    acts = kg % 4 == 0 and a_r.shape[2] % 4 == 0 and a_r.data_ptr() % 4 == 0
    return codes, acts


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
    codes, acts = fused_aligned(packed, x)
    plan = decode_plan(*packed.shape, x.shape[0], g, codes_aligned=codes, acts_aligned=acts)
    _build.launch_decode(packed, x, a_scale, w_scale, g, out, plan,
                         *_splitk.launch_args(plan, x.device))
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
    codes, acts = int_aligned(packed, a_r)
    plan = decode_plan(*packed.shape, a_r.shape[2], g, codes_aligned=codes, acts_aligned=acts)
    _build.launch_decode_int(packed, a_r, g, out, plan, *_splitk.launch_args(plan, a_r.device))
    ternary_decode_gemm.launches += 1
    return out


ternary_decode_gemm.launches = 0
