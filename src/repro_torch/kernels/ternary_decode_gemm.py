"""Ternary-decode mpGeMM: the fused kernel and its integer twin, each also
in a grouped form (E experts of one shape in one launch), each with its
CUDA kernel's wrapper, its plain PyTorch version and its launch count.

Ports of the TPU kernels `ternary_decode_gemm_fused` and
`ternary_decode_gemm` (src/repro/kernels/ternary_decode_gemm.py). The CUDA
source of both is ``csrc/ternary_decode_gemm.cu``: one int8 tensor-core
product per trit, as the TPU kernel's MXU core. Unlike the TPU wrapper,
the fused one reads the activations in the token-major (N, K) layout the
model produces and writes (N, M): no transposes, no padding. The integer
one keeps the TPU contract, pre-quantized de-interleaved int8 a_r
(g, KG, N) → int32 (M, N), and pads nothing either.

`decode_plan` is the single kernels' launch plan: the block's rows and
tokens, the K-splits and the K-groups per step, chosen on the host from
(M, KG, N, g) so that the grid fills the card, and the alignment claims
that allow word loads. The grouped entries have their own kernel and plan
(`grouped_decode_plan`: rows a block, K-splits, experts a block). The
split-K sums meet in the zeroed int32 workspace both mpGeMM templates
share (`_splitk`).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core.packing import unpack_ternary
from repro_torch.core.quantize import Q_MAX

from . import _build, _library, _splitk, autotune

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
    """The launch of one single decode-kernel call: block (x, y, z) owns
    rows `rows(x)`, tokens `tokens(y)` and K-groups `kgroups(z)`, which it
    walks `kstep` K-groups at a time. `codes_aligned`: the codes are read
    as 32-bit words; `acts_aligned`: the activations as 16-byte (f32),
    8-byte (bf16) or 4-byte (a_r) vectors."""
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
    """The launch of one single call, from its shape and alignment claims
    (cached: the serving path asks for the same few shapes at every step):

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


# The grouped plan's constants (`decode_grouped_kernel` in the kernel's source)
GROUP_THREADS = 512         # threads of a grouped block: 16 warps
GROUP_SLAB = 32             # rows of a warp's slot: two m16 tiles
GROUP_ROWS = 512            # a slab for each warp; a block's rows are a multiple
GROUP_STEP = 128            # K-groups of a slot
GROUP_BN = 16               # tokens of a token tile
GROUP_COPIES = 16           # interleaved copies of the 64-bit trit table
GROUP_SMEM_MAX = 232448 - 1024     # 227 KB less the static part
GROUP_BLOCKS_PER_SM = 1     # one grouped block an SM (shared memory)
#: the grid's share of its last wave a grouped plan aims for
WAVE_EFFICIENCY = 0.95
#: row chunks an expert's rows take at least: at a decode step a few
#: experts hold every real row, and one block an expert would leave each
#: live expert's rows to one SM
MIN_CHUNKS = 2
#: a tail block's set-up (trit table, token scales) and one expert's
#: staging, in slots of work (the tail plan's cost model)
TAIL_SETUP = 4
TAIL_STAGE = 1


def grouped_row_bytes(nk: int) -> int:
    """Shared bytes of one staged (trit, token) row of a K-slice of nk
    K-groups (`gslice_row_bytes` in the kernel): 32 more than a multiple of
    64, so that a half-warp's 8-byte B reads fall on distinct bank pairs."""
    return -(-nk // 64) * 64 + 32


def grouped_decode_smem_bytes(g: int, bn: int, nk: int) -> int:
    """Dynamic shared memory of one grouped block (`gdecode_smem_bytes` in
    the kernel): the trit table (256 8-byte entries × `GROUP_COPIES`), the
    staged activations [g][bn][grouped_row_bytes(nk)] of the longest
    K-slice nk, and each warp's slot of codes [32 rows][GROUP_STEP
    bytes]."""
    return (256 * 8 * GROUP_COPIES + g * bn * grouped_row_bytes(nk)
            + GROUP_ROWS // GROUP_SLAB * GROUP_SLAB * GROUP_STEP)


def wave_efficiency(blocks: int) -> float:
    """The grid's blocks over the slots of the waves it takes."""
    slots = WAVE * GROUP_BLOCKS_PER_SM
    return blocks / (-(-blocks // slots) * slots)


def _gsplit_bound(z: int, kg: int, splits: int) -> int:
    """First K-group of split z of a grouped plan: z*KG/S rounded down to
    a multiple of `GROUP_STEP` (S <= KG/GROUP_STEP), so every step
    starts a whole number of steps from the row's start; split S ends at
    KG (`gsplit_bound` in the kernel)."""
    return kg if z >= splits else z * kg // splits & ~(GROUP_STEP - 1)


def _longest_slice(kg: int, splits: int) -> int:
    return max(_gsplit_bound(z + 1, kg, splits) - _gsplit_bound(z, kg, splits)
               for z in range(splits))


@dataclasses.dataclass(frozen=True)
class GroupedDecodePlan:
    """The launch of one grouped decode call: block (x, y, z) owns rows
    `rows(x)`, tokens `tokens(y)` and K-groups `kgroups(z % splits)` of the
    experts `experts(z // splits)`, one after another. It stages its token
    tile's K-slice once an expert (`bn` token rows); each of its warps
    streams the codes of its 32-row slabs through its own slot,
    `GROUP_STEP` K-groups at a time."""
    m: int
    kg: int
    n: int
    g: int
    e: int
    bm: int                 # rows of a block
    splits: int
    ex: int                 # experts of a block
    bn: int                 # staged token rows: 8 (N <= 8) or 16
    smem: int

    @property
    def m_tiles(self) -> int:
        return -(-self.m // self.bm)

    @property
    def n_tiles(self) -> int:
        return -(-self.n // GROUP_BN)

    @property
    def e_groups(self) -> int:
        return -(-self.e // self.ex)

    @property
    def blocks(self) -> int:
        return self.e_groups * self.m_tiles * self.n_tiles * self.splits

    @property
    def stagings(self) -> int:
        """The times each activation is staged (quantized or transposed
        into shared memory) a launch: once per row chunk."""
        return self.m_tiles

    @property
    def packed_rows(self) -> bool:
        """A slot holds a slab's codes as one contiguous run: the
        K-slice is a whole row shorter than a step."""
        return self.splits == 1 and self.kg < GROUP_STEP

    def rows(self, x: int) -> tuple[int, int]:
        return x * self.bm, min(self.m, (x + 1) * self.bm)

    def tokens(self, y: int) -> tuple[int, int]:
        return y * GROUP_BN, min(self.n, (y + 1) * GROUP_BN)

    def kgroups(self, z: int) -> tuple[int, int]:
        return _gsplit_bound(z, self.kg, self.splits), _gsplit_bound(z + 1, self.kg, self.splits)

    def experts(self, zg: int) -> tuple[int, int]:
        return zg * self.ex, min(self.e, (zg + 1) * self.ex)


@functools.lru_cache(maxsize=4096)
def grouped_decode_plan(m: int, kg: int, n: int, g: int, e: int) -> GroupedDecodePlan:
    """The launch of one grouped call of `e` experts (the grouped kernels
    take it at any E, 1 included), from its shape:

    - a segment of one step (KG <= GROUP_STEP, the g=4 tails): no
      split; BM and `ex` experts a block such that the busiest SM does the
      least work, counted in a warp's slots (waves × (`TAIL_SETUP` +
      experts a block × (`TAIL_STAGE` + BM/512))), then the fewest blocks,
      the largest BM;
    - else the fewest blocks an (expert, token tile), row chunks (BM a
      multiple of 512, at least `MIN_CHUNKS` chunks where M allows) times
      K-splits (S <= KG/GROUP_STEP, each K-slice's staged rows within the
      shared memory), whose grid fills its last wave to `WAVE_EFFICIENCY`
      (rows before splits at a tie), or the best filled where none does."""
    bn = 8 if n <= 8 else GROUP_BN
    nt = -(-n // GROUP_BN)
    rows = -(-m // GROUP_ROWS) * GROUP_ROWS
    bms = sorted({-(-(-(-m // mt)) // GROUP_ROWS) * GROUP_ROWS
                  for mt in range(1, rows // GROUP_ROWS + 1)}, reverse=True)
    if kg <= GROUP_STEP:
        # the busiest SM's work in a warp's slots: its waves times a
        # block's set-up and, for each of its ex experts, the staging and
        # bm / 512 slots
        slots = WAVE * GROUP_BLOCKS_PER_SM
        walk = [(-(-(-(-e // ex) * nt * -(-m // bm)) // slots)
                 * (TAIL_SETUP + ex * (TAIL_STAGE + bm // GROUP_ROWS)),
                 -(-e // ex) * -(-m // bm), -bm, ex, bm)
                for ex in range(1, e + 1) for bm in bms]
        *_, ex, bm = min(walk)
        return GroupedDecodePlan(m, kg, n, g, e, bm, 1, ex, bn,
                                 grouped_decode_smem_bytes(g, bn, kg))
    cands = []
    for s in range(1, max(1, kg // GROUP_STEP) + 1):
        smem = grouped_decode_smem_bytes(g, bn, _longest_slice(kg, s))
        if smem > GROUP_SMEM_MAX:
            continue
        for bm in bms:
            if -(-m // bm) < min(MIN_CHUNKS, len(bms)):
                continue
            per = -(-m // bm) * s
            cands.append((wave_efficiency(e * nt * per), per, s, bm, smem))
    full = [c for c in cands if c[0] >= WAVE_EFFICIENCY]
    _, _, s, bm, smem = (min(full, key=lambda c: (c[1], c[2])) if full
                         else max(cands, key=lambda c: (c[0], -c[1], -c[2])))
    return GroupedDecodePlan(m, kg, n, g, e, bm, s, 1, bn, smem)


def fused_aligned(packed: torch.Tensor, x: torch.Tensor) -> tuple[bool, bool]:
    """The fused kernel's alignment claims: codes as words where KG % 4 == 0
    and the codes' base is 4-byte aligned; activations as 4-element vectors
    where, besides KG % 4 == 0 (every K-slice then starts on a multiple of
    4 features), x's row stride is a multiple of 4 elements and its base is
    aligned to 4 elements. The K = 964 weight's one-K-group g=4 segment and
    its `x[:, 960:964]` slice claim neither. (The grouped kernel's C entry
    derives its own claims from the pointers and expert strides.)"""
    kg = packed.shape[-1]
    codes = kg % 4 == 0 and packed.data_ptr() % 4 == 0
    acts = (kg % 4 == 0 and all(st % 4 == 0 for st in x.stride()[:-1])
            and x.data_ptr() % (4 * x.element_size()) == 0)
    return codes, acts


def int_aligned(packed: torch.Tensor, a_r: torch.Tensor) -> tuple[bool, bool]:
    """The integer kernel's alignment claims: codes as for `fused_aligned`;
    a_r in 4-byte words of 4 tokens where KG % 4 == 0, N % 4 == 0 and a_r's
    base is 4-byte aligned."""
    kg = packed.shape[-1]
    codes = kg % 4 == 0 and packed.data_ptr() % 4 == 0
    acts = kg % 4 == 0 and a_r.shape[-1] % 4 == 0 and a_r.data_ptr() % 4 == 0
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


def check_grouped_args(packed, x, a_scale, w_scale, g: int, out_dtype) -> None:
    """Validate the grouped fused-mpGeMM contract shared by both kernels.

    packed (E, M, KG) uint8 contiguous; x (E, C, KG*g) float with unit
    stride along K; a_scale (E, C) f32 contiguous; w_scale (E, M) or (E, 1)
    f32 contiguous; E >= 1; each expert's slices meet `check_fused_args`."""
    if packed.ndim != 3 or x.ndim != 3 or a_scale.ndim != 2 or w_scale.ndim != 2:
        raise ValueError(f"grouped operands must be stacked: packed (E, M, KG), x (E, C, K), "
                         f"a_scale (E, C), w_scale (E, M); got {tuple(packed.shape)}, "
                         f"{tuple(x.shape)}, {tuple(a_scale.shape)}, {tuple(w_scale.shape)}")
    experts = {packed.shape[0], x.shape[0], a_scale.shape[0], w_scale.shape[0]}
    if len(experts) != 1 or packed.shape[0] < 1:
        raise ValueError(f"every operand needs the same expert count >= 1, got {experts}")
    if not (packed.is_contiguous() and a_scale.is_contiguous() and w_scale.is_contiguous()):
        raise ValueError("packed, a_scale and w_scale must be contiguous")
    check_fused_args(packed[0], x[0], a_scale[0], w_scale[0], g, out_dtype)


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


def check_int_grouped_args(packed, a_r, g: int) -> None:
    """Validate the grouped integer-mpGeMM contract shared by both kernels.

    packed (E, M, KG) uint8 contiguous; a_r (E, g, KG, N) int8 contiguous;
    E >= 1; each expert's slices meet `check_int_args`."""
    if packed.ndim != 3 or a_r.ndim != 4:
        raise ValueError(f"grouped operands must be stacked: packed (E, M, KG), a_r "
                         f"(E, g, KG, N); got {tuple(packed.shape)}, {tuple(a_r.shape)}")
    if packed.shape[0] != a_r.shape[0] or packed.shape[0] < 1:
        raise ValueError(f"every operand needs the same expert count >= 1, got "
                         f"{packed.shape[0]} and {a_r.shape[0]}")
    if not (packed.is_contiguous() and a_r.is_contiguous()):
        raise ValueError("packed and a_r must be contiguous")
    check_int_args(packed[0], a_r[0], g)


def check_f32_exact(k: int) -> None:
    """The plain versions take integer dot products in f32: exact while
    every partial sum stays below 2^24, |sum| <= 127*K."""
    if 127 * k >= 2 ** 24:
        raise ValueError(f"K={k}: 127*K >= 2^24, the f32 integer dot is no longer exact")


def quantize_tokens(x: torch.Tensor, a_scale: torch.Tensor) -> torch.Tensor:
    """Per-token int8 quantization of a token-major (..., N, K) activation,
    as exact integers in f32: f32 cast first, then divide, round half to
    even, clip to +-127 — the kernels' prologue."""
    return torch.round(x.to(torch.float32) / a_scale[..., None]).clamp(-Q_MAX, Q_MAX)


def epilogue(acc: torch.Tensor, w_scale: torch.Tensor, a_scale: torch.Tensor,
             out_dtype) -> torch.Tensor:
    """(acc * w_scale[m]) * a_scale[n] in f32, then one cast — (..., N, M)
    from w_scale (..., M) or (..., 1) and a_scale (..., N)."""
    m = acc.shape[-1]
    w = w_scale.expand(*w_scale.shape[:-1], m).unsqueeze(-2)
    return ((acc.to(torch.float32) * w) * a_scale[..., None]).to(out_dtype)


def ternary_decode_gemm_fused_plain(packed, x, a_scale, w_scale, *, g: int,
                                    out_dtype=torch.float32) -> torch.Tensor:
    """Plain version: decode the trits, one f32 matmul of exact integers.
    Stacked operands (a leading expert axis, as the grouped kernel takes
    them) give one batched matmul: the plain version of both kernels."""
    check_f32_exact(x.shape[-1])
    q = quantize_tokens(x, a_scale)                                  # (..., N, K)
    w = unpack_ternary(packed, g).to(torch.float32)                  # (..., M, K)
    return epilogue(q @ w.transpose(-1, -2), w_scale, a_scale, out_dtype)


def ternary_decode_gemm_fused(packed, x, a_scale, w_scale, *, g: int,
                              out_dtype=torch.float32, plan=None) -> torch.Tensor:
    """packed (M, KG) uint8 × x (N, KG*g) float → (N, M) out_dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    add one to ``ternary_decode_gemm_fused.launches``) or raise; fake
    tensors (a trace) go through the operator
    ``repro_torch::ternary_decode_gemm_fused`` (`_library`). `plan`: a
    `DecodePlan` launched as it is; None takes `autotune.get_plan`'s."""
    check_fused_args(packed, x, a_scale, w_scale, g, out_dtype)
    if x.device.type == "cpu" and not _library.traced(x):
        return ternary_decode_gemm_fused_plain(
            packed, x, a_scale, w_scale, g=g, out_dtype=out_dtype)
    check_kernel_device(x, float_only=True)
    return _launch_fused(packed, x, a_scale, w_scale, g, out_dtype, plan)


def check_kernel_device(t: torch.Tensor, *, float_only: bool) -> None:
    """A kernel launch (or a traced one) takes CUDA tensors, f32/bf16
    activations where `float_only`."""
    if not (t.device.type == "cuda" or _library.traced(t)) or (
            float_only and t.dtype not in _KERNEL_DTYPES):
        raise ValueError(f"the CUDA kernel takes {'f32/bf16 ' if float_only else ''}CUDA "
                         f"tensors, got {t.dtype} on {t.device}")


def _fused_out(packed, x, out_dtype) -> torch.Tensor:
    """The fused kernels' (N, M) output, unwritten."""
    return x.new_empty((x.shape[0], packed.shape[0]), dtype=out_dtype)


def _launch_fused(packed, x, a_scale, w_scale, g, out_dtype, plan) -> torch.Tensor:
    """The launch half of `ternary_decode_gemm_fused` (operands checked),
    reached directly or by the operator's CUDA implementation: an empty
    product launches nothing; a traced one is one operator."""
    if x.shape[0] * packed.shape[0] == 0 or packed.shape[1] == 0:
        return _fused_out(packed, x, out_dtype).zero_()
    if _library.traced(x):
        return _FUSED_OP(packed, x, a_scale, w_scale, g, out_dtype, _library.plan_fields(plan))
    out = _fused_out(packed, x, out_dtype)
    if plan is None:
        codes, acts = fused_aligned(packed, x)
        plan = autotune.get_plan("decode", g, *packed.shape, x.shape[0], device=x.device,
                                 codes_aligned=codes, acts_aligned=acts)
    _build.launch_decode(packed, x, a_scale, w_scale, g, out, plan,
                         *_splitk.launch_args(plan, x.device))
    ternary_decode_gemm_fused.launches += 1
    return out


_build.counts_launches(ternary_decode_gemm_fused, ("decode_kernel",))
_FUSED_SCHEMA = ("(Tensor packed, Tensor x, Tensor a_scale, Tensor w_scale, int g, "
                 "ScalarType out_dtype, int[]? plan=None) -> Tensor")
_FUSED_OP = _library.define(
    "ternary_decode_gemm_fused", _FUSED_SCHEMA,
    cpu=lambda packed, x, a_scale, w_scale, g, out_dtype, plan=None:
        ternary_decode_gemm_fused_plain(packed, x, a_scale, w_scale, g=g, out_dtype=out_dtype),
    cuda=lambda packed, x, a_scale, w_scale, g, out_dtype, plan=None: _launch_fused(
        packed, x, a_scale, w_scale, g, out_dtype, _library.plan_from(DecodePlan, plan)),
    fake=lambda packed, x, a_scale, w_scale, g, out_dtype, plan=None:
        _fused_out(packed, x, out_dtype))


def ternary_decode_gemm_fused_grouped(packed, x, a_scale, w_scale, *, g: int,
                                      out_dtype=torch.float32, plan=None) -> torch.Tensor:
    """E products of one shape in one launch: packed (E, M, KG) uint8 × x
    (E, C, KG*g) float → (E, C, M) out_dtype, expert e bit for bit
    `ternary_decode_gemm_fused(packed[e], x[e], a_scale[e], w_scale[e])`.
    The counterpart of the TPU kernel under `jax.vmap` over stacked expert
    weights (the MoE layers' `linear_batched_apply`).

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    add one to ``ternary_decode_gemm_fused_grouped.launches``) or raise;
    fake tensors go through the operator of the same name.
    `plan`: a `GroupedDecodePlan` launched as it is; None takes
    `autotune.get_plan`'s."""
    check_grouped_args(packed, x, a_scale, w_scale, g, out_dtype)
    if x.device.type == "cpu" and not _library.traced(x):
        return ternary_decode_gemm_fused_plain(
            packed, x, a_scale, w_scale, g=g, out_dtype=out_dtype)
    check_kernel_device(x, float_only=True)
    return _launch_fused_grouped(packed, x, a_scale, w_scale, g, out_dtype, plan)


def _grouped_out(packed, x, out_dtype) -> torch.Tensor:
    """The grouped fused kernels' (E, C, M) output, unwritten."""
    return x.new_empty((packed.shape[0], x.shape[1], packed.shape[1]), dtype=out_dtype)


def _launch_fused_grouped(packed, x, a_scale, w_scale, g, out_dtype, plan) -> torch.Tensor:
    """The launch half of `ternary_decode_gemm_fused_grouped` (as
    `_launch_fused`)."""
    e, m, kg = packed.shape
    if e * x.shape[1] * m == 0 or kg == 0:
        return _grouped_out(packed, x, out_dtype).zero_()
    if _library.traced(x):
        return _FUSED_GROUPED_OP(packed, x, a_scale, w_scale, g, out_dtype,
                                 _library.plan_fields(plan))
    out = _grouped_out(packed, x, out_dtype)
    if plan is None:
        plan = autotune.get_plan("decode_grouped", g, m, kg, x.shape[1], e=e, device=x.device)
    _build.launch_decode_grouped(packed, x, a_scale, w_scale, g, out, plan,
                                 *_splitk.launch_args(plan, x.device))
    ternary_decode_gemm_fused_grouped.launches += 1
    return out


_build.counts_launches(ternary_decode_gemm_fused_grouped, ("decode_grouped_kernel",))
_FUSED_GROUPED_OP = _library.define(
    "ternary_decode_gemm_fused_grouped", _FUSED_SCHEMA,
    cpu=lambda packed, x, a_scale, w_scale, g, out_dtype, plan=None:
        ternary_decode_gemm_fused_plain(packed, x, a_scale, w_scale, g=g, out_dtype=out_dtype),
    cuda=lambda packed, x, a_scale, w_scale, g, out_dtype, plan=None: _launch_fused_grouped(
        packed, x, a_scale, w_scale, g, out_dtype, _library.plan_from(GroupedDecodePlan, plan)),
    fake=lambda packed, x, a_scale, w_scale, g, out_dtype, plan=None:
        _grouped_out(packed, x, out_dtype))


def ternary_decode_gemm_plain(packed, a_r, *, g: int) -> torch.Tensor:
    """Plain version of the integer kernel: decode the trits and take the
    exact integer product W (M, K) · A_q (K, N) as one f32 matmul of exact
    integers → (M, N) int32. Stacked operands (a leading expert axis, as
    the grouped kernel takes them) give one batched matmul: the plain
    version of both kernels."""
    *lead, _, kg, n = a_r.shape
    check_f32_exact(kg * g)
    a_q = a_r.transpose(-3, -2).reshape(*lead, kg * g, n).to(torch.float32)   # (..., K, N)
    w = unpack_ternary(packed, g).to(torch.float32)                  # (..., M, K)
    return (w @ a_q).to(torch.int32)


def ternary_decode_gemm(packed, a_r, *, g: int, plan=None) -> torch.Tensor:
    """packed (M, KG) uint8 × a_r (g, KG, N) int8 → (M, N) int32, exact.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    add one to ``ternary_decode_gemm.launches``) or raise; fake
    tensors go through the operator of the same name. `plan`: a
    `DecodePlan` launched as it is; None takes `autotune.get_plan`'s."""
    check_int_args(packed, a_r, g)
    if a_r.device.type == "cpu" and not _library.traced(a_r):
        return ternary_decode_gemm_plain(packed, a_r, g=g)
    check_kernel_device(a_r, float_only=False)
    return _launch_int(packed, a_r, g, plan)


def _int_out(packed, a_r) -> torch.Tensor:
    """The integer kernels' (..., M, N) int32 output, unwritten (a leading
    expert axis for the grouped kernels)."""
    return a_r.new_empty((*packed.shape[:-1], a_r.shape[-1]), dtype=torch.int32)


def _launch_int(packed, a_r, g, plan) -> torch.Tensor:
    """The launch half of `ternary_decode_gemm` (as `_launch_fused`)."""
    if packed.shape[0] * a_r.shape[2] == 0 or packed.shape[1] == 0:
        return _int_out(packed, a_r).zero_()
    if _library.traced(a_r):
        return _INT_OP(packed, a_r, g, _library.plan_fields(plan))
    out = _int_out(packed, a_r)
    if plan is None:
        codes, acts = int_aligned(packed, a_r)
        plan = autotune.get_plan("decode", g, *packed.shape, a_r.shape[2], fused=False,
                                 device=a_r.device, codes_aligned=codes, acts_aligned=acts)
    _build.launch_decode_int(packed, a_r, g, out, plan, *_splitk.launch_args(plan, a_r.device))
    ternary_decode_gemm.launches += 1
    return out


_build.counts_launches(ternary_decode_gemm, ("decode_kernel",), int_acts=True)
_INT_SCHEMA = "(Tensor packed, Tensor a_r, int g, int[]? plan=None) -> Tensor"
_INT_OP = _library.define(
    "ternary_decode_gemm", _INT_SCHEMA,
    cpu=lambda packed, a_r, g, plan=None: ternary_decode_gemm_plain(packed, a_r, g=g),
    cuda=lambda packed, a_r, g, plan=None: _launch_int(
        packed, a_r, g, _library.plan_from(DecodePlan, plan)),
    fake=lambda packed, a_r, g, plan=None: _int_out(packed, a_r))


def ternary_decode_gemm_grouped(packed, a_r, *, g: int, plan=None) -> torch.Tensor:
    """E integer products of one shape in one launch: packed (E, M, KG)
    uint8 × a_r (E, g, KG, N) int8 → (E, M, N) int32, expert e bit for bit
    `ternary_decode_gemm(packed[e], a_r[e])`. The counterpart of the TPU
    kernel under `jax.vmap` over stacked expert weights (the MoE layers'
    unfused pipeline).

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    add one to ``ternary_decode_gemm_grouped.launches``) or raise; fake
    tensors go through the operator of the same name. `plan`: a
    `GroupedDecodePlan` launched as it is; None takes `autotune.get_plan`'s."""
    check_int_grouped_args(packed, a_r, g)
    if a_r.device.type == "cpu" and not _library.traced(a_r):
        return ternary_decode_gemm_plain(packed, a_r, g=g)
    check_kernel_device(a_r, float_only=False)
    return _launch_int_grouped(packed, a_r, g, plan)


def _launch_int_grouped(packed, a_r, g, plan) -> torch.Tensor:
    """The launch half of `ternary_decode_gemm_grouped` (as `_launch_fused`)."""
    e, m, kg = packed.shape
    if e * m * a_r.shape[3] == 0 or kg == 0:
        return _int_out(packed, a_r).zero_()
    if _library.traced(a_r):
        return _INT_GROUPED_OP(packed, a_r, g, _library.plan_fields(plan))
    out = _int_out(packed, a_r)
    if plan is None:
        plan = autotune.get_plan("decode_grouped", g, m, kg, a_r.shape[3], e=e, fused=False,
                                 device=a_r.device)
    _build.launch_decode_int_grouped(packed, a_r, g, out, plan,
                                     *_splitk.launch_args(plan, a_r.device))
    ternary_decode_gemm_grouped.launches += 1
    return out


_build.counts_launches(ternary_decode_gemm_grouped, ("decode_grouped_kernel",), int_acts=True)
_INT_GROUPED_OP = _library.define(
    "ternary_decode_gemm_grouped", _INT_SCHEMA,
    cpu=lambda packed, a_r, g, plan=None: ternary_decode_gemm_plain(packed, a_r, g=g),
    cuda=lambda packed, a_r, g, plan=None: _launch_int_grouped(
        packed, a_r, g, _library.plan_from(GroupedDecodePlan, plan)),
    fake=lambda packed, a_r, g, plan=None: _int_out(packed, a_r))
