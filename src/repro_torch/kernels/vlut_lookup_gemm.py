"""Vector-LUT mpGeMM (the paper's kernel): the fused kernel and its
integer twin, each also in a grouped form (E experts of one shape in one
launch), each with its CUDA kernel's wrapper, its plain PyTorch version and
its launch count.

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
decode kernels). The grouped launches have their own plan
(`grouped_lut_plan`) for their own kernel: 512 threads, a row tile of up
to 8 rows a thread (1,024 rows at 16 tokens, 4,096 at 4) over which one
table build is shared, chunks of 16 K-groups staged ahead, K-splits or
experts per block chosen so the grid is a whole number of waves within
5%.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core.vlut import sign_matrix_on

from . import _build, _library, _splitk, autotune
from .ternary_decode_gemm import (
    _FUSED_SCHEMA,
    _INT_SCHEMA,
    _fused_out,
    _grouped_out,
    _int_out,
    check_fused_args,
    check_grouped_args,
    check_int_args,
    check_int_grouped_args,
    check_kernel_device,
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
    """The launch of one single vector-LUT kernel call: block (x, y, z)
    owns rows `rows(x)`, tokens `tokens(y)` and K-groups `kgroups(z)`, and
    builds its table `chunk` K-groups at a time (grouped launches take a
    `GroupedLutPlan`)."""
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
    """The launch of one single call, from its shape (cached: the serving
    path asks for the same few shapes at every step):

    - BM: `BM_MAX` for this many tokens, or M rounded up to 128 rows;
    - S = 1 where M-tiles × token tiles fill a wave (132
      blocks); else the most splits that keep the grid within two waves
      (S ≤ KG);
    - chunk: the K-groups one block's shared memory holds within
      `SMEM_BUDGET` (a multiple of 4 where the splits are aligned), at
      most the longest K-slice.

    The kernel's chunk loop walks a longer K-slice chunk by chunk."""
    bnt = 4 * tok_lanes(min(n, BN))
    cap = next(bm for most, bm in BM_MAX if most is None or n <= most)
    bm = min(cap, -(-m // BM_UNIT) * BM_UNIT)
    tiles = -(-m // bm) * -(-n // BN)
    splits = 1 if tiles >= WAVE else min(kg, 2 * WAVE // tiles)
    chunk = lut_chunk(g, bm, kg, splits, bnt)
    return LutPlan(m, kg, n, g, bm, splits, chunk, lut_smem_bytes(g, bm, chunk, bnt))


def word_chunk(chunk: int, kg: int, splits: int) -> int:
    """A chunk above 4 K-groups rounded down to a multiple of 4 where the
    splits start on code words (KG % 4 == 0 and S <= KG/4); at least 1."""
    if chunk > 4 and kg % 4 == 0 and 4 * splits <= kg:
        chunk -= chunk % 4
    return max(1, chunk)


def lut_chunk(g: int, bm: int, kg: int, splits: int, bnt: int, budget: int = SMEM_BUDGET) -> int:
    """`lut_plan`'s chunk for BM rows and S splits: the K-groups one block's
    shared memory holds within `budget` (on code words where the splits
    are), at most the longest K-slice."""
    fit = max(1, (budget - 48) // (3 ** g * bnt * 2 + g * bnt + bm))
    longest = max(_split_bound(z + 1, kg, splits) - _split_bound(z, kg, splits)
                  for z in range(splits))
    chunk = word_chunk(min(longest, fit), kg, splits)
    while chunk > 1 and lut_smem_bytes(g, bm, chunk, bnt) > budget:
        chunk -= 1
    return chunk


# The grouped plan's constants (`vlut_grouped_kernel` in the kernel's source)
GROUP_THREADS = 512         # threads of a grouped block
GROUP_ROWS = 8              # most rows a thread sums (4 tokens each)
GROUP_CHUNK = 16            # K-groups a block stages and builds at a time
GROUP_FLUSH = 3             # chunks summed in 16-bit lanes between flushes
GROUP_BLOCKS_PER_SM = 1     # one 512-thread block per SM (registers, shared memory)
#: the grid's share of its last wave a grouped plan aims for
WAVE_EFFICIENCY = 0.95


def grouped_smem_bytes(g: int, bm: int, chunk: int, bnt: int) -> int:
    """Dynamic shared memory of one grouped block (`glut_layout` in the
    kernel): the table [chunk][3^g][bnt] int16, two stages of codes
    [bm][16], two stages of activations [bnt][16*g] (4 bytes each: f32 or
    bf16 rows, or the integer kernel's [g][16][bnt] bytes) and the int8
    activations [16*g][bnt]."""
    return (_round16(chunk * 3 ** g * bnt * 2) + 2 * bm * GROUP_CHUNK
            + 2 * bnt * _round16(GROUP_CHUNK * g * 4) + _round16(GROUP_CHUNK * g * bnt))


def wave_efficiency(blocks: int) -> float:
    """The grid's blocks over the slots of the waves it takes."""
    slots = WAVE * GROUP_BLOCKS_PER_SM
    return blocks / (-(-blocks // slots) * slots)


def _group_split_bound(z: int, kg: int, splits: int) -> int:
    """First K-group of split z of a grouped plan: z*KG/S rounded down to
    a multiple of 16 (S <= KG/16), so every chunk starts 16 K-groups apart
    from the row's start; split S ends at KG (`gsplit_bound` in the
    kernel)."""
    return kg if z >= splits else z * kg // splits & ~(GROUP_CHUNK - 1)


@dataclasses.dataclass(frozen=True)
class GroupedLutPlan:
    """The launch of one grouped vector-LUT call: block (x, y, z) owns rows
    `rows(x)`, tokens `tokens(y)` and K-groups `kgroups(z % splits)` of
    the experts `experts(z // splits)`, one after another, and stages and
    builds its table `chunk` K-groups at a time."""
    m: int
    kg: int
    n: int
    g: int
    bm: int
    splits: int
    chunk: int
    smem: int
    e: int
    ex: int = 1             # experts per block

    m_tiles = LutPlan.m_tiles
    n_tiles = LutPlan.n_tiles
    rows = LutPlan.rows
    tokens = LutPlan.tokens

    @property
    def e_groups(self) -> int:
        return -(-self.e // self.ex)

    @property
    def blocks(self) -> int:
        return self.e_groups * self.m_tiles * self.n_tiles * self.splits

    def experts(self, zg: int) -> tuple[int, int]:
        return zg * self.ex, min(self.e, (zg + 1) * self.ex)

    def kgroups(self, z: int) -> tuple[int, int]:
        return _group_split_bound(z, self.kg, self.splits), _group_split_bound(z + 1, self.kg, self.splits)


@functools.lru_cache(maxsize=4096)
def grouped_lut_plan(m: int, kg: int, n: int, g: int, e: int) -> GroupedLutPlan:
    """The launch of one grouped call of `e` experts (the grouped kernels
    take it at any E, 1 included), from its shape:

    - BM: the fewest M-tiles of at most 8 rows a thread (512 × 8 × 4 /
      token lanes' tokens: 1,024 rows at 16 tokens, 4,096 at 4), the rows
      shared evenly between them, rounded up to 128;
    - a segment of one chunk (KG ≤ 16): no split; `ex` experts a block,
      the fewest waves times experts a block, then the fewest blocks (so
      E × M-tiles blocks of one tiny chunk each do not fill many waves);
    - else: the fewest K-splits (S ≤ KG/16) whose grid fills its last
      wave to `WAVE_EFFICIENCY`, or the best filled where none does;
    - chunk: 16 K-groups, or the whole K-slice where it is shorter."""
    bnt = 4 * tok_lanes(min(n, BN))
    cap = GROUP_THREADS * GROUP_ROWS * 4 // bnt
    mt = -(-m // cap)
    bm = -(-(-(-m // mt)) // BM_UNIT) * BM_UNIT
    tiles = -(-m // bm) * -(-n // BN)
    splits, ex = 1, 1
    if kg <= GROUP_CHUNK:
        slots = WAVE * GROUP_BLOCKS_PER_SM
        ex = min(range(1, e + 1), key=lambda x: (-(-(-(-e // x) * tiles) // slots) * x, -x))
    else:
        fill = [(wave_efficiency(e * tiles * s), s) for s in range(1, kg // GROUP_CHUNK + 1)]
        splits = next((s for eff, s in fill if eff >= WAVE_EFFICIENCY),
                      max(fill, key=lambda f: (f[0], -f[1]))[1])
    chunk = min(GROUP_CHUNK, max(_group_split_bound(z + 1, kg, splits) - _group_split_bound(z, kg, splits)
                                 for z in range(splits)))
    return GroupedLutPlan(m, kg, n, g, bm, splits, chunk, grouped_smem_bytes(g, bm, chunk, bnt), e, ex)


def _launch_args(plan, device: torch.device):
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
    the f32 epilogue. Stacked operands (a leading expert axis, as the
    grouped kernel takes them) run expert by expert: the plain version of
    both kernels."""
    if packed.ndim == 3:
        return torch.stack([
            vlut_lookup_gemm_fused_plain(pe, xe, se, we, g=g, out_dtype=out_dtype)
            for pe, xe, se, we in zip(packed, x, a_scale, w_scale)])
    n = x.shape[0]
    q = quantize_tokens(x, a_scale).reshape(n, packed.shape[1], g)
    return epilogue(_lut_gather_int(q, packed, g), w_scale, a_scale, out_dtype)


def vlut_lookup_gemm_fused(packed, x, a_scale, w_scale, *, g: int,
                           out_dtype=torch.float32, plan=None) -> torch.Tensor:
    """packed (M, KG) uint8 × x (N, KG*g) float → (N, M) out_dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    add one to ``vlut_lookup_gemm_fused.launches``) or raise; fake
    tensors (a trace) go through the operator of the same name
    (`_library`). `plan`: a `LutPlan` launched as it is; None takes
    `autotune.get_plan`'s."""
    check_fused_args(packed, x, a_scale, w_scale, g, out_dtype)
    if x.device.type == "cpu" and not _library.traced(x):
        return vlut_lookup_gemm_fused_plain(
            packed, x, a_scale, w_scale, g=g, out_dtype=out_dtype)
    check_kernel_device(x, float_only=True)
    return _launch_fused(packed, x, a_scale, w_scale, g, out_dtype, plan)


def _launch_fused(packed, x, a_scale, w_scale, g, out_dtype, plan) -> torch.Tensor:
    """The launch half of `vlut_lookup_gemm_fused` (operands checked),
    reached directly or by the operator's CUDA implementation: an empty
    product launches nothing; a traced one is one operator."""
    if x.shape[0] * packed.shape[0] == 0 or packed.shape[1] == 0:
        return _fused_out(packed, x, out_dtype).zero_()
    if _library.traced(x):
        return _FUSED_OP(packed, x, a_scale, w_scale, g, out_dtype, _library.plan_fields(plan))
    out = _fused_out(packed, x, out_dtype)
    if plan is None:
        plan = autotune.get_plan("lookup", g, *packed.shape, x.shape[0], device=x.device)
    _build.launch_lut(packed, x, a_scale, w_scale, g, out, plan, *_launch_args(plan, x.device))
    vlut_lookup_gemm_fused.launches += 1
    return out


_build.counts_launches(vlut_lookup_gemm_fused, ("vlut_kernel",))
_FUSED_OP = _library.define(
    "vlut_lookup_gemm_fused", _FUSED_SCHEMA,
    cpu=lambda packed, x, a_scale, w_scale, g, out_dtype, plan=None:
        vlut_lookup_gemm_fused_plain(packed, x, a_scale, w_scale, g=g, out_dtype=out_dtype),
    cuda=lambda packed, x, a_scale, w_scale, g, out_dtype, plan=None: _launch_fused(
        packed, x, a_scale, w_scale, g, out_dtype, _library.plan_from(LutPlan, plan)),
    fake=lambda packed, x, a_scale, w_scale, g, out_dtype, plan=None:
        _fused_out(packed, x, out_dtype))


def vlut_lookup_gemm_fused_grouped(packed, x, a_scale, w_scale, *, g: int,
                                   out_dtype=torch.float32, plan=None) -> torch.Tensor:
    """E products of one shape in one launch: packed (E, M, KG) uint8 × x
    (E, C, KG*g) float → (E, C, M) out_dtype, expert e bit for bit
    `vlut_lookup_gemm_fused(packed[e], x[e], a_scale[e], w_scale[e])`.
    The counterpart of the TPU kernel under `jax.vmap` over stacked expert
    weights (the MoE layers' `linear_batched_apply`).

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    add one to ``vlut_lookup_gemm_fused_grouped.launches``) or raise; fake
    tensors go through the operator of the same name. `plan`: a
    `GroupedLutPlan` launched as it is; None takes `autotune.get_plan`'s."""
    check_grouped_args(packed, x, a_scale, w_scale, g, out_dtype)
    if x.device.type == "cpu" and not _library.traced(x):
        return vlut_lookup_gemm_fused_plain(
            packed, x, a_scale, w_scale, g=g, out_dtype=out_dtype)
    check_kernel_device(x, float_only=True)
    return _launch_fused_grouped(packed, x, a_scale, w_scale, g, out_dtype, plan)


def _launch_fused_grouped(packed, x, a_scale, w_scale, g, out_dtype, plan) -> torch.Tensor:
    """The launch half of `vlut_lookup_gemm_fused_grouped` (as `_launch_fused`)."""
    e, m, kg = packed.shape
    if e * x.shape[1] * m == 0 or kg == 0:
        return _grouped_out(packed, x, out_dtype).zero_()
    if _library.traced(x):
        return _FUSED_GROUPED_OP(packed, x, a_scale, w_scale, g, out_dtype,
                                 _library.plan_fields(plan))
    out = _grouped_out(packed, x, out_dtype)
    if plan is None:
        plan = autotune.get_plan("lookup_grouped", g, m, kg, x.shape[1], e=e, device=x.device)
    _build.launch_lut_grouped(packed, x, a_scale, w_scale, g, out, plan,
                              *_launch_args(plan, x.device))
    vlut_lookup_gemm_fused_grouped.launches += 1
    return out


_build.counts_launches(vlut_lookup_gemm_fused_grouped, ("vlut_grouped_kernel",))
_FUSED_GROUPED_OP = _library.define(
    "vlut_lookup_gemm_fused_grouped", _FUSED_SCHEMA,
    cpu=lambda packed, x, a_scale, w_scale, g, out_dtype, plan=None:
        vlut_lookup_gemm_fused_plain(packed, x, a_scale, w_scale, g=g, out_dtype=out_dtype),
    cuda=lambda packed, x, a_scale, w_scale, g, out_dtype, plan=None: _launch_fused_grouped(
        packed, x, a_scale, w_scale, g, out_dtype, _library.plan_from(GroupedLutPlan, plan)),
    fake=lambda packed, x, a_scale, w_scale, g, out_dtype, plan=None:
        _grouped_out(packed, x, out_dtype))


def vlut_lookup_gemm_plain(packed, a_r, *, g: int) -> torch.Tensor:
    """Plain version of the integer kernel: the table gather of
    `_lut_gather_int` on a_r (g, KG, N) int8 → (M, N) int32. Stacked
    operands (a leading expert axis, as the grouped kernel takes them) run
    expert by expert: the plain version of both kernels."""
    if packed.ndim == 3:
        return torch.stack([vlut_lookup_gemm_plain(pe, ae, g=g) for pe, ae in zip(packed, a_r)])
    q = a_r.permute(2, 1, 0).to(torch.float32)                       # (N, KG, g)
    return _lut_gather_int(q, packed, g).T.contiguous()


def vlut_lookup_gemm(packed, a_r, *, g: int, plan=None) -> torch.Tensor:
    """packed (M, KG) uint8 × a_r (g, KG, N) int8 → (M, N) int32, exact.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    add one to ``vlut_lookup_gemm.launches``) or raise; fake
    tensors go through the operator of the same name. `plan`: a `LutPlan`
    launched as it is; None takes `autotune.get_plan`'s."""
    check_int_args(packed, a_r, g)
    if a_r.device.type == "cpu" and not _library.traced(a_r):
        return vlut_lookup_gemm_plain(packed, a_r, g=g)
    check_kernel_device(a_r, float_only=False)
    return _launch_int(packed, a_r, g, plan)


def _launch_int(packed, a_r, g, plan) -> torch.Tensor:
    """The launch half of `vlut_lookup_gemm` (as `_launch_fused`)."""
    if packed.shape[0] * a_r.shape[2] == 0 or packed.shape[1] == 0:
        return _int_out(packed, a_r).zero_()
    if _library.traced(a_r):
        return _INT_OP(packed, a_r, g, _library.plan_fields(plan))
    out = _int_out(packed, a_r)
    if plan is None:
        plan = autotune.get_plan("lookup", g, *packed.shape, a_r.shape[2], fused=False,
                                 device=a_r.device)
    _build.launch_lut_int(packed, a_r, g, out, plan, *_launch_args(plan, a_r.device))
    vlut_lookup_gemm.launches += 1
    return out


_build.counts_launches(vlut_lookup_gemm, ("vlut_kernel",), int_acts=True)
_INT_OP = _library.define(
    "vlut_lookup_gemm", _INT_SCHEMA,
    cpu=lambda packed, a_r, g, plan=None: vlut_lookup_gemm_plain(packed, a_r, g=g),
    cuda=lambda packed, a_r, g, plan=None: _launch_int(
        packed, a_r, g, _library.plan_from(LutPlan, plan)),
    fake=lambda packed, a_r, g, plan=None: _int_out(packed, a_r))


def vlut_lookup_gemm_grouped(packed, a_r, *, g: int, plan=None) -> torch.Tensor:
    """E integer products of one shape in one launch: packed (E, M, KG)
    uint8 × a_r (E, g, KG, N) int8 → (E, M, N) int32, expert e bit for bit
    `vlut_lookup_gemm(packed[e], a_r[e])`. The counterpart of the TPU
    kernel under `jax.vmap` over stacked expert weights (the MoE layers'
    unfused pipeline).

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    add one to ``vlut_lookup_gemm_grouped.launches``) or raise; fake
    tensors go through the operator of the same name. `plan`: a
    `GroupedLutPlan` launched as it is; None takes `autotune.get_plan`'s."""
    check_int_grouped_args(packed, a_r, g)
    if a_r.device.type == "cpu" and not _library.traced(a_r):
        return vlut_lookup_gemm_plain(packed, a_r, g=g)
    check_kernel_device(a_r, float_only=False)
    return _launch_int_grouped(packed, a_r, g, plan)


def _launch_int_grouped(packed, a_r, g, plan) -> torch.Tensor:
    """The launch half of `vlut_lookup_gemm_grouped` (as `_launch_fused`)."""
    e, m, kg = packed.shape
    if e * m * a_r.shape[3] == 0 or kg == 0:
        return _int_out(packed, a_r).zero_()
    if _library.traced(a_r):
        return _INT_GROUPED_OP(packed, a_r, g, _library.plan_fields(plan))
    out = _int_out(packed, a_r)
    if plan is None:
        plan = autotune.get_plan("lookup_grouped", g, m, kg, a_r.shape[3], e=e, fused=False,
                                 device=a_r.device)
    _build.launch_lut_int_grouped(packed, a_r, g, out, plan, *_launch_args(plan, a_r.device))
    vlut_lookup_gemm_grouped.launches += 1
    return out


_build.counts_launches(vlut_lookup_gemm_grouped, ("vlut_grouped_kernel",), int_acts=True)
_INT_GROUPED_OP = _library.define(
    "vlut_lookup_gemm_grouped", _INT_SCHEMA,
    cpu=lambda packed, a_r, g, plan=None: vlut_lookup_gemm_plain(packed, a_r, g=g),
    cuda=lambda packed, a_r, g, plan=None: _launch_int_grouped(
        packed, a_r, g, _library.plan_from(GroupedLutPlan, plan)),
    fake=lambda packed, a_r, g, plan=None: _int_out(packed, a_r))
