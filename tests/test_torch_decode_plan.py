"""The decode kernels' launch plan (`kernels.ternary_decode_gemm.decode_plan`)
and the tensor-core kernel's arithmetic, on the CPU: the plan's tiles cover
every output row, token and K-group exactly once; at decode N it fills the
H100's 132 SMs at every BitLinear shape of smollm-360m and splits K only
where the tiles alone fill less than one wave; its shared memory agrees
with the kernel's formula and the constants of
`csrc/ternary_decode_gemm.cu`; the alignment predicate holds on the views
the model passes; the trit table equals `unpack_ternary`; and a numpy
emulation of the kernel (the code words decoded by the table and
`__byte_perm`, the `mma.sync.m16n8k32` fragments, one product per trit
summed in int32, the split-K partials added into a workspace) equals the
plain versions bit for bit, fused and integer, the saturated sums at the
plan with the most splits included. The emulation lives here only: nothing
on the main path runs it. Inputs are made by numpy from a seed."""
import dataclasses
import re

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import act_token_scale, pack_weight, ternary_quantize  # noqa: E402
from repro_torch.core.packing import pack_group_sizes, unpack_ternary  # noqa: E402
from repro_torch.kernels import _build, _splitk, ops  # noqa: E402
from repro_torch.kernels import ternary_decode_gemm as tdg  # noqa: E402

#: smollm-360m's BitLinear shapes (M, K): q and o, k and v, gate and up, down
SMOLLM = [(960, 960), (320, 960), (2560, 960), (960, 2560)]
SMEM_STATIC_MAX = 48 * 1024          # the kernel launches without opting in to more


def _k964_segments():
    """(M, KG, g) of the K = 964 weight's two segments (192 g=5 groups, one
    g=4 group)."""
    w = torch.tensor(np.random.default_rng(0).standard_normal((960, 964)).astype(np.float32))
    tw = ternary_quantize(w)
    pw = pack_weight(tw.values, tw.scale)
    return [(p.shape[0], p.shape[1], g) for p, _, _, g in ops._segments(pw)]


#: the BitLinears (M, K) of mamba2-1.3b (in_proj, out_proj) and gemma3-1b
#: (wq, wk and wv, wo, w1 and w3, w2): g=4 segments of 1 and 4 K-groups and
#: M 256 and 8512, which no earlier config had
NEW_LINEARS = [(8512, 2048), (2048, 4096), (1024, 1152), (256, 1152), (1152, 1024),
               (6912, 1152), (1152, 6912)]
#: token counts exact-length prefill gives (no 16-multiple bucket), and decode
ODD_N = (1, 17, 61, 200)


def _segments_of(m, k):
    """(M, KG, g) of a (M, K) weight's non-empty segments, by pack_group_sizes."""
    n5, n4 = pack_group_sizes(k)
    return [(m, kg, g) for kg, g in ((n5, 5), (n4, 4)) if kg]


NEW_SEGMENTS = [seg for m, k in NEW_LINEARS for seg in _segments_of(m, k)]

COVER_CASES = (
    [(m, k // 5, n, 5) for m, k in SMOLLM for n in (1, 4, 16, 64, 256)]
    + [(70, 13, 17, 5), (1000, 77, 33, 5), (1000, 191, 17, 4), (70, 1, 3, 4),
       (2560, 512, 1000, 5)]
    + [(m, kg, n, g) for m, kg, g in _k964_segments() for n in (1, 4, 17, 256)]
    + [(m, kg, n, g) for m, kg, g in NEW_SEGMENTS for n in ODD_N]
)


def _cover(ranges, total):
    """The ranges, in order, tile [0, total) with no gap or overlap."""
    pos = 0
    for lo, hi in ranges:
        assert lo == pos and hi > lo, (ranges, total)
        pos = hi
    assert pos == total


@pytest.mark.parametrize("aligned", [False, True], ids=["bytes", "words"])
@pytest.mark.parametrize("m,kg,n,g", COVER_CASES)
def test_plan_tiles_cover_exactly(m, kg, n, g, aligned):
    aligned = aligned and kg % 4 == 0
    p = tdg.decode_plan(m, kg, n, g, codes_aligned=aligned, acts_aligned=aligned)
    assert (p.bm, p.bn) in {(bm, bn) for _, bm, bn in tdg.TILES}
    assert p.bn % 8 == 0 and 1 <= p.splits <= kg and p.kstep in (tdg.SUB, tdg.MAX_STEP)
    _cover([p.rows(x) for x in range(p.m_tiles)], m)
    _cover([p.tokens(y) for y in range(p.n_tiles)], n)
    _cover([p.kgroups(z) for z in range(p.splits)], kg)
    for z in range(p.splits):
        _cover([(lo - p.kgroups(z)[0], hi - p.kgroups(z)[0]) for lo, hi in p.steps(z)],
               p.kgroups(z)[1] - p.kgroups(z)[0])
        if kg % 4 == 0:                     # every K-slice starts on a code word
            assert p.kgroups(z)[0] % 4 == 0, p


#: grouped launches (E, M, KG, g, N): llama4-scout's routed experts (w1/w3:
#: M 8192, K 5120; w2: M 5120, K 8192 = 1636 g=5 + 3 g=4 groups) at decode,
#: verify and prefill N; deepseek-v3-671b's 256 (w1/w3: M 2048, K 7168 =
#: 1432 g=5 + 2 g=4 groups; w2: M 7168, K 2048 = 408 + 2) at C 16; and
#: ragged traps (odd E, M off the tiles, N 5 and 17, KG not divisible by
#: the splits)
DEEPSEEK_EXPERTS = [(256, 2048, 1432, 5, 16), (256, 2048, 2, 4, 16),
                    (256, 7168, 408, 5, 16), (256, 7168, 2, 4, 16)]
LLAMA4_EXPERTS = ([(16, 8192, 1024, 5, n) for n in (4, 16, 64)]
                  + [(16, 5120, kg, g, n) for kg, g in ((1636, 5), (3, 4)) for n in (4, 16, 64)])
#: the grouped plan's geometry traps (E, M, KG, g, C), as chip_smoke.py's
#: DECODE_GEOMETRY_TRAPS: E x blocks just over a wave, several experts a
#: block, M 70 and 1000, KG 1-77, C 1-64, g 4 and 5, splits
GROUPED_TRAPS = [(133, 1000, 300, 5, 16), (140, 70, 2, 4, 1), (16, 1000, 77, 5, 64),
                 (3, 70, 1, 4, 5), (7, 1000, 13, 5, 17), (1, 960, 192, 5, 4)]
GROUPED_CASES = (
    [(16, 8192, 1024, 5, n) for n in (4, 16, 64)]
    + [(16, 5120, 1636, 5, 16), (16, 5120, 3, 4, 16)]
    + DEEPSEEK_EXPERTS
    + [(3, 70, 13, 5, 5), (5, 130, 77, 4, 17), (3, 1000, 191, 5, 5), (1, 960, 192, 5, 4)]
)


@pytest.mark.parametrize("e,m,kg,g,n", GROUPED_CASES + GROUPED_TRAPS)
def test_grouped_plan_counts_the_experts(e, m, kg, g, n, monkeypatch):
    """A grouped plan (`grouped_decode_plan`) covers every (expert, row,
    token, K-group) exactly once; splits start on a step; the blocks
    count its expert groups, row chunks, token tiles and splits; split-K
    comes with a workspace and counters for every expert."""
    p = tdg.grouped_decode_plan(m, kg, n, g, e)
    assert p.e == e and p.blocks == p.e_groups * p.m_tiles * p.n_tiles * p.splits
    assert p.bm % tdg.GROUP_ROWS == 0 and p.bn == (8 if n <= 8 else 16)
    assert 1 <= p.splits <= max(1, kg // tdg.GROUP_STEP) and 1 <= p.ex <= e
    _cover([p.experts(z) for z in range(p.e_groups)], e)
    _cover([p.rows(x) for x in range(p.m_tiles)], m)
    _cover([p.tokens(y) for y in range(p.n_tiles)], n)
    _cover([p.kgroups(z) for z in range(p.splits)], kg)
    assert all(p.kgroups(z)[0] % tdg.GROUP_STEP == 0 for z in range(p.splits))
    assert p.stagings == p.m_tiles
    if p.splits > 1:    # the workspace the wrapper would pass, sized here on the CPU
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
        monkeypatch.setattr(_splitk, "_WORKSPACE", {})
        ws, counters = _splitk.launch_args(p, torch.device("cpu"))
        assert ws.numel() >= e * m * n and counters.numel() >= e * p.m_tiles * p.n_tiles
        assert not ws.any() and not counters.any()


def test_grouped_cases_include_a_split_k_launch():
    plans = [tdg.grouped_decode_plan(m, kg, n, g, e) for e, m, kg, g, n in GROUPED_CASES + GROUPED_TRAPS]
    assert any(p.splits > 1 for p in plans) and any(p.ex > 1 for p in plans)
    assert any(p.packed_rows for p in plans) and any(p.n_tiles > 1 for p in plans)


@pytest.mark.parametrize("e,m,kg,g,n", DEEPSEEK_EXPERTS + LLAMA4_EXPERTS)
def test_grouped_plan_fills_its_last_wave(e, m, kg, g, n):
    """At the main path's expert shapes the grid fills its last wave to
    `WAVE_EFFICIENCY`, and the g=4 tails run in one wave; every activation
    is staged at most 8 times a launch (decode_kernel's 64-row tiles staged
    it 32-128 times), and `MIN_CHUNKS` times at deepseek's main segments,
    whose experts' rows take two blocks each."""
    p = tdg.grouped_decode_plan(m, kg, n, g, e)
    assert p.stagings <= 8, p
    if kg <= tdg.GROUP_STEP:
        assert p.blocks <= tdg.WAVE and p.packed_rows, p
    else:
        assert tdg.wave_efficiency(p.blocks) >= tdg.WAVE_EFFICIENCY, p
    if e == 256 and kg > tdg.GROUP_STEP:
        assert p.stagings == tdg.MIN_CHUNKS == 2 and p.splits == 1, p


@pytest.mark.parametrize("e,m,kg,g,n", [c for c in DEEPSEEK_EXPERTS if c[2] <= 64])
def test_grouped_tails_run_several_experts_a_block(e, m, kg, g, n):
    """deepseek's 2-K-group g=4 tails: a few experts a block in about one
    wave, not E × M-tiles tiny blocks (decode_kernel launched 8,192 and
    28,672)."""
    p = tdg.grouped_decode_plan(m, kg, n, g, e)
    assert p.ex > 1 and p.blocks <= tdg.WAVE and p.splits == 1, p


@pytest.mark.parametrize("g", [4, 5])
def test_grouped_plan_shared_memory(g):
    """The plan's shared bytes are the kernel's formula at its longest
    K-slice, and fit what a block can opt in to (227 KB less the static
    part), at every shape and token count the plan picks for."""
    for m in (70, 2048, 5120, 7168, 8192):
        for kg in (1, 2, 3, 13, 64, 65, 408, 1024, 1432, 1636, 2048):
            for n in (1, 4, 9, 16, 17, 64):
                for e in (1, 16, 256):
                    p = tdg.grouped_decode_plan(m, kg, n, g, e)
                    longest = max(hi - lo for lo, hi in (p.kgroups(z) for z in range(p.splits)))
                    assert p.smem == tdg.grouped_decode_smem_bytes(g, p.bn, longest), p
                    assert p.smem <= tdg.GROUP_SMEM_MAX, p


def test_grouped_plan_matches_kernel_constants():
    """The grouped plan's constants are those of `decode_grouped_kernel` in
    csrc/ternary_decode_gemm.cu, and its shared-memory formula is the
    kernel's."""
    src = _src()
    assert _const(src, "kGWarps") * 32 == tdg.GROUP_THREADS
    assert _const(src, "kGStep") == tdg.GROUP_STEP
    assert _const(src, "kGBN") == tdg.GROUP_BN
    assert _const(src, "kGCopies") == tdg.GROUP_COPIES
    assert _const(src, "kGSlab") == tdg.GROUP_SLAB
    assert "constexpr int kGRows = kGSlab * kGWarps;" in src
    assert tdg.GROUP_ROWS == tdg.GROUP_SLAB * tdg.GROUP_THREADS // 32
    assert "constexpr int kGSlot = kGSlab * kGStep;" in src
    assert "return ((r / (128 / kGStep)) & (kGStep / 32 - 1)) << 5;" in src
    assert "return r * kGStep + (c ^ slot_swizzle(r));" in src
    assert "constexpr size_t kGMaxSmem = 232448 - 1024;" in src and tdg.GROUP_SMEM_MAX == 232448 - 1024
    assert "return (nk + 63) / 64 * 64 + 32;" in src
    assert "return (size_t)kTableSize * 8 * kGCopies;" in src
    assert "return (size_t)kGWarps * kGSlot;" in src


@pytest.mark.parametrize("nk", [2, 64, 408, 1432, 1636])
def test_grouped_reads_are_conflict_free(nk):
    """A half-warp's 8-byte reads (rows gid 0-3 or 4-7 x t 0-3, 32 bytes a
    row) fall on 16 distinct bank pairs: B from the staged activations'
    rows, and A from a slot's rows (either m16 tile, every k32
    sub-step) through the swizzle."""
    rs = tdg.grouped_row_bytes(nk)
    for half in (0, 1):
        banks = {((4 * half + r) * rs + 8 * t) // 8 % 16 for r in range(4) for t in range(4)}
        assert len(banks) == 16, rs
        for h in (0, 1):
            for extra in (0, 8):
                for s in range(tdg.GROUP_STEP // 32):
                    banks = {(_slot_at(16 * h + extra + 4 * half + r, 32 * s) + 8 * t) // 8 % 16
                             for r in range(4) for t in range(4)}
                    assert len(banks) == 16, (h, extra, s)


def test_new_segments_are_the_ones_no_earlier_config_had():
    """The g=4 segments hold 2, 4, 3 and 1 K-groups (KG4 = 4 is the first
    g=4 segment whose codes are read as words), and M runs from 256 to
    8512."""
    assert sorted({kg for _, kg, g in NEW_SEGMENTS if g == 4}) == [1, 2, 3, 4]
    assert {m for m, _, _ in NEW_SEGMENTS} >= {256, 8512}


@pytest.mark.parametrize("n", ODD_N)
@pytest.mark.parametrize("m,k", NEW_LINEARS)
def test_new_linears_plan_within_two_waves(m, k, n):
    """At every segment of the new linears and exact-length N, the plan
    fills the card without passing two waves where it splits K, and its
    shared memory is the kernel's formula within the static limit."""
    for _, kg, g in _segments_of(m, k):
        aligned = kg % 4 == 0
        p = tdg.decode_plan(m, kg, n, g, codes_aligned=aligned, acts_aligned=aligned)
        tiles = p.m_tiles * p.n_tiles
        assert p.splits == 1 or p.blocks <= 2 * tdg.WAVE, p
        cap = kg // 4 if aligned else kg        # splits start on code words
        assert p.blocks >= min(tdg.WAVE, tiles * cap), p
        assert p.smem == tdg.decode_smem_bytes(g, p.bn, p.kstep) <= SMEM_STATIC_MAX


def test_cover_cases_include_uneven_and_multi_step_splits():
    plans = [tdg.decode_plan(*c) for c in COVER_CASES]
    assert any(p.kg % p.splits for p in plans)
    assert any(len(p.steps(0)) > 1 for p in plans)
    assert any(p.kstep == tdg.MAX_STEP for p in plans)


@pytest.mark.parametrize("n", [1, 4, 16])
@pytest.mark.parametrize("m,k", SMOLLM)
def test_plan_fills_the_card_at_decode_n(m, k, n):
    p = tdg.decode_plan(m, k // 5, n, 5, codes_aligned=True, acts_aligned=True)
    assert tdg.WAVE <= p.blocks <= 2 * tdg.WAVE, p


@pytest.mark.parametrize("n", [1, 4, 16, 17, 33, 64, 256, 1000, 4096])
def test_plan_splits_only_where_the_tiles_fall_short(n):
    """S = 1 where the tiles alone fill a wave; otherwise at most two waves,
    and at least one as far as KG allows."""
    for m, kg, g in [(m, k // 5, 5) for m, k in SMOLLM] + [(70, 13, 5), (1000, 77, 4), (8192, 512, 5)]:
        p = tdg.decode_plan(m, kg, n, g)
        tiles = p.m_tiles * p.n_tiles
        if tiles >= tdg.WAVE:
            assert p.splits == 1, p
        else:
            cap = kg // 4 if kg % 4 == 0 else kg
            assert p.blocks >= min(tdg.WAVE, tiles * cap), p
            assert p.blocks <= 2 * tdg.WAVE, p


def _src():
    return (_build.CSRC / "ternary_decode_gemm.cu").read_text()


def _const(text, name):
    return int(re.search(r"constexpr int " + name + r" = (\d+);", text).group(1))


def test_plan_matches_kernel_constants():
    """The plan's constants are those of csrc/ternary_decode_gemm.cu: the
    k32 step, the longest step, the tiles the kernel has (the C entry
    refuses any other), the row padding and the shared-memory formula."""
    src = _src()
    assert (tdg.SUB, tdg.MAX_STEP) == (_const(src, "kSub"), _const(src, "kMaxStep"))
    tiles = re.search(r"constexpr int kTiles\[\]\[2\] = \{(.*?)\};", src).group(1)
    have = {tuple(map(int, t)) for t in re.findall(r"\{(\d+), (\d+)\}", tiles)}
    assert {(bm, bn) for _, bm, bn in tdg.TILES} == have
    assert all(bm % 16 == 0 and bn % 8 == 0 for bm, bn in have)
    assert "return kstep % 64 == 0 ? kstep + 32 : kstep;" in src
    assert "return (size_t)g * bn * decode_row_bytes(kstep);" in src
    assert _const(src, "kTableSize") == 256


@pytest.mark.parametrize("g", [4, 5])
def test_plan_shared_memory(g):
    for m in (70, 320, 960, 2560, 8192):
        for kg in (1, 7, 13, 192, 241, 512, 2048):
            for n in (1, 3, 4, 5, 8, 9, 16, 17, 64, 256, 4096):
                p = tdg.decode_plan(m, kg, n, g)
                assert p.smem == g * p.bn * tdg.row_bytes(p.kstep) <= SMEM_STATIC_MAX, p


@pytest.mark.parametrize("kstep", [32, 64])
def test_b_loads_are_conflict_free(kstep):
    """A half-warp's 8-byte B loads (tokens 0-3 or 4-7 x t 0-3) of a k32
    sub-step fall on 16 distinct bank pairs."""
    rs = tdg.row_bytes(kstep)
    for s in range(kstep // 32):
        for half in (0, 1):
            banks = {((4 * half + n) * rs + 32 * s + 8 * t) // 8 % 16
                     for n in range(4) for t in range(4)}
            assert len(banks) == 16, (kstep, s, half)


def test_alignment_predicate_on_the_models_views():
    """The fused kernel reads x[:, lo:hi] of the model's (N, K) activation
    in place, the integer kernel a de-interleaved copy: word loads for the
    K = 960 weight and the K = 964 weight's g=5 segment, byte loads for its
    one-K-group g=4 segment and for a_r at N = 1."""
    rng = np.random.default_rng(1)
    for k in (960, 964):
        tw = ternary_quantize(torch.tensor(rng.standard_normal((320, k)).astype(np.float32)))
        pw = pack_weight(tw.values, tw.scale)
        for n in (1, 4, 16):
            for dt in (torch.float32, torch.bfloat16):
                x = torch.tensor(rng.standard_normal((n, k)).astype(np.float32)).to(dt)
                a_q = torch.tensor(rng.integers(-127, 128, (k, n)).astype(np.int8))
                for packed, lo, hi, g in ops._segments(pw):
                    want = packed.shape[1] % 4 == 0
                    assert tdg.fused_aligned(packed, x[:, lo:hi]) == (want, want)
                    a_r = ops._deinterleave(a_q[lo:hi], g)
                    assert tdg.int_aligned(packed, a_r) == (want, want and n % 4 == 0)


@pytest.mark.parametrize("e,m,kg,g,n", DEEPSEEK_EXPERTS)
def test_grouped_integer_plan_on_the_stacked_views(e, m, kg, g, n):
    """The grouped integer kernel's operands as `ops._deinterleave(a_q, g,
    e)` stacks them (E experts' C rows in turn): every expert's a_r slice
    is its single product's de-interleaved copy; the vector claim the C
    entry derives (a_r in words of 4 tokens where KG % 4 == 0 and C % 4 ==
    0, every expert stride a multiple of 4) holds for the stacked tensors
    exactly where a single expert's does: every deepseek segment but the
    2-group g=4 ones; the plan at E = 256 is the launch the wrapper makes.
    Checked at 3 experts of the real (M, KG, C): the plan does not depend
    on the tensors."""
    rng = np.random.default_rng(kg + m)
    packed = torch.tensor(rng.integers(0, 3 ** g, (3, m, kg)).astype(np.uint8))
    a_q = torch.tensor(rng.integers(-127, 128, (kg * g, 3 * n)).astype(np.int8))
    a_r = ops._deinterleave(a_q, g, 3)
    assert a_r.shape == (3, g, kg, n) and a_r.is_contiguous()
    for i in range(3):
        single = ops._deinterleave(a_q[:, i * n:(i + 1) * n].contiguous(), g)
        assert torch.equal(a_r[i], single)
        assert tdg.int_aligned(packed[i], a_r[i]) == tdg.int_aligned(packed, a_r)
    want = kg % 4 == 0
    assert tdg.int_aligned(packed, a_r) == (want, want and n % 4 == 0)
    assert a_r.stride(0) % 4 == 0
    p = tdg.grouped_decode_plan(m, kg, n, g, e)
    assert p.e == 256 and p.splits == 1 and p.blocks == p.e_groups * p.m_tiles * p.n_tiles
    assert p.smem <= tdg.GROUP_SMEM_MAX


@pytest.mark.parametrize("k", sorted({k for _, k in NEW_LINEARS}))
def test_alignment_predicate_on_the_new_linears(k):
    """As above, at the new linears' K: word loads exactly where the
    segment's KG % 4 == 0 (K 4096's 4-group g=4 segment included, whose
    view starts 4080 elements into each row), byte loads elsewhere."""
    rng = np.random.default_rng(k)
    tw = ternary_quantize(torch.tensor(rng.standard_normal((256, k)).astype(np.float32)))
    pw = pack_weight(tw.values, tw.scale)
    for n in (1, 4, 17, 61):
        for dt in (torch.float32, torch.bfloat16):
            x = torch.tensor(rng.standard_normal((n, k)).astype(np.float32)).to(dt)
            a_q = torch.tensor(rng.integers(-127, 128, (k, n)).astype(np.int8))
            for packed, lo, hi, g in ops._segments(pw):
                want = packed.shape[1] % 4 == 0
                assert tdg.fused_aligned(packed, x[:, lo:hi]) == (want, want)
                a_r = ops._deinterleave(a_q[lo:hi], g)
                assert tdg.int_aligned(packed, a_r) == (want, want and n % 4 == 0)


def test_alignment_predicate_rejects_offset_pointers_and_strides():
    packed = torch.zeros((64, 192), dtype=torch.uint8)
    buf = torch.zeros(8 + 4 * 960, dtype=torch.float32)
    assert tdg.fused_aligned(packed, buf[:3840].view(4, 960)) == (True, True)
    assert tdg.fused_aligned(packed, buf[1:3841].view(4, 960))[1] is False     # 4-byte offset
    assert tdg.fused_aligned(packed, torch.zeros((4, 962))[:, 2:962])[1] is False  # stride 962
    hb = torch.zeros(8 + 4 * 960, dtype=torch.bfloat16)
    assert tdg.fused_aligned(packed, hb[4:3844].view(4, 960))[1] is True       # 8 bytes
    assert tdg.fused_aligned(packed, hb[2:3842].view(4, 960))[1] is False      # 4 bytes
    assert tdg.fused_aligned(torch.zeros(1 + 64 * 192, dtype=torch.uint8)[1:].view(64, 192),
                             buf[:3840].view(4, 960))[0] is False
    a_r = torch.zeros(8 + 5 * 192 * 4, dtype=torch.int8)
    assert tdg.int_aligned(packed, a_r[4:3844].view(5, 192, 4)) == (True, True)
    assert tdg.int_aligned(packed, a_r[4:2884].view(5, 192, 3)) == (True, False)    # N = 3
    assert tdg.int_aligned(packed, a_r[1:3841].view(5, 192, 4)) == (True, False)    # 1-byte offset


# ---- the kernel's arithmetic, emulated -------------------------------------

def _byte_perm(x, y, s):
    """CUDA's __byte_perm on uint32 arrays: byte i of the result is byte
    (s >> 4i) & 7 of the 8 bytes {y, x}."""
    v = (np.asarray(y, np.uint64) << np.uint64(32)) | np.asarray(x, np.uint64)
    r = np.zeros(np.shape(v), np.uint64)
    for i in range(4):
        sel = (s >> (4 * i)) & 7
        r |= ((v >> np.uint64(8 * sel)) & np.uint64(0xFF)) << np.uint64(8 * i)
    return r.astype(np.uint32)


def _transpose4(e):
    t0, t1 = _byte_perm(e[0], e[1], 0x5140), _byte_perm(e[0], e[1], 0x7362)
    t2, t3 = _byte_perm(e[2], e[3], 0x5140), _byte_perm(e[2], e[3], 0x7362)
    return [_byte_perm(t0, t2, 0x5410), _byte_perm(t0, t2, 0x7632),
            _byte_perm(t1, t3, 0x5410), _byte_perm(t1, t3, 0x7632)]


def _bytes(w):
    """uint32 words (...) -> int8 bytes (..., 4), byte 0 first."""
    return np.asarray(w, np.uint32)[..., None].view(np.uint8).reshape(*np.shape(w), 4).view(np.int8)


def _vbytewise(fn, a, b):
    return np.stack([fn(_bytes(a)[..., i].view(np.uint8).astype(np.int32),
                        _bytes(b)[..., i].view(np.uint8).astype(np.int32)) & 0xFF
                     for i in range(4)], -1).astype(np.uint8).view(np.uint32)[..., 0]


def _vcmpgeu4(a, b):
    return _vbytewise(lambda x, y: np.where(x >= y, 0xFF, 0), a, np.full(np.shape(a), b, np.uint32))


def _vadd4(a, b):
    return _vbytewise(lambda x, y: x + y, a, b)


def _vsub4(a, b):
    return _vbytewise(lambda x, y: x - y, a, b)


def _table():
    """The kernel's trit table: word c = trits 0-3 of code c as int8 bytes."""
    words = np.zeros(256, np.uint32)
    for c in range(256):
        r = c
        for j in range(4):
            words[c] |= np.uint32(((r % 3 - 1) & 0xFF) << (8 * j))
            r //= 3
    return words


TABLE = _table()


def _decode_words(w, g):
    """`decode_word`: code words (...) -> g words, word j = the 4 codes'
    trit j as int8 bytes."""
    lo = [TABLE[(w >> np.uint32(8 * i)) & np.uint32(0xFF)] for i in range(4)]
    out = _transpose4(lo)[:g]
    if g == 5:
        ge81, ge162 = _vcmpgeu4(w, 0x51515151), _vcmpgeu4(w, 0xA2A2A2A2)
        ge243 = _vcmpgeu4(w, 0xF3F3F3F3)
        out.append(_vadd4(_vsub4(_vsub4(np.full(np.shape(w), 0xFFFFFFFF, np.uint32), ge81), ge162),
                          _vadd4(ge243, ge243)))
    return out


@pytest.mark.parametrize("g", [4, 5])
def test_trit_table_equals_unpack_ternary(g):
    """Every code below 3^g (and every byte value, as the plain version
    decodes it): the table and the trit-4 comparisons give its g trits."""
    codes = np.arange(256, dtype=np.uint8)
    words = codes.reshape(64, 4).view(np.uint32)[:, 0]                # 4 codes a word
    dec = np.stack([_bytes(t) for t in _decode_words(words, g)], -1)  # (64, 4 codes, g)
    want = unpack_ternary(torch.tensor(codes[:, None]), g).numpy()    # (256, g)
    assert np.array_equal(dec.reshape(256, g), want)
    assert np.array_equal(dec.reshape(256, g)[:3 ** g], want[:3 ** g])


def _fragment_maps():
    """The PTX fragment layout of mma.m16n8k32 .s8 as index maps: A[row][k]
    is byte k % 4 of register row // 8 + 2 (k // 16) of lane 4 (row % 8) +
    (k % 16) // 4; B[k][col] is byte k % 4 of register k // 16 of lane
    4 col + (k % 16) // 4."""
    row, k = np.meshgrid(np.arange(16), np.arange(32), indexing="ij")
    a = (4 * (row % 8) + (k % 16) // 4, row // 8 + 2 * (k // 16), k % 4)
    k, col = np.meshgrid(np.arange(32), np.arange(8), indexing="ij")
    b = (4 * col + (k % 16) // 4, k // 16, k % 4)
    return a, b


A_MAP, B_MAP = _fragment_maps()


def _mma(a_regs, b_regs):
    """mma.sync.m16n8k32 s8.s8.s32 of one warp from its lanes' registers:
    a_regs (32, 4), b_regs (32, 2) uint32 -> C (16, 8) int32."""
    a = _bytes(a_regs).astype(np.int32)[A_MAP]
    b = _bytes(b_regs).astype(np.int32)[B_MAP]
    return a @ b


def _stage(plan, st, kind, a, n0, nv, s_scale):
    """The prologue's aq[j][n][kg] of one step (int8, tokens [0, bn) x
    K-groups [0, nsub*32)). Integer: a_r's 4 words of 4 tokens each (4
    K-groups) transposed with __byte_perm. Fused: x quantized by the
    kernel's rule (f32, IEEE division, round half to even, clip +-127),
    the 4g features of (token, 4 K-groups) assembled into one word per
    trit."""
    g, (kg0, nk, nsub) = plan.g, st
    width = nsub * 32
    if kind == "int":
        blk = np.zeros((g, width, plan.bn), np.int8)
        blk[:, :nk, :nv] = a[:, kg0:kg0 + nk, n0:n0 + nv]
        rows = blk.reshape(g, width // 4, 4, plan.bn // 4, 4).view(np.uint32)[..., 0]
        cols = _transpose4([rows[:, :, r] for r in range(4)])            # (g, width/4, bn/4)
        aq = np.stack([_bytes(c) for c in cols], 3)                       # (g, w/4, bn/4, 4 tok, 4 kg)
        return aq.transpose(0, 2, 3, 1, 4).reshape(g, plan.bn, width)
    x = np.zeros((plan.bn, width * g), np.float32)
    x[:nv, :nk * g] = a[n0:n0 + nv, kg0 * g:(kg0 + nk) * g]
    q = np.clip(np.rint(x / np.float32(1) if s_scale is None else
                        x / np.concatenate([s_scale, np.ones(plan.bn - nv, np.float32)])[:, None]),
                -127, 127).astype(np.int8).view(np.uint8).astype(np.uint32)
    q = q.reshape(plan.bn, width // 4, 4 * g)
    words = [sum(q[..., kk] << np.uint32(8 * (kk // g)) for kk in range(j, 4 * g, g))
             for j in range(g)]                                           # (bn, width/4) each
    return np.stack([_bytes(w).reshape(plan.bn, width) for w in words], 0)


def _emulate(packed, a, plan, kind, a_scale=None):
    """The kernel's decomposition and arithmetic: per block of the plan and
    step, the staged activations; per warp and k32 sub-step the code words
    (K-groups 8t..8t+3 and 8t+4..8t+7 of rows gid and gid + 8, 0 past M
    or KG), decoded into one A fragment per trit; the B fragments read as
    8-byte words of aq; one mma per trit and n8 tile summed in int32; each
    split's partials added into an int32 workspace (M, N)."""
    m, kg = packed.shape
    n = plan.n
    ws = np.zeros((m, n), np.int32)
    padded = np.zeros((plan.m_tiles * plan.bm + 8, kg + 2 * plan.kstep + 64), np.uint8)
    padded[:m, :kg] = packed
    lanes = np.arange(32)
    gid, tq = lanes // 4, lanes % 4
    for x in range(plan.m_tiles):
        m0 = x * plan.bm
        for y in range(plan.n_tiles):
            n0 = y * plan.bn
            nv = min(plan.bn, n - n0)
            scale = None if a_scale is None else a_scale[n0:n0 + nv]
            for z in range(plan.splits):
                acc = np.zeros((plan.bm // 16, plan.bn // 8, 16, 8), np.int32)
                for kg0, kg1 in plan.steps(z):
                    st = (kg0, kg1 - kg0, -(-(kg1 - kg0) // 32))
                    aq = _stage(plan, st, kind, a, n0, nv, scale)
                    for s in range(st[2]):
                        for w in range(plan.bm // 16):
                            r0 = m0 + 16 * w + gid
                            k = kg0 + 32 * s + 8 * tq
                            cw = np.stack([padded[r[:, None], kk[:, None] + np.arange(4)]
                                           for r, kk in ((r0, k), (r0 + 8, k), (r0, k + 4),
                                                         (r0 + 8, k + 4))])       # (4, 32, 4)
                            cw = np.ascontiguousarray(cw).view(np.uint32)[..., 0]   # (4 regs, 32)
                            a_regs = np.stack(_decode_words(cw, plan.g), 0)      # (g, 4, 32)
                            off = 32 * s + 8 * tq
                            for j in range(plan.g):
                                for nt in range(-(-nv // 8)):
                                    rows = aq[j, 8 * nt + gid]                     # (32, width)
                                    b8 = rows[lanes[:, None], off[:, None] + np.arange(8)]
                                    b_regs = np.ascontiguousarray(b8).view(np.uint32)   # (32, 2)
                                    acc[w, nt] += _mma(a_regs[j].T, b_regs)
                blk = acc.transpose(0, 2, 1, 3).reshape(plan.bm, plan.bn)
                rows = min(plan.bm, m - m0)
                ws[m0:m0 + rows, n0:n0 + nv] += blk[:rows, :nv]
    return ws


# (M, KG, N, g): ragged M and N, KG not divisible by the splits, the g=4
# segment of one K-group, a smollm-360m decode shape, and a plan of one
# split walked in two steps of 64 and 36 K-groups
EMU_CASES = [(70, 13, 17, 5), (130, 40, 20, 4), (320, 192, 4, 5), (70, 1, 3, 4), (1100, 100, 300, 5)]


@pytest.mark.parametrize("m,kg,n,g", EMU_CASES)
def test_emulated_integer_kernel_equals_plain(m, kg, n, g):
    rng = np.random.default_rng(m + kg + n)
    packed = rng.integers(0, 3 ** g, (m, kg)).astype(np.uint8)
    a_r = rng.integers(-127, 128, (g, kg, n)).astype(np.int8)
    plan = tdg.decode_plan(m, kg, n, g)
    got = _emulate(packed, a_r, plan, "int")
    want = tdg.ternary_decode_gemm_plain(torch.tensor(packed), torch.tensor(a_r), g=g)
    assert torch.equal(torch.tensor(got), want)


#: the new linears' smallest segments at exact-length N: out_proj's
#: 4-group g=4 segment (word loads), wo's 1-group one, wk's g=5 segment at
#: M 256
NEW_EMU_CASES = [(2048, 4, 61, 4), (1152, 1, 17, 4), (256, 228, 17, 5)]


@pytest.mark.parametrize("m,kg,n,g", NEW_EMU_CASES)
def test_emulated_kernels_on_the_new_segments(m, kg, n, g):
    """The integer and fused kernels, emulated with the plan the main path
    launches (word loads where KG % 4 == 0), equal their plain versions bit
    for bit."""
    rng = np.random.default_rng(m + kg + n + 2)
    packed = rng.integers(0, 3 ** g, (m, kg)).astype(np.uint8)
    aligned = kg % 4 == 0
    a_r = rng.integers(-127, 128, (g, kg, n)).astype(np.int8)
    plan = tdg.decode_plan(m, kg, n, g, codes_aligned=aligned, acts_aligned=aligned and n % 4 == 0)
    want = tdg.ternary_decode_gemm_plain(torch.tensor(packed), torch.tensor(a_r), g=g)
    assert torch.equal(torch.tensor(_emulate(packed, a_r, plan, "int")), want)
    x = torch.tensor((rng.standard_normal((n, kg * g)) * 3).astype(np.float32)).to(torch.bfloat16)
    a_scale = act_token_scale(x.T).contiguous()
    w_scale = torch.tensor(rng.random(m).astype(np.float32))
    plan = tdg.decode_plan(m, kg, n, g, codes_aligned=aligned, acts_aligned=aligned)
    acc = _emulate(packed, x.float().numpy(), plan, "fused", a_scale.numpy())
    got = tdg.epilogue(torch.tensor(acc).T, w_scale, a_scale, torch.bfloat16)
    want = tdg.ternary_decode_gemm_fused_plain(torch.tensor(packed), x, a_scale, w_scale,
                                               g=g, out_dtype=torch.bfloat16)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("m,kg,n,g", EMU_CASES[:4])
def test_emulated_fused_kernel_equals_plain(m, kg, n, g, dt):
    rng = np.random.default_rng(m + kg + n + 1)
    packed = rng.integers(0, 3 ** g, (m, kg)).astype(np.uint8)
    x = torch.tensor((rng.standard_normal((n, kg * g)) * 3).astype(np.float32)).to(dt)
    a_scale = act_token_scale(x.T).contiguous()
    w_scale = torch.tensor(rng.random(m).astype(np.float32))
    plan = tdg.decode_plan(m, kg, n, g)
    acc = _emulate(packed, x.float().numpy(), plan, "fused", a_scale.numpy())
    got = tdg.epilogue(torch.tensor(acc).T, w_scale, a_scale, dt)
    want = tdg.ternary_decode_gemm_fused_plain(torch.tensor(packed), x, a_scale, w_scale,
                                               g=g, out_dtype=dt)
    assert torch.equal(got, want)


# ---- the grouped kernel's block order, emulated ---------------------------

def _table_hi():
    """The 64-bit table's high words: byte 0 = trit 4 of code c."""
    return np.array([((c // 81) % 3 - 1) & 0xFF for c in range(256)], np.uint32)


TABLE_HI = _table_hi()


def _decode_words2(w, g):
    """`decode_word2`: the low words as `decode_word`'s table, trit 4 from
    byte 0 of the 4 codes' high words by three __byte_perm."""
    lo = [TABLE[(w >> np.uint32(8 * i)) & np.uint32(0xFF)] for i in range(4)]
    out = _transpose4(lo)[:g]
    if g == 5:
        hi = [TABLE_HI[(w >> np.uint32(8 * i)) & np.uint32(0xFF)] for i in range(4)]
        out.append(_byte_perm(_byte_perm(hi[0], hi[1], 0x0040), _byte_perm(hi[2], hi[3], 0x0040),
                              0x5410))
    return out


@pytest.mark.parametrize("g", [4, 5])
def test_grouped_trit_table_equals_unpack_ternary(g):
    """The grouped kernel's 64-bit table decodes every byte value as the
    plain version does."""
    codes = np.arange(256, dtype=np.uint8)
    words = codes.reshape(64, 4).view(np.uint32)[:, 0]
    dec = np.stack([_bytes(t) for t in _decode_words2(words, g)], -1)
    want = unpack_ternary(torch.tensor(codes[:, None]), g).numpy()
    assert np.array_equal(dec.reshape(256, g), want)


def _words(buf, offs):
    """Little-endian uint32 of the 4 bytes at each offset of a uint8 buffer."""
    b = buf[offs[..., None] + np.arange(4)].astype(np.uint32)
    return b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16 | b[..., 3] << 24


def _mma_warps(a_regs, b_regs):
    """`_mma` for every warp at once: a_regs (W, 32, 4), b_regs (32, 2)."""
    a = _bytes(a_regs).astype(np.int32)[:, A_MAP[0], A_MAP[1], A_MAP[2]]
    return a @ _bytes(b_regs).astype(np.int32)[B_MAP]


def _slot_swizzle(r):
    """`slot_swizzle`: the XOR of row r's 32-byte chunks, its place among
    the rows sharing a 128-byte bank window."""
    step = tdg.GROUP_STEP
    return ((r // (128 // step)) & (step // 32 - 1)) << 5


def _slot_at(r, c):
    """`slot_at`: byte c of row r of a slot (rows GROUP_STEP bytes
    apart, chunks swizzled)."""
    return r * tdg.GROUP_STEP + (c ^ _slot_swizzle(r))


def _emulate_grouped(packed, a, plan, kind, a_scale=None, seed=0):
    """The grouped kernel's block order and arithmetic: the plan's blocks
    run one at a time in a seeded random order (so that a split arrives
    first, last or skipped in any order); each stages its token tile's
    K-slice once an expert into a flat aq[j][n][kk] buffer (row stride
    `grouped_row_bytes`, garbage where the kernel never writes), checks it
    for a nonzero value (the zero-tile skip); then each warp streams its
    32-row slabs (slab w, w + 16, ...) through its own slot holding
    stale bytes (rows at `_slot_at`, or one contiguous run where
    `packed_rows`), reads the A words of its two m16 tiles at the kernel's
    offsets (8 unaligned bytes in a packed run), decodes them with the
    64-bit table, reads B at its offsets, and sums one mma per trit, tile
    and n8 tile. A slab's sums go to the output (S = 1) or into an int32
    workspace whose last arriving split writes the output and returns it
    and its counter to 0. Returns (int32 sums (E, M, N), workspace,
    counters, blocks that skipped)."""
    e, m, kg = packed.shape
    n, g, bn = plan.n, plan.g, plan.bn
    warps = tdg.GROUP_THREADS // 32
    rng = np.random.default_rng(seed)
    out = np.full((e, m, n), -(2 ** 31), np.int64)
    ws = np.zeros((e, m, n), np.int64)
    counters = np.zeros((e, plan.m_tiles * plan.n_tiles), np.int64)
    longest = max(hi - lo for lo, hi in (plan.kgroups(z) for z in range(plan.splits)))
    rs = tdg.grouped_row_bytes(longest)
    slot_bytes = tdg.GROUP_SLAB * tdg.GROUP_STEP
    lanes = np.arange(32)
    gid, tq = lanes // 4, lanes % 4
    rows_h = 16 * np.arange(2)[:, None] + gid[None, :]                # (2 tiles, 32)
    swz = _slot_swizzle(gid)
    blocks = [(x, y, z) for x in range(plan.m_tiles) for y in range(plan.n_tiles)
              for z in range(plan.e_groups * plan.splits)]
    skipped = 0
    for bi in rng.permutation(len(blocks)):
        x, y, z = blocks[bi]
        eg, split = divmod(z, plan.splits)
        r0, r1 = plan.rows(x)
        n0, n1 = plan.tokens(y)
        rv, nv = r1 - r0, n1 - n0
        nact = -(-nv // 8)
        kg_lo, kg_hi = plan.kgroups(split)
        nk = kg_hi - kg_lo
        width = -(-nk // 32) * 32
        slots = rng.integers(0, 256, (warps, slot_bytes + 16)).astype(np.uint8)
        aq = rng.integers(-128, 128, g * bn * rs).astype(np.int8)
        tile = y * plan.m_tiles + x
        nslab = -(-rv // tdg.GROUP_SLAB)
        nsteps = 1 if plan.packed_rows else -(-nk // tdg.GROUP_STEP)
        for ex in range(*plan.experts(eg)):
            # stage the slice: tokens [0, 8 nact) x columns [0, width)
            blk = np.zeros((g, 8 * nact, width), np.int8)
            if kind == "int":
                blk[:, :nv, :nk] = a[ex][:, kg_lo:kg_hi, n0:n1].transpose(0, 2, 1)
            else:
                xs = a[ex][n0:n1, kg_lo * g:kg_hi * g].astype(np.float32)
                q = np.clip(np.rint(xs / a_scale[ex][n0:n1, None]), -127, 127).astype(np.int8)
                blk[:, :nv, :nk] = q.reshape(nv, nk, g).transpose(2, 0, 1)
            for j in range(g):
                for t in range(8 * nact):
                    aq[(j * bn + t) * rs:(j * bn + t) * rs + width] = blk[j, t]
            aqu = aq.view(np.uint8)
            skip = not blk.any()
            skipped += skip
            if skip:
                if plan.splits == 1:
                    out[ex, r0:r1, n0:n1] = 0
            for w in range(warps):
                slot = slots[w]
                if skip:
                    continue
                for t in range(w, nslab, warps):
                    m0 = r0 + t * tdg.GROUP_SLAB
                    rows = min(tdg.GROUP_SLAB, r1 - m0)
                    acc = np.zeros((2, 2, 16, 8), np.int64)
                    for k in range(nsteps):
                        kk0 = k * tdg.GROUP_STEP
                        ln = min(tdg.GROUP_STEP, nk - kk0)
                        if plan.packed_rows:
                            slot[:rows * kg] = packed[ex, m0:m0 + rows].ravel()
                        else:
                            for r in range(rows):
                                slot[_slot_at(r, np.arange(ln))] = \
                                    packed[ex, m0 + r, kg_lo + kk0:kg_lo + kk0 + ln]
                        for s in range(min(tdg.GROUP_STEP // 32, -(-(nk - kk0) // 32))):
                            if plan.packed_rows:
                                off = s * 32 + 8 * tq[None, :]
                                lo, hi = rows_h * kg + off, (rows_h + 8) * kg + off
                            else:
                                off = ((s * 32) ^ swz)[None, :] + 8 * tq[None, :]
                                lo = rows_h * tdg.GROUP_STEP + off
                                hi = (rows_h + 8) * tdg.GROUP_STEP + off
                            cur = np.stack([_words(slot, lo), _words(slot, hi), _words(slot, lo + 4),
                                            _words(slot, hi + 4)], -1)            # (2, 32, 4)
                            a_regs = _decode_words2(cur, g)                        # g x (2, 32, 4)
                            for j in range(g):
                                for nt in range(nact):
                                    bo = (j * bn + nt * 8 + gid) * rs + kk0 + s * 32 + 8 * tq
                                    b_regs = np.stack([_words(aqu, bo), _words(aqu, bo + 4)], -1)
                                    acc[:, nt] += _mma_warps(a_regs[j], b_regs)
                    sums = acc.transpose(0, 2, 1, 3).reshape(32, 16)[:rows, :nv]
                    if plan.splits > 1:
                        ws[ex, m0:m0 + rows, n0:n1] += sums
                    else:
                        out[ex, m0:m0 + rows, n0:n1] = sums
            if plan.splits > 1:
                counters[ex, tile] += 1
                if counters[ex, tile] == plan.splits:
                    out[ex, r0:r1, n0:n1] = ws[ex, r0:r1, n0:n1]
                    ws[ex, r0:r1, n0:n1] = 0
                    counters[ex, tile] = 0
    assert out.min() >= -(2 ** 31) + 1, "an output the emulated kernel never wrote"
    return out.astype(np.int32), ws, counters, skipped


def _grouped_operands(e, m, kg, g, n, seed, zero_expert=None):
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 3 ** g, (e, m, kg)).astype(np.uint8)
    a_r = rng.integers(-127, 128, (e, g, kg, n)).astype(np.int8)
    x = (rng.standard_normal((e, n, kg * g)) * 3).astype(np.float32)
    if zero_expert is not None:                 # an expert with no real row
        a_r[zero_expert] = 0
        x[zero_expert] = 0
    a_r[..., -1] = 0                            # every expert's padding token
    x[:, -1] = 0
    return packed, a_r, x, rng


#: (E, M, KG, g, C): split-K with a ragged last K-slice and 2 token tiles;
#: packed-row tails of 2, 13 and 40 K-groups with several experts a block;
#: several steps a slab, split and not, and warps of two slabs (M 600);
#: C 5, 9 and 17; an all-zero expert beside full ones in each
GROUPED_EMU_CASES = [(3, 130, 300, 5, 17), (5, 300, 2, 4, 5), (3, 70, 13, 5, 16),
                     (2, 260, 270, 4, 4), (2, 64, 40, 5, 16), (2, 600, 200, 5, 9)]


def _emu_plan(e, m, kg, g, n):
    """The grouped plan, with one block an expert's rows, a tail's experts
    taken 2 a block, and the splits forced up where the plan does not split
    at the case's small E (so that split-K arrivals are emulated)."""
    p = tdg.grouped_decode_plan(m, kg, n, g, e)
    # one block an expert's rows, as at E 256, and a tail's experts 2 a block
    p = dataclasses.replace(p, bm=-(-m // tdg.GROUP_ROWS) * tdg.GROUP_ROWS)
    if p.packed_rows and e > 1:
        p = dataclasses.replace(p, ex=2)
    if p.splits == 1 and kg // tdg.GROUP_STEP >= 2:
        s = kg // tdg.GROUP_STEP
        longest = max(tdg._gsplit_bound(z + 1, kg, s) - tdg._gsplit_bound(z, kg, s) for z in range(s))
        p = dataclasses.replace(p, splits=s, smem=tdg.grouped_decode_smem_bytes(g, p.bn, longest))
    return p


@pytest.mark.parametrize("e,m,kg,g,n", GROUPED_EMU_CASES)
def test_emulated_grouped_integer_kernel_equals_plain(e, m, kg, g, n):
    """The grouped integer kernel's block order, emulated, equals
    `ternary_decode_gemm_grouped` (its plain version on the CPU) and E
    single integer calls bit for bit, with expert 1 all zero; the zero
    blocks skip their codes, and split-K leaves the workspace and counters
    zeroed."""
    packed, a_r, _, _ = _grouped_operands(e, m, kg, g, n, e + m + kg, zero_expert=1)
    plan = _emu_plan(e, m, kg, g, n)
    got, ws, counters, skipped = _emulate_grouped(packed, a_r, plan, "int", seed=m)
    want = tdg.ternary_decode_gemm_grouped(torch.tensor(packed), torch.tensor(a_r), g=g)
    assert torch.equal(torch.tensor(got), want)
    for i in range(e):
        assert torch.equal(want[i], tdg.ternary_decode_gemm(torch.tensor(packed[i]),
                                                            torch.tensor(a_r[i]), g=g))
    assert skipped >= plan.m_tiles * plan.n_tiles * plan.splits // plan.ex
    assert not ws.any() and not counters.any()


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("e,m,kg,g,n", GROUPED_EMU_CASES)
def test_emulated_grouped_fused_kernel_equals_plain(e, m, kg, g, n, dt):
    """The grouped fused kernel's block order, emulated (the quantizer as
    the kernel's: f32 cast, IEEE division, round half to even, clip +-127),
    through the epilogue, equals `ternary_decode_gemm_fused_grouped` (its
    plain version on the CPU) bit for bit, with expert 1 all zero."""
    packed, _, x, rng = _grouped_operands(e, m, kg, g, n, e + m + kg + 1, zero_expert=1)
    xt = torch.tensor(x).to(dt)
    a_scale = torch.stack([act_token_scale(xt[i].T) for i in range(e)]).contiguous()
    w_scale = torch.tensor(rng.random((e, m)).astype(np.float32))
    plan = _emu_plan(e, m, kg, g, n)
    acc, ws, _, skipped = _emulate_grouped(packed, xt.float().numpy(), plan, "fused",
                                           a_scale.numpy(), seed=n)
    got = tdg.epilogue(torch.tensor(acc).transpose(1, 2), w_scale, a_scale, dt)
    want = tdg.ternary_decode_gemm_fused_grouped(torch.tensor(packed), xt, a_scale, w_scale,
                                                 g=g, out_dtype=dt)
    assert torch.equal(got, want)
    assert skipped >= 1 and not ws.any()


@pytest.mark.parametrize("e,m,kg,g,n", [(2, 130, 300, 5, 16), (3, 300, 2, 4, 4)])
def test_emulated_grouped_saturated_sums(e, m, kg, g, n):
    """All +1 weights and activations 127, beside an all-zero expert: every
    sum of a full expert is 127*K, exact in int32, split-K included."""
    packed = np.full((e, m, kg), 3 ** g - 1, np.uint8)
    a_r = np.full((e, g, kg, n), 127, np.int8)
    a_r[0] = 0
    plan = _emu_plan(e, m, kg, g, n)
    got, *_ = _emulate_grouped(packed, a_r, plan, "int", seed=kg)
    assert not got[0].any() and got[1:].min() == got[1:].max() == 127 * kg * g


def test_emulated_grouped_cases_reach_every_mode():
    plans = [_emu_plan(*c) for c in GROUPED_EMU_CASES]
    assert any(p.splits > 1 for p in plans) and any(p.packed_rows for p in plans)
    assert any(p.ex > 1 for p in plans) and any(p.n_tiles > 1 for p in plans)
    assert any(p.m > tdg.GROUP_ROWS for p in plans)        # a warp walks two slabs
    assert any(p.splits == 1 and not p.packed_rows and p.kg > tdg.GROUP_STEP for p in plans)


def test_emulated_saturated_sums_at_the_largest_split():
    """All +1 weights and activations 127 at the plan with the most K-splits
    on smollm-360m's shapes: every sum is 127*K, exact in int32."""
    m, kg, n = max(((m, k // 5, n) for m, k in SMOLLM for n in (1, 4, 16, 64, 256)),
                   key=lambda s: tdg.decode_plan(*s, 5).splits)
    plan = tdg.decode_plan(m, kg, n, 5)
    assert plan.splits > 1
    packed = np.full((m, kg), 3 ** 5 - 1, np.uint8)
    got = _emulate(packed, np.full((5, kg, n), 127, np.int8), plan, "int")
    assert got.min() == got.max() == 127 * kg * 5
