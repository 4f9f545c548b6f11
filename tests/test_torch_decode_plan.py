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
import re

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import act_token_scale, pack_weight, ternary_quantize  # noqa: E402
from repro_torch.core.packing import unpack_ternary  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
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


COVER_CASES = (
    [(m, k // 5, n, 5) for m, k in SMOLLM for n in (1, 4, 16, 64, 256)]
    + [(70, 13, 17, 5), (1000, 77, 33, 5), (1000, 191, 17, 4), (70, 1, 3, 4),
       (2560, 512, 1000, 5)]
    + [(m, kg, n, g) for m, kg, g in _k964_segments() for n in (1, 4, 17, 256)]
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
