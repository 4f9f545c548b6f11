"""The vector-LUT kernels' launch plan (`kernels.vlut_lookup_gemm.lut_plan`),
on the CPU: its tiles cover every output row, K-group and token exactly
once, it fills the H100's 132 SMs at every BitLinear shape of smollm-360m
at decode N, it splits K only where the tiles alone do not fill one wave,
and its shared memory fits a block. The split-K sums of its tiles, taken
with the plain version's table gather, equal the plain version bit for
bit."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import pack_weight, ternary_quantize  # noqa: E402
from repro_torch.core.packing import pack_group_sizes  # noqa: E402
from repro_torch.kernels import _splitk, ops  # noqa: E402
from repro_torch.kernels import vlut_lookup_gemm as vlg  # noqa: E402

#: smollm-360m's BitLinear shapes (M, K): q and o, k and v, gate and up, down
SMOLLM = [(960, 960), (320, 960), (2560, 960), (960, 2560)]


def _k964_segments():
    """(M, KG, g) of the K = 964 weight's two segments (192 g=5 groups, one
    g=4 group)."""
    w = torch.tensor(np.random.default_rng(0).standard_normal((960, 964)).astype(np.float32))
    tw = ternary_quantize(w)
    pw = pack_weight(tw.values, tw.scale)
    return [(p.shape[0], p.shape[1], g) for p, _, _, g in ops._segments(pw)]


# (M, KG, N, g): the main path, ragged M (70, 1000), KG not divisible by
# the chosen splits, N = 17 and 33, and the K = 964 weight's segments
COVER_CASES = (
    [(m, k // 5, n, 5) for m, k in SMOLLM for n in (1, 4, 16, 64, 256)]
    + [(70, 13, 17, 5), (1000, 77, 33, 5), (1000, 191, 17, 4), (70, 1, 3, 4),
       (130, 7, 33, 4), (65, 13, 17, 5), (2560, 512, 1000, 5)]
    + [(m, kg, n, g) for m, kg, g in _k964_segments() for n in (1, 4, 17, 256)]
)
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


NEW_CASES = [(m, kg, n, g) for mm, k in NEW_LINEARS for m, kg, g in _segments_of(mm, k)
             for n in ODD_N]


def _cover(ranges, total):
    """The ranges, in order, tile [0, total) with no gap or overlap."""
    pos = 0
    for lo, hi in ranges:
        assert lo == pos and hi > lo, (ranges, total)
        pos = hi
    assert pos == total


@pytest.mark.parametrize("m,kg,n,g", COVER_CASES + NEW_CASES)
def test_plan_tiles_cover_exactly(m, kg, n, g):
    p = vlg.lut_plan(m, kg, n, g)
    assert p.bm % vlg.BM_UNIT == 0 and 1 <= p.splits <= kg and p.chunk >= 1
    _cover([p.rows(x) for x in range(p.m_tiles)], m)
    _cover([p.tokens(y) for y in range(p.n_tiles)], n)
    _cover([p.kgroups(z) for z in range(p.splits)], kg)


#: grouped launches (E, M, KG, g, N): llama4-scout's routed experts at
#: decode, verify and prefill N; deepseek-v3-671b's 256 (w1/w3: M 2048, K
#: 7168 = 1432 g=5 + 2 g=4 groups; w2: M 7168, K 2048 = 408 + 2) at C 16;
#: and ragged traps (odd E, M off the tiles, N 5 and 17, KG not divisible
#: by the splits)
DEEPSEEK_EXPERTS = [(256, 2048, 1432, 5, 16), (256, 2048, 2, 4, 16),
                    (256, 7168, 408, 5, 16), (256, 7168, 2, 4, 16)]
GROUPED_CASES = (
    [(16, 8192, 1024, 5, n) for n in (4, 16, 64)]
    + [(16, 5120, 1636, 5, 16), (16, 5120, 3, 4, 16)]
    + DEEPSEEK_EXPERTS
    + [(3, 70, 13, 5, 5), (5, 130, 77, 4, 17), (3, 1000, 191, 5, 5), (1, 960, 192, 5, 4)]
)


def _best_filled(p) -> bool:
    """No other choice of the plan's rule fills the last wave better: K
    splits 1..KG/16 (a segment of one chunk: experts per block, at the
    fewest waves × experts a block)."""
    tiles = p.m_tiles * p.n_tiles
    if p.kg <= vlg.GROUP_CHUNK:
        cost = lambda x: -(-(-(-p.e // x) * tiles) // vlg.WAVE) * x  # noqa: E731
        return p.splits == 1 and cost(p.ex) == min(cost(x) for x in range(1, p.e + 1))
    effs = [vlg.wave_efficiency(p.e * tiles * s) for s in range(1, p.kg // vlg.GROUP_CHUNK + 1)]
    return p.ex == 1 and vlg.wave_efficiency(p.blocks) == max(effs)


@pytest.mark.parametrize("e,m,kg,g,n", GROUPED_CASES)
def test_grouped_plan_counts_the_experts(e, m, kg, g, n, monkeypatch):
    """A grouped plan covers each expert's rows, tokens and K-groups as a
    single plan does, counts E × tiles toward the wave (its grid fills its
    last wave to `WAVE_EFFICIENCY` at E >= 16 wherever it splits K or takes
    more than one wave, and is the best filled of its choices where none
    reaches it), and sizes the split-K workspace and counters for every
    expert."""
    p = vlg.grouped_lut_plan(m, kg, n, g, e)
    assert p.e == e and p.blocks == p.e_groups * p.m_tiles * p.n_tiles * p.splits
    _cover([p.rows(x) for x in range(p.m_tiles)], m)
    _cover([p.tokens(y) for y in range(p.n_tiles)], n)
    _cover([p.kgroups(z) for z in range(p.splits)], kg)
    _cover([p.experts(z) for z in range(p.e_groups)], e)
    tiles = e * p.m_tiles * p.n_tiles
    eff = vlg.wave_efficiency(p.blocks)
    assert eff >= vlg.WAVE_EFFICIENCY or _best_filled(p), p
    if e >= 16 and (p.splits > 1 or p.blocks > vlg.WAVE):
        assert eff >= vlg.WAVE_EFFICIENCY, p
    if p.splits > 1:    # the workspace the wrapper would pass, sized here on the CPU
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
        monkeypatch.setattr(_splitk, "_WORKSPACE", {})
        ws, counters = _splitk.launch_args(p, torch.device("cpu"))
        assert ws.numel() >= e * m * n and counters.numel() >= tiles
        assert not ws.any() and not counters.any()


def test_grouped_cases_include_a_split_k_launch():
    assert any(vlg.grouped_lut_plan(m, kg, n, g, e).splits > 1 for e, m, kg, g, n in GROUPED_CASES)


def test_cover_cases_include_uneven_splits():
    """At least one case splits KG unevenly and one splits into chunks."""
    plans = [vlg.lut_plan(*c) for c in COVER_CASES]
    assert any(p.kg % p.splits for p in plans)
    assert any(-(-p.kg // p.splits) > p.chunk for p in plans)


@pytest.mark.parametrize("n", [1, 4, 16])
@pytest.mark.parametrize("m,k", SMOLLM)
def test_plan_fills_the_card_at_decode_n(m, k, n):
    p = vlg.lut_plan(m, k // 5, n, 5)
    assert vlg.WAVE <= p.blocks <= 2 * vlg.WAVE, p


@pytest.mark.parametrize("n", [1, 4, 16, 17, 33, 64, 256, 1000, 4096])
def test_plan_splits_only_where_the_tiles_fall_short(n):
    """S = 1 where the tiles alone fill a wave; otherwise between one and two
    waves (as far as KG allows)."""
    for m, kg, g in [(m, k // 5, 5) for m, k in SMOLLM] + [(70, 13, 5), (1000, 77, 4), (8192, 512, 5)]:
        p = vlg.lut_plan(m, kg, n, g)
        tiles = p.m_tiles * p.n_tiles
        if tiles >= vlg.WAVE:
            assert p.splits == 1, p
        else:
            assert p.blocks >= min(vlg.WAVE, tiles * kg), p
            assert p.blocks <= 2 * vlg.WAVE, p


@pytest.mark.parametrize("m,kg,n,g", NEW_CASES)
def test_new_segments_plan_within_two_waves(m, kg, n, g):
    """At the new linears' segments and exact-length N, the plan fills the
    card without passing two waves where it splits K, and its shared memory
    is the kernel's formula within the budget."""
    p = vlg.lut_plan(m, kg, n, g)
    tiles = p.m_tiles * p.n_tiles
    assert p.splits == 1 or p.blocks <= 2 * vlg.WAVE, p
    assert p.blocks >= min(vlg.WAVE, tiles * kg), p
    assert p.smem == vlg.lut_smem_bytes(g, p.bm, p.chunk, 4 * vlg.tok_lanes(min(n, vlg.BN)))
    assert p.smem <= vlg.SMEM_BUDGET


def test_plan_aligns_splits_and_chunks_to_words():
    """Where KG % 4 == 0 and S <= KG/4, every K-slice and every chunk of it
    starts on a multiple of 4 K-groups, so the kernel reads the codes as
    32-bit words (the main path's prefill shapes are such plans)."""
    aligned = 0
    for m, k in SMOLLM:
        for n in (1, 4, 16, 64, 256):
            p = vlg.lut_plan(m, k // 5, n, 5)
            if 4 * p.splits > p.kg:
                continue
            aligned += 1
            for z in range(p.splits):
                lo, hi = p.kgroups(z)
                assert lo % 4 == 0 and (p.chunk % 4 == 0 or hi - lo <= p.chunk), p
    assert aligned >= 8


@pytest.mark.parametrize("g", [4, 5])
def test_plan_shared_memory_fits_a_block(g):
    for m in (70, 320, 960, 1000, 2560, 8192):
        for kg in (1, 7, 13, 192, 241, 512, 2048):
            for n in (1, 3, 4, 5, 8, 9, 16, 17, 64, 256, 4096):
                p = vlg.lut_plan(m, kg, n, g)
                bnt = 4 * vlg.tok_lanes(min(n, vlg.BN))
                assert p.smem == vlg.lut_smem_bytes(g, p.bm, p.chunk, bnt)
                assert p.smem <= vlg.SMEM_BUDGET <= 227 * 1024 - 1024, p
                # a thread's sums stay in registers: at most 8 rows of 4 tokens
                assert p.bm * bnt <= 8 * 256 * 4, p


def _tiled_plain(packed, a_r, g):
    """The kernel's decomposition on the CPU: per block of the plan, the
    plain table gather of its rows, tokens and K-groups (chunk by chunk),
    summed into one int32 output in block order."""
    m, kg = packed.shape
    n = a_r.shape[2]
    p = vlg.lut_plan(m, kg, n, g)
    out = torch.zeros((m, n), dtype=torch.int32)
    for x in range(p.m_tiles):
        r0, r1 = p.rows(x)
        for y in range(p.n_tiles):
            t0, t1 = p.tokens(y)
            for z in range(p.splits):
                k0, k1 = p.kgroups(z)
                for c0 in range(k0, k1, p.chunk):
                    c1 = min(k1, c0 + p.chunk)
                    out[r0:r1, t0:t1] += vlg.vlut_lookup_gemm_plain(
                        packed[r0:r1, c0:c1].contiguous(), a_r[:, c0:c1, t0:t1].contiguous(), g=g)
    return p, out


@pytest.mark.parametrize("m,kg,n,g", [(70, 13, 17, 5), (1000, 77, 33, 4), (320, 192, 4, 5),
                                      (130, 40, 256, 5), (2048, 4, 61, 4), (1152, 1, 200, 4),
                                      (256, 228, 17, 5)])
def test_split_k_sums_equal_the_plain_version(m, kg, n, g):
    rng = np.random.default_rng(m + kg + n)
    packed = torch.tensor(rng.integers(0, 3 ** g, (m, kg)).astype(np.uint8))
    a_r = torch.tensor(rng.integers(-127, 128, (g, kg, n)).astype(np.int8))
    p, got = _tiled_plain(packed, a_r, g)
    assert p.splits > 1 or p.n_tiles > 1
    assert torch.equal(got, vlg.vlut_lookup_gemm_plain(packed, a_r, g=g))


@pytest.mark.parametrize("e,m,kg,g,n", [(3, 70, 45, 5, 5), (5, 130, 77, 4, 17), (2, 256, 40, 5, 16)])
def test_grouped_integer_split_k_sums_equal_the_plain_version(e, m, kg, g, n):
    """The grouped integer kernel's decomposition: each expert's blocks of
    the grouped plan (its own rows, tokens, K-splits and chunks, summed into
    its own output slice) give `vlut_lookup_gemm_grouped` (its plain
    version on the CPU) and E single integer calls bit for bit; every case
    splits K."""
    rng = np.random.default_rng(e + m + kg)
    packed = torch.tensor(rng.integers(0, 3 ** g, (e, m, kg)).astype(np.uint8))
    a_r = torch.tensor(rng.integers(-127, 128, (e, g, kg, n)).astype(np.int8))
    p = vlg.grouped_lut_plan(m, kg, n, g, e)
    assert p.splits > 1
    want = vlg.vlut_lookup_gemm_grouped(packed, a_r, g=g)
    for i in range(e):
        got = torch.zeros((m, n), dtype=torch.int32)
        for x in range(p.m_tiles):
            r0, r1 = p.rows(x)
            for y in range(p.n_tiles):
                t0, t1 = p.tokens(y)
                for z in range(p.splits):
                    k0, k1 = p.kgroups(z)
                    for c0 in range(k0, k1, p.chunk):
                        c1 = min(k1, c0 + p.chunk)
                        got[r0:r1, t0:t1] += vlg.vlut_lookup_gemm_plain(
                            packed[i, r0:r1, c0:c1].contiguous(),
                            a_r[i, :, c0:c1, t0:t1].contiguous(), g=g)
        assert torch.equal(got, want[i])
        assert torch.equal(want[i], vlg.vlut_lookup_gemm(packed[i], a_r[i], g=g))


def _single_plan_rule(m, kg, n, g):
    """The single plan's rule, frozen as it was tuned on the card at
    smollm-360m's shapes: (bm, splits, chunk, smem)."""
    bnt = 4 * vlg.tok_lanes(min(n, 16))
    bm = min(256 if n <= 64 else 512, -(-m // 128) * 128)
    tiles = -(-m // bm) * -(-n // 16)
    fit = max(1, (110 * 1024 - 48) // (3 ** g * bnt * 2 + g * bnt + bm))
    splits = 1 if tiles >= 132 else min(kg, 2 * 132 // tiles)
    longest = max(vlg._split_bound(z + 1, kg, splits) - vlg._split_bound(z, kg, splits)
                  for z in range(splits))
    chunk = min(longest, fit)
    if chunk > 4 and kg % 4 == 0 and 4 * splits <= kg:
        chunk -= chunk % 4
    while chunk > 1 and vlg.lut_smem_bytes(g, bm, chunk, bnt) > 110 * 1024:
        chunk -= 1
    return bm, splits, chunk, vlg.lut_smem_bytes(g, bm, chunk, bnt)


@pytest.mark.parametrize("m,kg,n,g", COVER_CASES + NEW_CASES)
def test_single_plan_is_unchanged(m, kg, n, g):
    """`lut_plan` of one product (E = 1) keeps its rule: the single-launch
    kernels' plans do not move with the grouped plan."""
    p = vlg.lut_plan(m, kg, n, g)
    assert isinstance(p, vlg.LutPlan)
    assert (p.bm, p.splits, p.chunk, p.smem) == _single_plan_rule(m, kg, n, g)


#: grouped plan traps (E, M, KG, g, C): E × tiles just over a wave (133,
#: 134 and 140 tiles), M off the row tile (70, 1000), KG 1, 2, 3, 13 and
#: 77, C 1, 5, 17 and 64, and one-chunk segments that put several experts
#: in a block
GROUPED_TRAPS = (
    [(134, 1000, 64, 5, 16), (67, 2048, 200, 5, 16), (133, 70, 40, 4, 4), (140, 70, 2, 4, 1),
     (35, 4096, 77, 5, 5)]
    + [(e, m, kg, g, c) for e, m in ((3, 70), (16, 1000)) for kg in (1, 2, 3, 13, 77)
       for g in (4, 5) for c in (1, 5, 17, 64)]
)


@pytest.mark.parametrize("e,m,kg,g,n", GROUPED_TRAPS + GROUPED_CASES)
def test_grouped_plan_geometry(e, m, kg, g, n):
    """The grouped plan at its traps: an exact cover of every expert's rows,
    tokens and K-groups; K-splits at most KG/16 with every split starting
    on a multiple of 16 K-groups; chunks of 16 (or the whole segment);
    experts per block only for one-chunk segments; the grid's last wave
    filled to `WAVE_EFFICIENCY`, or the best its rule can fill; shared
    memory the kernel's formula within a block's 227 KB; at most 8 rows
    of 4 tokens a thread (32 int32 sums and 16 words of 16-bit lanes)."""
    p = vlg.grouped_lut_plan(m, kg, n, g, e)
    _cover([p.rows(x) for x in range(p.m_tiles)], m)
    _cover([p.tokens(y) for y in range(p.n_tiles)], n)
    _cover([p.kgroups(z) for z in range(p.splits)], kg)
    _cover([p.experts(z) for z in range(p.e_groups)], e)
    assert 1 <= p.splits <= max(1, kg // vlg.GROUP_CHUNK)
    assert p.splits == 1 or all(p.kgroups(z)[0] % vlg.GROUP_CHUNK == 0 for z in range(p.splits))
    assert p.chunk == min(vlg.GROUP_CHUNK, kg)
    assert p.ex == 1 or kg <= vlg.GROUP_CHUNK
    assert vlg.wave_efficiency(p.blocks) >= vlg.WAVE_EFFICIENCY or _best_filled(p), p
    assert p.e_groups * p.splits <= 65535
    bnt = 4 * vlg.tok_lanes(min(n, vlg.BN))
    assert p.bm % vlg.BM_UNIT == 0 and p.m_tiles == -(-m // (vlg.GROUP_THREADS * vlg.GROUP_ROWS * 4 // bnt))
    assert p.bm * bnt <= vlg.GROUP_ROWS * vlg.GROUP_THREADS * 4, p
    assert p.smem == vlg.grouped_smem_bytes(g, p.bm, p.chunk, bnt) <= 227 * 1024 - 1024, p


def test_grouped_traps_reach_every_branch():
    plans = [vlg.grouped_lut_plan(m, kg, n, g, e) for e, m, kg, g, n in GROUPED_TRAPS]
    assert any(p.ex > 1 for p in plans) and any(p.splits > 1 for p in plans)
    assert any(vlg.wave_efficiency(p.e * p.m_tiles * p.n_tiles) < 0.6 <= vlg.WAVE_EFFICIENCY
               <= vlg.wave_efficiency(p.blocks) for p in plans)     # just over a wave, split


def test_sixteen_bit_lanes_hold_a_flush():
    """A table entry is at most 5 * 128 in size (g <= 5, int8 activations),
    so GROUP_FLUSH chunks of 16 K-groups summed in a 16-bit lane stay in
    int16: the kernel adds two tokens per 32-bit word without carries."""
    assert vlg.GROUP_FLUSH * vlg.GROUP_CHUNK * 5 * 128 <= 2 ** 15 - 1


_M32 = (1 << 32) - 1


def _signed(v, bits):
    half = 1 << (bits - 1)
    return ((v & ((1 << bits) - 1)) ^ half) - half


def _emulated_grouped_int(packed, a_r, g, p):
    """The grouped kernel's arithmetic in numpy, block by block in the
    plan's order: per expert group and expert, M-tile, token tile and
    K-split, chunks of 16 K-groups; the table as 32-bit words of two 16-bit
    token lanes (word = T[t0] + 65536 T[t1] mod 2^32), the gathered words
    summed mod 2^32 and decoded into int32 sums every GROUP_FLUSH chunks.
    packed (E, M, KG) uint8, a_r (E, g, KG, N) int8 → (E, M, N) int64."""
    e_, m, kg = packed.shape
    n = a_r.shape[-1]
    pats = np.arange(3 ** g)
    signs = np.stack([pats // 3 ** j % 3 - 1 for j in range(g)], axis=1)     # (3^g, g)
    out = np.zeros((e_, m, n), dtype=np.int64)
    for zg in range(p.e_groups):
        for e in range(*p.experts(zg)):
            for x in range(p.m_tiles):
                r0, r1 = p.rows(x)
                for y in range(p.n_tiles):
                    t0, t1 = p.tokens(y)
                    nv = t1 - t0
                    bnt = 4 * vlg.tok_lanes(nv)
                    for z in range(p.splits):
                        k0, k1 = p.kgroups(z)
                        acc = np.zeros((r1 - r0, bnt), dtype=np.int64)
                        pk = np.zeros((r1 - r0, bnt // 2), dtype=np.int64)
                        starts = list(range(k0, k1, vlg.GROUP_CHUNK))
                        for i, c0 in enumerate(starts):
                            c1 = min(k1, c0 + vlg.GROUP_CHUNK)
                            xs = np.zeros((c1 - c0, g, bnt), dtype=np.int64)
                            xs[..., :nv] = a_r[e, :, c0:c1, t0:t1].transpose(1, 0, 2)
                            words = (xs[..., 0::2] + (xs[..., 1::2] << 16)) & _M32  # (c, g, bnt/2)
                            table = np.einsum("pj,cjw->cpw", signs, words) & _M32  # (c, 3^g, bnt/2)
                            codes = packed[e, r0:r1, c0:c1].astype(np.int64)       # (rows, c)
                            picked = table[np.arange(c1 - c0)[None, :], codes]     # (rows, c, bnt/2)
                            pk = (pk + picked.sum(axis=1)) & _M32
                            if i % vlg.GROUP_FLUSH == vlg.GROUP_FLUSH - 1 or i + 1 == len(starts):
                                lo = _signed(pk, 16)
                                acc[:, 0::2] += lo
                                acc[:, 1::2] += _signed(pk - lo, 32) >> 16
                                pk[:] = 0
                        out[e, r0:r1, t0:t1] += acc[:, :nv]
    return out


#: (E, M, KG, g, C) of the emulation: splits and ragged tiles, several
#: experts a block, and enough chunks in one split for three flushes
EMULATED = [(3, 70, 45, 5, 5), (5, 130, 77, 4, 17), (2, 1000, 40, 5, 64), (140, 70, 2, 4, 1),
            (128, 70, 100, 5, 1), (7, 70, 1, 4, 3)]


@pytest.mark.parametrize("e,m,kg,g,n", EMULATED)
def test_grouped_int_decomposition_equals_the_plain_version(e, m, kg, g, n):
    """The emulated grouped integer kernel equals `vlut_lookup_gemm_plain`
    (expert by expert) bit for bit."""
    rng = np.random.default_rng(e * m + kg)
    packed = rng.integers(0, 3 ** g, (e, m, kg)).astype(np.uint8)
    a_r = rng.integers(-128, 128, (e, g, kg, n)).astype(np.int8)
    p = vlg.grouped_lut_plan(m, kg, n, g, e)
    want = vlg.vlut_lookup_gemm_plain(torch.tensor(packed), torch.tensor(a_r), g=g)
    assert np.array_equal(_emulated_grouped_int(packed, a_r, g, p), want.numpy())


@pytest.mark.parametrize("fill", [127, -128])
def test_grouped_int_decomposition_at_saturated_sums(fill):
    """All +1 weights and activations at an int8 extreme over 100 K-groups
    in one split (three flushes): each 16-bit lane reaches 48 * 5 * |fill|
    before a flush, and every sum is 5 * 100 * fill."""
    e, m, kg, g, n = 128, 70, 100, 5, 1
    p = vlg.grouped_lut_plan(m, kg, n, g, e)
    assert p.splits == 1 and -(-kg // vlg.GROUP_CHUNK) > 2 * vlg.GROUP_FLUSH
    packed = np.full((e, m, kg), 3 ** g - 1, dtype=np.uint8)
    a_r = np.full((e, g, kg, n), fill, dtype=np.int8)
    got = _emulated_grouped_int(packed, a_r, g, p)
    assert (got == g * kg * fill).all()


@pytest.mark.parametrize("e,m,kg,g,n", EMULATED[:4])
def test_grouped_fused_decomposition_equals_the_plain_version(e, m, kg, g, n):
    """The fused grouped kernel's arithmetic: each block quantizes its
    expert's tokens (`quantize_tokens`: f32 cast, IEEE division, round half
    to even, clip), sums as the emulated integer kernel, and applies the
    epilogue (acc * w_scale) * a_scale: equal to
    `vlut_lookup_gemm_fused_plain` bit for bit, f32 and bf16."""
    from repro_torch.kernels.ternary_decode_gemm import epilogue, quantize_tokens

    rng = np.random.default_rng(e + m + kg + n)
    packed = torch.tensor(rng.integers(0, 3 ** g, (e, m, kg)).astype(np.uint8))
    x32 = torch.tensor((rng.standard_normal((e, n, kg * g)) * 3).astype(np.float32))
    x32[:, -1] = 0                                  # a padding row of every expert
    w_scale = torch.tensor(rng.random((e, m)).astype(np.float32))
    p = vlg.grouped_lut_plan(m, kg, n, g, e)
    for dt in (torch.float32, torch.bfloat16):
        x = x32.to(dt)
        a_scale = x.float().abs().amax(-1).clamp_min(1e-6) / 127
        q = quantize_tokens(x, a_scale)                               # (E, N, K)
        a_r = q.reshape(e, n, kg, g).permute(0, 3, 2, 1).to(torch.int8).numpy()
        acc = torch.tensor(_emulated_grouped_int(packed.numpy(), a_r, g, p)).to(torch.int32)
        got = torch.stack([epilogue(acc[i].T, w_scale[i], a_scale[i], dt) for i in range(e)])
        want = vlg.vlut_lookup_gemm_fused_plain(packed, x, a_scale, w_scale, g=g, out_dtype=dt)
        assert torch.equal(got, want)
        assert not got[:, -1].any()
