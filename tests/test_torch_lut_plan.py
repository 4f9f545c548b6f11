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
from repro_torch.kernels import ops  # noqa: E402
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


def _cover(ranges, total):
    """The ranges, in order, tile [0, total) with no gap or overlap."""
    pos = 0
    for lo, hi in ranges:
        assert lo == pos and hi > lo, (ranges, total)
        pos = hi
    assert pos == total


@pytest.mark.parametrize("m,kg,n,g", COVER_CASES)
def test_plan_tiles_cover_exactly(m, kg, n, g):
    p = vlg.lut_plan(m, kg, n, g)
    assert p.bm % vlg.BM_UNIT == 0 and 1 <= p.splits <= kg and p.chunk >= 1
    _cover([p.rows(x) for x in range(p.m_tiles)], m)
    _cover([p.tokens(y) for y in range(p.n_tiles)], n)
    _cover([p.kgroups(z) for z in range(p.splits)], kg)


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
                                      (130, 40, 256, 5)])
def test_split_k_sums_equal_the_plain_version(m, kg, n, g):
    rng = np.random.default_rng(m + kg + n)
    packed = torch.tensor(rng.integers(0, 3 ** g, (m, kg)).astype(np.uint8))
    a_r = torch.tensor(rng.integers(-127, 128, (g, kg, n)).astype(np.int8))
    p, got = _tiled_plain(packed, a_r, g)
    assert p.splits > 1 or p.n_tiles > 1
    assert torch.equal(got, vlg.vlut_lookup_gemm_plain(packed, a_r, g=g))
