"""The flash kernel's launch plan (`kernels.flash_attention.flash_plan`) and
the tensor-core kernel's arithmetic, on the CPU: the plan covers every query
row and key tile, fits shared memory and agrees with the constants of
`csrc/flash_attention.cu`; the cp.async alignment predicate holds on the
views the model passes; the causal and window key-tile ranges are exactly
the tiles the mask leaves a valid key in; and a tiled emulation of the
kernel (its BQ and BK, its order of operations, P rounded to bf16) stays
within the bf16 tolerance of `chip_smoke.py` of the plain version over the
script's grid of flash cases at small S. The emulation lives here only:
nothing on the main path runs it. Inputs are made by numpy from a seed."""
import math
import re

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

# chip_smoke.py's flash grid: (H, KV, D), and its bf16 bound 2^-7 * max(1, max|want|)
FLASH_HEADS = [(15, 5, 64), (3, 3, 20), (6, 2, 32), (3, 1, 128)]
OPTIONS = [(c, w, sc) for c in (True, False) for w in (0, 24) for sc in (0.0, 20.0)]
BF16_TOL = 2.0 ** -7
SMEM_MAX = 232448                    # 227 KB: the most a block may take on an H100


def _views(b, s, h, kv, d, dtype=torch.bfloat16, contiguous=False):
    """q, k, v as the model passes them: transposed views of (B, S, ., D)
    tensors (or contiguous (B, ., S, D) ones), with an output laid out like q."""
    if contiguous:
        q, k, v = (torch.zeros((b, n, s, d), dtype=dtype) for n in (h, kv, kv))
    else:
        q, k, v = (torch.zeros((b, s, n, d), dtype=dtype).transpose(1, 2) for n in (h, kv, kv))
    return q, k, v, torch.empty_like(q)


def _plan(q, k, v, out, causal=True, window=0):
    return fa.plan_for(q, k, v, out, causal=causal, window=window)


@pytest.mark.parametrize("s", [1, 17, 256, 512, 2048])
@pytest.mark.parametrize("h,kv,d", FLASH_HEADS + [(2, 1, 256)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_plan_covers_every_query_row_and_key_tile(s, h, kv, d, dtype):
    b = 2
    for causal, window, _ in OPTIONS:
        p = _plan(*_views(b, s, h, kv, d, dtype), causal=causal, window=window)
        assert p.kernel == ("mma" if dtype == torch.bfloat16 and d <= 128 else "fma")
        if p.kernel == "mma":
            assert p.grid == (b * h, -(-s // p.bq), 1)
            tiles = sorted(p.query_tile(y) for y in range(p.grid[1]))
        else:
            assert p.grid == (-(-s // p.bq), h, b)
            tiles = sorted(p.query_tile(x) for x in range(p.grid[0]))
        assert tiles == list(range(-(-s // p.bq)))          # each query tile once
        rows = [r for qt in tiles for r in range(*p.rows(qt))]
        assert rows == list(range(s))                         # each query row once
        n_kt = -(-s // p.bk)
        for qt in tiles:
            kts = p.key_tiles(qt)
            assert 0 <= kts.start < kts.stop <= n_kt         # a block walks >= 1 tile


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_plan_shared_memory_fits(dtype):
    """Every D the wrapper takes: the plan's shared bytes fit 227 KB and are
    the sum of the kernel's tiles."""
    for d in range(1, 257):
        p = _plan(*_views(1, 8, 2, 1, d, dtype))
        assert 0 < p.smem <= SMEM_MAX
        if p.kernel == "mma":
            assert p.dp == max(16, 1 << (d - 1).bit_length())     # 16, 32, 64 or 128 >= D
            assert p.smem == 2 * p.dp * (p.bq + 2 * p.stages * p.bk)
        else:
            assert p.smem == 4 * ((p.bq + p.bk) * (d + 1) + p.bk * p.dp + p.bq * (p.bk + 1))


def test_plan_matches_kernel_constants():
    """The plan's tile constants are those of csrc/flash_attention.cu: the
    CUDA-core kernel's (namespace flash) and the tensor-core kernel's
    (namespace flash::tc); the C entry refuses any other plan."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    fma_src, tc_src = src.split("namespace tc {")

    def const(text, name):
        return int(re.search(r"constexpr int " + name + r" = (\d+);", text).group(1))

    assert (fa.FMA_BQ, fa.FMA_BK) == (const(fma_src, "kBQ"), const(fma_src, "kBK"))
    assert fa.MMA_BQ == 16 * const(tc_src, "kWarps")
    assert (fa.MMA_BK, fa.MMA_STAGES, fa.MMA_MAX_D) == (
        const(tc_src, "kBK"), const(tc_src, "kStages"), const(tc_src, "kMaxD"))


@pytest.mark.parametrize("d,want", [(64, True), (128, True), (32, True), (20, False)])
@pytest.mark.parametrize("contiguous", [False, True], ids=["model_view", "contiguous"])
def test_alignment_predicate(d, want, contiguous):
    """16-byte copies only where every pointer is 16-byte aligned and every
    stride a multiple of 8 elements: the model's transposed (B, S, H, D)
    views at D 64 and 128 are, D 20 is not (H * D = 60)."""
    assert _plan(*_views(2, 17, 3, 1, d, contiguous=contiguous)).aligned is want


def test_alignment_predicate_rejects_offset_pointers_and_strides():
    q, k, v, out = _views(2, 17, 15, 5, 64)
    assert _plan(q, k, v, out).aligned
    buf = torch.zeros(4 + q.numel(), dtype=torch.bfloat16)
    q8 = buf[4:].view(q.shape[0], q.shape[2], q.shape[1], 64).transpose(1, 2)   # 8-byte offset
    assert q8.data_ptr() % 16 == 8 and not _plan(q8, k, v, out).aligned
    wide = torch.zeros((2, 17, 15, 68), dtype=torch.bfloat16)[..., :64].transpose(1, 2)
    assert not _plan(wide, k, v, torch.empty_like(wide)).aligned          # stride 68
    assert not fa.copies_aligned(64, ((8, 8, 8),) * 4, (0, 0, 16, 2))
    assert fa.copies_aligned(64, ((8, 8, 8),) * 4, (0, 16, 32, 48))


@pytest.mark.parametrize("sq,sk", [(1, 1), (17, 17), (100, 100), (512, 512), (70, 130), (130, 70)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24), (False, 24), (False, 0), (True, 100)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_key_tile_ranges_match_the_mask(sq, sk, causal, window, dtype):
    """A block walks exactly the key tiles in which the mask leaves at
    least one valid key for one of its rows."""
    if window and sq > sk:
        return                                  # rows with no valid key: refused by the wrapper
    q = torch.zeros((1, 1, sq, 64), dtype=dtype)
    k = torch.zeros((1, 1, sk, 64), dtype=dtype)
    p = _plan(q, k, k, torch.empty_like(q), causal=causal, window=window)
    qp = torch.arange(sq)[:, None]
    kp = torch.arange(sk)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= qp - kp < window
    for qt in range(-(-sq // p.bq)):
        r0, r1 = p.rows(qt)
        valid = {kt for kt in range(-(-sk // p.bk))
                 if mask[r0:r1, kt * p.bk:(kt + 1) * p.bk].any()}
        assert set(p.key_tiles(qt)) == valid, (qt, p.key_tiles(qt), sorted(valid))


def emulate_mma_kernel(q, k, v, *, causal, window, softcap):
    """The tensor-core kernel's arithmetic in plain PyTorch: for each query
    tile of BQ rows, the key tiles of BK keys the plan walks, in order; S in
    f32 from the bf16 inputs; the max in the raw (or softcapped) domain with
    the scale folded into exp2; the finite -1e30 mask; p = 0 past Sk; l from
    the f32 p; P rounded to bf16 before P V in f32; out = acc * (1 / max(l,
    1e-30)) rounded to bf16."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    p = _plan(q, k, v, torch.empty_like(q), causal=causal, window=window)
    assert p.kernel == "mma"
    scale = d ** -0.5
    to_log2 = (1.0 if softcap else scale) * math.log2(math.e)
    qf, kf, vf = (t.float() for t in (q, k, v))
    out = torch.empty_like(q)
    for qt in range(p.grid[1]):
        r0, r1 = p.rows(qt)
        qpos = torch.arange(r0, r1)[:, None]
        qh = qf[:, :, r0:r1]                                          # (B, H, rows, D)
        m = torch.full((b, h, r1 - r0, 1), fa.NEG_INF)
        l = torch.zeros((b, h, r1 - r0, 1))
        acc = torch.zeros((b, h, r1 - r0, d))
        for kt in p.key_tiles(qt):
            k0 = kt * p.bk
            kpos = torch.arange(k0, k0 + p.bk)[None, :]
            kt_, vt_ = (torch.nn.functional.pad(t[:, :, k0:k0 + p.bk], (0, 0, 0, k0 + p.bk - min(sk, k0 + p.bk)))
                        for t in (kf, vf))                            # zero rows past Sk
            kt_, vt_ = (t.repeat_interleave(h // kv, dim=1) for t in (kt_, vt_))
            s = qh @ kt_.transpose(-1, -2)
            if softcap:
                s = torch.tanh(s * scale / softcap) * softcap
            ok = kpos < sk
            if causal:
                ok = ok & (kpos <= qpos)
            if window:
                ok = ok & (qpos - kpos < window)
            s = torch.where(ok, s, fa.NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2((m - m_new) * to_log2)
            pe = torch.where(kpos < sk, torch.exp2((s - m_new) * to_log2), 0.0)
            l = l * alpha + pe.sum(-1, keepdim=True)
            acc = acc * alpha + pe.to(torch.bfloat16).float() @ vt_
            m = m_new
        out[:, :, r0:r1] = (acc * (1.0 / l.clamp_min(1e-30))).to(q.dtype)
    return out


@pytest.mark.parametrize("s", [1, 17, 100])
@pytest.mark.parametrize("h,kv,d", FLASH_HEADS)
def test_tiled_emulation_matches_plain(s, h, kv, d):
    rng = np.random.default_rng(s * 1000 + d)
    b = 2
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, n, d)).astype(np.float32))
               .to(torch.bfloat16).transpose(1, 2) for n in (h, kv, kv))
    for causal, window, softcap in OPTIONS:
        kw = dict(causal=causal, window=window, softcap=softcap)
        got = emulate_mma_kernel(q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        assert got.dtype == want.dtype == torch.bfloat16
        err = (got.float() - want.float()).abs().max().item()
        bound = BF16_TOL * max(1.0, want.float().abs().max().item())
        assert err <= bound, (s, h, kv, d, kw, err, bound)
