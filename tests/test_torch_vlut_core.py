"""repro_torch.core.vlut (the paper's Algorithm 1) and repro_torch.core.baselines
against the JAX package's functions on the same numpy inputs. The integer
paths must be exact; `mad_gemm` skips activation quantization and gets the
JAX suite's own tolerance against the quantized oracle."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import core as jc  # noqa: E402
from repro_torch import core as tc  # noqa: E402
from repro_torch.core import baselines as tb  # noqa: E402


def _packed(m, k, seed=0):
    """(JAX PackedWeight, port PackedWeight) of the same random weights."""
    rng = np.random.default_rng(seed)
    tw = jc.ternary_quantize(jnp.asarray(rng.standard_normal((m, k)).astype(np.float32)))
    jp = jc.pack_weight(tw.values, tw.scale)
    tp = tc.PackedWeight(torch.tensor(np.asarray(jp.packed5)), torch.tensor(np.asarray(jp.packed4)),
                         torch.tensor(np.asarray(jp.scale)), K=jp.K)
    return jp, tp


def _acts(k, n, seed=1):
    return np.random.default_rng(seed).standard_normal((k, n)).astype(np.float32)


def _int_acts(k, n, seed=2):
    return np.random.default_rng(seed).integers(-127, 128, (k, n)).astype(np.int8)


PRECOMPUTES = {
    "matmul": (jc.precompute_lut, tc.precompute_lut),
    "topological": (jc.precompute_lut_topological, tc.precompute_lut_topological),
    "naive": (jc.precompute_lut_naive, tc.precompute_lut_naive),
}


@pytest.mark.parametrize("g", [4, 5])
@pytest.mark.parametrize("name", sorted(PRECOMPUTES))
def test_precompute_tables_equal(g, name):
    """Each precompute gives JAX's table, bit for bit, in int16."""
    a_q = _int_acts(3 * g, 5, seed=g)
    jfn, tfn = PRECOMPUTES[name]
    want = np.asarray(jfn(jnp.asarray(a_q), g))
    got = tfn(torch.from_numpy(a_q), g)
    assert got.dtype == torch.int16 and got.shape == (3, 3 ** g, 5)
    np.testing.assert_array_equal(got.numpy(), want)


def test_precompute_int16_saturated():
    """Worst-case activations stay within int16 (|a| <= 127, g <= 5)."""
    for g in (4, 5):
        a_q = torch.full((g, 2), 127, dtype=torch.int8)
        for _, tfn in PRECOMPUTES.values():
            assert int(tfn(a_q, g).max()) == 127 * g


def test_precompute_rejects_ragged_k():
    with pytest.raises(ValueError):
        tc.precompute_lut(torch.zeros((7, 2), dtype=torch.int8), 5)


@pytest.mark.parametrize("g", [4, 5])
@pytest.mark.parametrize("hier", [True, False])
def test_lookup_accumulate_matches_jax(g, hier):
    """The 1→N lookup over several INT16 blocks and a ragged last block,
    against JAX and against the dense integer product."""
    rng = np.random.default_rng(g + 10 * hier)
    m, kg, n = 16, 3 * tc.max_block_int16(g) + 2, 9
    w = rng.integers(-1, 2, (m, kg * g)).astype(np.int8)
    a_q = _int_acts(kg * g, n)
    packed = jc.pack_ternary(jnp.asarray(w), g)
    want = np.asarray(jc.lookup_accumulate(jc.precompute_lut(jnp.asarray(a_q), g), packed,
                                           hierarchical=hier, g=g))
    t = tc.precompute_lut(torch.from_numpy(a_q), g)
    got = tc.lookup_accumulate(t, torch.tensor(np.asarray(packed)), hierarchical=hier)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), w.astype(np.int32) @ a_q.astype(np.int32))


def test_max_block_int16_matches_jax():
    for g in (4, 5):
        assert tc.max_block_int16(g) == jc.max_block_int16(g)
        assert tc.max_block_int16(g) * 127 * g <= 32767


VARIANTS = [
    dict(),
    dict(streamed=False),
    dict(hierarchical=False),
    dict(precompute="topological"),
    dict(precompute="naive"),
    dict(token_contiguous=False),
    dict(k_tile_groups=4),
    dict(n_tile=8),
]


@pytest.mark.parametrize("kwargs", VARIANTS, ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "default")
@pytest.mark.parametrize("k", [60, 57])
def test_vlut_gemm_variants_match_jax(kwargs, k):
    """Every `vlut_gemm` variant equals JAX's same variant bit for bit: the
    same quantizer, exact integers, the same f32 dequant order. K = 57 has
    a g=5 and a g=4 segment, K = 60 only g=5."""
    jp, tp = _packed(32, k, seed=k)
    a = _acts(k, 16)
    want = np.asarray(jc.vlut_gemm(jp, jnp.asarray(a), **kwargs))
    got = tc.vlut_gemm(tp, torch.from_numpy(a), **kwargs)
    assert got.dtype == torch.float32 and got.shape == (32, 16)
    np.testing.assert_array_equal(got.numpy(), want)


def test_vlut_gemm_argument_checks():
    _, tp = _packed(8, 40)
    with pytest.raises(ValueError):
        tc.vlut_gemm(tp, torch.zeros((41, 2)))
    with pytest.raises(ValueError):
        tc.vlut_gemm(tp, torch.zeros((40, 2)), precompute="onehot")


@pytest.mark.parametrize("k", [40, 57])
@pytest.mark.parametrize("name", ["scalar_lut_gemm", "mad_gemm_int8"])
def test_integer_baselines_match_jax(name, k):
    """The scalar LUT and the int8 MAD equal JAX's bit for bit."""
    jp, tp = _packed(20, k, seed=k + 1)
    a = _acts(k, 7, seed=3)
    want = np.asarray(getattr(jc, name)(jp, jnp.asarray(a)))
    got = getattr(tc, name)(tp, torch.from_numpy(a))
    assert got.dtype == torch.float32 and got.shape == (20, 7)
    np.testing.assert_array_equal(got.numpy(), want)


def test_mad_gemm_close():
    """MAD in f32 skips activation quantization: against the quantized
    oracle only the JAX suite's loose bound holds; against JAX's own
    mad_gemm, f32 summation order (1e-5 relative)."""
    jp, tp = _packed(20, 40, seed=5)
    a = _acts(40, 7, seed=4)
    got = tc.mad_gemm(tp, torch.from_numpy(a)).numpy()
    oracle = np.asarray(jc.vlut_gemm(jp, jnp.asarray(a)))
    np.testing.assert_allclose(got, oracle, rtol=0.1, atol=0.15)
    want = np.asarray(jc.mad_gemm(jp, jnp.asarray(a)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_dense_gemm_f32_close():
    rng = np.random.default_rng(6)
    w = rng.standard_normal((12, 30)).astype(np.float32)
    a = rng.standard_normal((30, 5)).astype(np.float32)
    want = np.asarray(jc.dense_gemm_f32(jnp.asarray(w), jnp.asarray(a)))
    got = tc.dense_gemm_f32(torch.from_numpy(w), torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("n,m,k", [(1, 5, 13), (16, 8, 16), (17, 9, 40), (40, 24, 21)])
def test_int_mm_padding_is_exact(n, m, k):
    """`torch._int_mm`'s shape rules (more than 16 rows, K and M multiples
    of 8) met by zero padding: the product stays exact."""
    rng = np.random.default_rng(n * m + k)
    a = rng.integers(-127, 128, (n, k)).astype(np.int8)
    w = rng.integers(-127, 128, (m, k)).astype(np.int8)
    got = tb.int_mm(torch.from_numpy(a), torch.from_numpy(w))
    assert got.dtype == torch.int32 and got.shape == (n, m)
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ w.astype(np.int64).T)


def test_lut_gemm_auto_both_regimes():
    """Paper §6.3's switch: the scalar LUT below 8 tokens, the vector LUT
    from there; both equal JAX's."""
    jp, tp = _packed(24, 40, seed=7)
    for n in (1, 4, 16):
        a = _acts(40, n, seed=n)
        want = np.asarray(jc.lut_gemm_auto(jp, jnp.asarray(a)))
        got = tc.lut_gemm_auto(tp, torch.from_numpy(a))
        np.testing.assert_array_equal(got.numpy(), want)
        via = tc.scalar_lut_gemm if n < 8 else tc.vlut_gemm
        assert torch.equal(got, via(tp, torch.from_numpy(a)))
