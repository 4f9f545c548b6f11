"""repro_torch.core and kernels.ref against the JAX package: packing,
quantization and the integer oracle, on inputs made from a numpy seed."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import packing as jpack  # noqa: E402
from repro.core import quantize as jquant  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import packing as tpack  # noqa: E402
from repro_torch.core import quantize as tquant  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

# K = 64 and 964 carry a g=4 segment (64 = 5*12 + 4, 964 = 5*192 + 4);
# all are multiples of 4, so each also packs as g=4 only ("i2")
KS = (60, 64, 160, 964)
# the JAX functions as its mpGeMM paths run them: under jit
_jit_act_quant_tokens = jax.jit(jquant.act_quant_tokens)
_jit_act_token_scale = jax.jit(jquant.act_token_scale)
_jit_ref_mpgemm = jax.jit(jref.ref_mpgemm)


def _weights(k, m=24, seed=0):
    rng = np.random.default_rng(seed + k)
    return rng.standard_normal((m, k)).astype(np.float32)


def _acts(k, n=7, seed=1):
    rng = np.random.default_rng(seed + k)
    return (rng.standard_normal((k, n)) * 2.5).astype(np.float32)


def test_sign_matrix_and_group_sizes():
    for g in (4, 5):
        np.testing.assert_array_equal(tpack.sign_matrix(g), jpack.sign_matrix(g))
    for k in list(range(12, 200)) + list(KS):
        assert tpack.pack_group_sizes(k) == jpack.pack_group_sizes(k)


@pytest.mark.parametrize("k", KS)
def test_ternary_quantize(k):
    """Ternary values bit-identical. The absmean scale agrees to a few ulp
    (rtol 1e-6), not bit for bit: XLA sums |w| in its own order and rewrites mean's divide
    by K into a multiply by 1/K, torch sums in another order and divides."""
    w = _weights(k)
    jt = jquant.ternary_quantize(jnp.asarray(w))
    tt = tquant.ternary_quantize(torch.from_numpy(w))
    np.testing.assert_array_equal(tt.values.numpy(), np.asarray(jt.values))
    np.testing.assert_allclose(tt.scale.numpy(), np.asarray(jt.scale), rtol=1e-6, atol=0)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("mode", ["auto", "i2"])
def test_packed_bytes_equal(k, mode):
    w = _weights(k)
    jt = jquant.ternary_quantize(jnp.asarray(w))
    values = np.asarray(jt.values)
    scale = np.asarray(jt.scale)
    jp = jpack.pack_weight(jnp.asarray(values), jnp.asarray(scale), mode)
    tp = tpack.pack_weight(torch.tensor(values), torch.tensor(scale), mode)
    np.testing.assert_array_equal(tp.packed5.numpy(), np.asarray(jp.packed5))
    np.testing.assert_array_equal(tp.packed4.numpy(), np.asarray(jp.packed4))
    np.testing.assert_array_equal(tp.scale.numpy(), np.asarray(jp.scale))
    assert (tp.K, tp.k5, tp.k4, tp.M) == (jp.K, jp.k5, jp.k4, jp.M)
    assert tp.bits_per_weight == jp.bits_per_weight
    np.testing.assert_array_equal(tp.unpack().numpy(), values)


@pytest.mark.parametrize("k", KS)
def test_act_quant_tokens_bit_identical(k):
    """Against the quantizer as every JAX mpGeMM path runs it, under
    `jax.jit`: there XLA turns the scale's division by 127 into a product
    with the f32 reciprocal, which the port's scale follows."""
    a = _acts(k)
    a[:, 0] = 0.0  # an all-zero token takes the 1e-6 floor
    jq, js = _jit_act_quant_tokens(jnp.asarray(a))
    tq, ts = tquant.act_quant_tokens(torch.from_numpy(a))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tquant.act_token_scale(torch.from_numpy(a)).numpy(),
        np.asarray(_jit_act_token_scale(jnp.asarray(a))))


@pytest.mark.parametrize("k", KS)
def test_ref_mpgemm_int_exact(k):
    rng = np.random.default_rng(k)
    values = rng.integers(-1, 2, (24, k)).astype(np.int8)
    a_q = rng.integers(-127, 128, (k, 5)).astype(np.int8)
    scale = np.ones((24,), np.float32)
    jp = jpack.pack_weight(jnp.asarray(values), jnp.asarray(scale))
    tp = tpack.pack_weight(torch.from_numpy(values), torch.from_numpy(scale))
    want = np.asarray(jref.ref_mpgemm_int(jp, jnp.asarray(a_q)))
    got = tref.ref_mpgemm_int(tp, torch.from_numpy(a_q))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), values.astype(np.int64) @ a_q.astype(np.int64))


@pytest.mark.parametrize("k", KS)
def test_ref_mpgemm_float(k):
    """Float oracle: same int result, same f32 scale order → bit equal to
    the JAX oracle under `jax.jit`, the form its kernels run (its scale is
    then the product with the f32 reciprocal of 127, see
    test_act_quant_tokens_bit_identical)."""
    w, a = _weights(k), _acts(k)
    jt = jquant.ternary_quantize(jnp.asarray(w))
    jp = jpack.pack_weight(jt.values, jt.scale)
    tp = tpack.pack_weight(torch.tensor(np.asarray(jt.values)),
                           torch.tensor(np.asarray(jt.scale)))
    np.testing.assert_array_equal(tref.ref_mpgemm(tp, torch.from_numpy(a)).numpy(),
                                  np.asarray(_jit_ref_mpgemm(jp, jnp.asarray(a))))
