"""The port's QAT training numerics against the JAX package: the STE
quantizers, and `lm_loss` with its gradients (AdamW and the data pipeline
are in tests/test_torch_optim.py). Inputs are made by numpy from a seed;
weights are carried by the bridge."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import quantize as jq  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.core import quantize as tq  # noqa: E402


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


# --------------------------------------------------------------------------
# STE quantizers
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fake_quant_forward_matches_jax(dtype):
    """fake_ternary(_cols), ternary_dequantize, act_quant_int8 and
    fake_act_quant. The absmean scale is a float mean summed in another
    order than XLA's (a few f32 ulp, ROADMAP C), so dequantized weights
    agree to 1e-6 relative; the ternary codes, the int8 codes and the
    activation path (amax, scale, divide, round half to even) agree exactly
    with jitted JAX, as the JAX train step runs it."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 40, 24)).astype(np.float32)
    a = (rng.standard_normal((5, 7, 40)) * 3).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jw, tw = jnp.asarray(w, jdt), torch.tensor(w).to(tdt)
    ja, ta = jnp.asarray(a, jdt), torch.tensor(a).to(tdt)
    tol = dict(rtol=1e-6, atol=1e-7) if dtype == "float32" else dict(rtol=2 ** -8, atol=1e-7)
    for jf, tf in ((jq.fake_ternary, tq.fake_ternary), (jq.fake_ternary_cols, tq.fake_ternary_cols)):
        got, want = tf(tw), jf(jw)
        assert got.dtype == tdt
        np.testing.assert_allclose(_np(got), _np(want), **tol)
    jt, tt = jq.ternary_quantize(jnp.asarray(w)), tq.ternary_quantize(torch.tensor(w))
    np.testing.assert_array_equal(tt.values.numpy(), np.asarray(jt.values))
    np.testing.assert_allclose(tq.ternary_dequantize(tt).numpy(),
                               np.asarray(jq.ternary_dequantize(jt)), rtol=1e-6)
    for axis in (-1, 0):
        _check_act_quant(ja, ta, axis)


# the JAX train step runs the activation quantizers under jit, where XLA
# multiplies by the f32 reciprocal of 127 instead of dividing
_jit_act_quant = jax.jit(jq.act_quant_int8, static_argnums=1)
_jit_fake_act_quant = jax.jit(jq.fake_act_quant, static_argnums=1)


def _check_act_quant(ja, ta, axis):
    """act_quant_int8 (codes and scales) and fake_act_quant bit for bit
    against the jitted JAX functions."""
    jqa, tqa = _jit_act_quant(ja, axis), tq.act_quant_int8(ta, axis)
    np.testing.assert_array_equal(tqa.values.numpy(), np.asarray(jqa.values))
    np.testing.assert_array_equal(tqa.scale.numpy(), np.asarray(jqa.scale))
    got, want = tq.fake_act_quant(ta, axis), _jit_fake_act_quant(ja, axis)
    assert got.dtype == ta.dtype
    np.testing.assert_array_equal(_np(got), _np(want))


def test_act_quant_matches_jitted_jax_where_eager_differs():
    """4096 tokens × 64 features (numpy seed 0, × 3): some per-token scales
    of eager JAX (a true division by 127) differ from the jitted ones (a
    product with its f32 reciprocal); the port equals the jitted form."""
    a = (np.random.default_rng(0).standard_normal((4096, 64)) * 3).astype(np.float32)
    ja, ta = jnp.asarray(a), torch.tensor(a)
    eager = np.asarray(jq.act_quant_int8(ja, -1).scale)
    jitted = np.asarray(_jit_act_quant(ja, -1).scale)
    assert (eager != jitted).sum() > 0
    _check_act_quant(ja, ta, -1)


@pytest.mark.parametrize("fn", ["fake_ternary", "fake_ternary_cols", "fake_act_quant"])
def test_fake_quant_gradient_is_identity(fn):
    """The straight-through estimator: d(sum(f(x) * r))/dx == r exactly."""
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.standard_normal((6, 32)).astype(np.float32), requires_grad=True)
    r = torch.tensor(rng.standard_normal((6, 32)).astype(np.float32))
    (g,) = torch.autograd.grad((getattr(tq, fn)(x) * r).sum(), x)
    assert torch.equal(g, r)


# --------------------------------------------------------------------------
# lm_loss and its gradients
# --------------------------------------------------------------------------
# f32: the same arithmetic in another summation order (loss and gradients
# agree to ~1e-6 of each leaf's largest entry on these inputs; an int8
# activation code at a rounding boundary could move, which these inputs do
# not hit). bf16: every intermediate rounds to 8 mantissa bits at places
# where the two frameworks sum in another order; each gradient leaf agrees
# to a few bf16 ulp of its largest entry, the loss to 1e-3.
LOSS_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-3, 5e-2)}


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def loss_case(request):
    dtype = request.param
    jcfg = jget_config("smollm-360m", smoke=True).with_(dtype=dtype, loss_chunk=32)
    tcfg = tget_config("smollm-360m", smoke=True).with_(dtype=dtype, loss_chunk=32)
    params = jm.init_lm(jax.random.PRNGKey(0), jcfg)
    model = bridge.lm_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    rng = np.random.default_rng(3)
    tok, lab = (rng.integers(0, jcfg.vocab, (2, 40)).astype(np.int32) for _ in range(2))
    mask = (rng.random((2, 40)) < 0.8).astype(np.float32)
    return dtype, jcfg, tcfg, params, model.requires_grad_(True), tok, lab, mask


@pytest.mark.parametrize("impl", ["auto", "flash"])
def test_lm_loss_and_grads_match_jax(loss_case, impl):
    """Chunked CE (S 40 in chunks of 32: one padded chunk) with a loss mask,
    through the QAT linears and per-layer remat, against
    jax.value_and_grad(lm_loss) (flash: the Pallas kernel in interpret
    mode); gradients compared leaf by leaf in JAX's stacked layout."""
    dtype, jcfg, tcfg, params, model, tok, lab, mask = loss_case
    jcfg, tcfg = jcfg.with_(attn_impl=impl), tcfg.with_(attn_impl=impl)
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: jm.lm_loss(p, jnp.asarray(tok), jnp.asarray(lab), jcfg,
                             loss_mask=jnp.asarray(mask)), has_aux=True)(params)
    tl, tmet = tm.lm_loss(model, torch.from_numpy(tok), torch.from_numpy(lab), tcfg,
                          loss_mask=torch.from_numpy(mask))
    named = dict(model.named_parameters())
    tg = bridge.to_jax_tree(dict(zip(named, torch.autograd.grad(tl, list(named.values())))), tcfg)
    loss_tol, grad_tol = LOSS_TOL[dtype]
    assert float(tmet["tokens"]) == float(jmet["tokens"]) == mask.sum()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=loss_tol)
    np.testing.assert_allclose(float(tmet["ce"].detach()), float(jmet["ce"]), rtol=loss_tol)
    assert float(tmet["aux"]) == float(jmet["aux"]) == 0.0
    jleaves = jax.tree_util.tree_flatten_with_path(jg)[0]
    tleaves = jax.tree.leaves(tg)
    assert len(jleaves) == len(tleaves)
    for (path, a), b in zip(jleaves, tleaves):
        a, b = _np(a), np.asarray(b, np.float32)
        assert a.shape == b.shape, jax.tree_util.keystr(path)
        err = np.abs(a - b).max() / np.abs(a).max()
        assert err < grad_tol, (jax.tree_util.keystr(path), err)


def test_lm_loss_without_mask_and_remat_off(loss_case):
    """No loss mask (every token counts) and cfg.remat=False give the same
    loss as JAX."""
    dtype, jcfg, tcfg, params, model, tok, lab, _ = loss_case
    jl, _ = jm.lm_loss(params, jnp.asarray(tok), jnp.asarray(lab), jcfg)
    with torch.no_grad():
        tl, met = tm.lm_loss(model, torch.from_numpy(tok), torch.from_numpy(lab),
                             tcfg.with_(remat=False))
    assert float(met["tokens"]) == tok.size
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_TOL[dtype][0])


def test_lm_logits_and_dots_policy(loss_case):
    dtype, jcfg, tcfg, params, model, tok, _, _ = loss_case
    with torch.no_grad():
        h, _ = tm.lm_hidden(model, torch.from_numpy(tok), tcfg, mode="eval")
        logits = tm.lm_logits(model, h, tcfg)
    assert logits.shape == (2, 40, tcfg.vocab) and logits.dtype == torch.float32
    with pytest.raises(NotImplementedError):
        tm.lm_hidden(model, torch.from_numpy(tok), tcfg.with_(remat_policy="dots"))
