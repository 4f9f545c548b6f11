"""repro_torch.kernels.flash_attention against the JAX package: the plain
version (which CPU tensors take) against JAX's Pallas `flash_attention` in
interpret mode over the sweep of tests/test_flash_attention.py, the
gradients of `flash_attention_trainable` against `jax.grad` of JAX's, and
the model's `attn_impl="flash"` path. Inputs are made by numpy from a seed."""
import importlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402

# the JAX package re-exports the function under the module's name
jfa = importlib.import_module("repro.kernels.flash_attention")

# f32: the same f32 arithmetic with sums in another order (JAX: online
# softmax over 32-key tiles; the port: one full softmax), as the JAX test
# holds its kernel against sdpa. bf16: inputs are exact in f32 on both
# sides and the output is one rounding of nearly equal f32 values, so the
# two differ by at most one bf16 ulp (2^-7 of the value's magnitude).
F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2 ** -7, atol=1e-6)


def _qkv(rng, b, s, h, kv, d):
    return (rng.standard_normal((b, h, s, d)).astype(np.float32),
            rng.standard_normal((b, kv, s, d)).astype(np.float32),
            rng.standard_normal((b, kv, s, d)).astype(np.float32))


def _jax(q, k, v, dtype=jnp.float32, bq=32, **kw):
    out = jfa.flash_attention(*(jnp.asarray(x, dtype) for x in (q, k, v)),
                              bq=bq, bk=bq, interpret=True, **kw)
    return np.asarray(out.astype(jnp.float32))


def _torch(q, k, v, dtype=torch.float32, **kw):
    out = tfa.flash_attention(*(torch.tensor(x).to(dtype) for x in (q, k, v)), **kw)
    assert out.dtype == dtype
    return out.float().numpy()


@pytest.mark.parametrize("b,s,h,kv,d", [
    (1, 32, 2, 2, 8), (2, 64, 4, 2, 16), (1, 100, 4, 1, 32), (2, 17, 3, 1, 8),
])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_jax_kernel(b, s, h, kv, d, causal):
    q, k, v = _qkv(np.random.default_rng(s + h), b, s, h, kv, d)
    np.testing.assert_allclose(_torch(q, k, v, causal=causal),
                               _jax(q, k, v, causal=causal), **F32)


@pytest.mark.parametrize("window,causal", [(8, True), (24, True), (24, False)])
def test_sliding_window(window, causal):
    q, k, v = _qkv(np.random.default_rng(window), 1, 96, 4, 2, 16)
    kw = dict(causal=causal, window=window)
    np.testing.assert_allclose(_torch(q, k, v, **kw), _jax(q, k, v, bq=16, **kw), **F32)


def test_softcap():
    q, k, v = _qkv(np.random.default_rng(5), 1, 48, 2, 2, 16)
    kw = dict(causal=True, softcap=20.0)
    np.testing.assert_allclose(_torch(q, k, v, **kw), _jax(q, k, v, bq=16, **kw), **F32)


@pytest.mark.parametrize("s", [17, 100])
def test_bf16(s):
    q, k, v = _qkv(np.random.default_rng(s), 2, s, 15, 5, 20)
    q, k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)) for x in (q, k, v))
    got = _torch(q, k, v, torch.bfloat16, causal=True)
    want = _jax(q, k, v, jnp.bfloat16, causal=True)
    np.testing.assert_allclose(got, want, **BF16)


def test_model_layout_views():
    """The model hands the wrapper transposed views of (B, S, H, D) tensors."""
    rng = np.random.default_rng(9)
    q, k, v = (rng.standard_normal((2, 17, n, 8)).astype(np.float32) for n in (3, 1, 1))
    got = tfa.flash_attention(*(torch.from_numpy(x).transpose(1, 2) for x in (q, k, v)))
    want = _jax(*(x.transpose(0, 2, 1, 3) for x in (q, k, v)), causal=True)
    np.testing.assert_allclose(got.numpy(), want, **F32)


def test_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((1, 2, 8, 8))
    with pytest.raises(ValueError):
        tfa.flash_attention(x, x[:, :1], x[:, :1, :, :4])       # k, v shapes differ
    with pytest.raises(ValueError):
        tfa.flash_attention(torch.zeros((1, 2, 8, 300)), torch.zeros((1, 1, 8, 300)),
                            torch.zeros((1, 1, 8, 300)))        # D > 256
    with pytest.raises(ValueError):
        tfa.flash_attention(torch.zeros((1, 2, 9, 8)), x[:, :1], x[:, :1], window=4)
    with pytest.raises(ValueError):
        tfa.flash_attention(x[..., ::2], x[:, :1, :, ::2], x[:, :1, :, ::2])  # D stride 2


@pytest.mark.parametrize("causal,window,softcap", [(True, 0, 0.0), (True, 8, 20.0),
                                                   (False, 0, 0.0)])
def test_trainable_gradients_match_jax(causal, window, softcap):
    """d(sum(out * r))/d(q, k, v): the port's autograd.Function (plain
    forward and plain VJP on the CPU) against jax.grad of JAX's custom_vjp
    (Pallas forward in interpret mode, reference VJP). f32, GQA."""
    rng = np.random.default_rng(11)
    q, k, v = _qkv(rng, 2, 24, 4, 2, 16)
    r = rng.standard_normal(q.shape).astype(np.float32)

    def jloss(q_, k_, v_):
        out = jfa.flash_attention_trainable(q_, k_, v_, causal, window, softcap, True)
        return jnp.sum(out * r)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tfa.flash_attention_trainable(tq, tk, tv, causal, window, softcap)
    tg = torch.autograd.grad((out * torch.from_numpy(r)).sum(), (tq, tk, tv))
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def smoke_lm():
    jcfg = jget_config("smollm-360m", smoke=True).with_(dtype="float32")
    tcfg = tget_config("smollm-360m", smoke=True).with_(dtype="float32")
    params = jm.init_lm(jax.random.PRNGKey(0), jcfg)
    model = bridge.lm_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    tok = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 48)).astype(np.int32)
    return jcfg, tcfg, params, model, tok


def test_lm_hidden_flash_matches_auto(smoke_lm):
    """attn_impl='flash' against the sdpa path, on the same weights (f32,
    eval mode): only the summation order differs."""
    _, tcfg, _, model, tok = smoke_lm
    with torch.no_grad():
        h_auto, _, _ = tm.lm_hidden(model, torch.from_numpy(tok), tcfg, mode="eval")
        h_fl, _, _ = tm.lm_hidden(model, torch.from_numpy(tok), tcfg.with_(attn_impl="flash"),
                                  mode="eval")
    np.testing.assert_allclose(h_fl.numpy(), h_auto.numpy(), rtol=1e-5, atol=1e-5)


def test_lm_hidden_flash_matches_jax(smoke_lm):
    """The port's flash path against JAX's (Pallas kernel in interpret
    mode). 'serve' mode (dense ternarized linears, no activation
    quantization): f32 sums in another order only, 1e-5 as the f32 model
    parity of tests/test_torch_models.py. 'eval' mode adds the int8
    activation fake-quant, where a one-ulp difference at a rounding boundary
    moves a code by one step (~amax/127) and the step spreads through
    attention: the bound of JAX's own flash-vs-auto test
    (tests/test_flash_attention.py) applies."""
    jcfg, tcfg, params, model, tok = smoke_lm
    for mode in ("serve", "eval"):
        jh, _, _ = jm.lm_hidden(params, jnp.asarray(tok), jcfg.with_(attn_impl="flash"), mode=mode)
        with torch.no_grad():
            th, _, _ = tm.lm_hidden(model, torch.from_numpy(tok), tcfg.with_(attn_impl="flash"),
                                    mode=mode)
        a, b = th.numpy(), np.asarray(jh)
        if mode == "serve":
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
        else:
            assert np.abs(a - b).max() < 0.15 * np.abs(b).mean() + 0.1
            assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.999


def test_build_table_covers_every_entry():
    """`_build` sets each C entry's own ctypes signature: the table names
    every entry, and each signature matches the entry's C parameters in
    `csrc/` kind for kind (a pointer or the stream → c_void_p, long long →
    c_longlong, float → c_float, int → c_int)."""
    import ctypes
    import re

    from repro_torch.kernels import _build

    assert sorted(_build.ENTRIES) == sorted(_build._ARGTYPES)
    src = "\n".join(p.read_text() for p in sorted(_build.CSRC.glob("*.cu*")))
    macros = {m.group(1): m.group(2).replace("\\\n", " ")
              for m in re.finditer(r"#define (\w+)\s+((?:.*\\\n)*.*)", src)}
    kinds = {"ptr": ctypes.c_void_p, "long long": ctypes.c_longlong,
             "float": ctypes.c_float, "int": ctypes.c_int}
    for name in _build.ENTRIES:
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
        assert m, f"{name} is not exported by csrc/"
        params = macros.get(m.group(1).strip(), m.group(1))
        want = []
        for p in (p.strip() for p in params.split(",")):
            kind = "ptr" if "*" in p else "long long" if "long long" in p else p.split()[-2]
            want.append(kinds[kind])
        assert list(_build._ARGTYPES[name]) == want, name
