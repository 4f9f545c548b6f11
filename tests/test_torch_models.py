"""repro_torch.models and repro_torch.bridge against the JAX package on the
smoke config of smollm-360m: the same weights (carried over by the bridge)
and the same tokens (from a numpy seed) through both."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models.common import PackedLinear  # noqa: E402

# f32: float reductions (norm means, attention sums, softmax) are taken in
# another order than XLA's, and an activation at a rounding boundary can
# move its int8 code by one. bf16: the same, with every intermediate rounded
# to 8 bits of mantissa through the two layers.
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _configs(dtype):
    return (jget_config("smollm-360m", smoke=True).with_(dtype=dtype),
            tget_config("smollm-360m", smoke=True).with_(dtype=dtype))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def smoke(request):
    jcfg, tcfg = _configs(request.param)
    params = jm.pack_params(jm.init_lm(jax.random.PRNGKey(0), jcfg), jcfg)
    model = bridge.lm_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return request.param, jcfg, tcfg, params, model


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def test_bridge_round_trip(smoke):
    """Every leaf lands in its layer's module bit for bit, packed bytes
    included, in the order the stage scan applies the layers."""
    dtype, jcfg, tcfg, params, model = smoke
    assert len(model.layers) == tcfg.n_layers
    np.testing.assert_array_equal(_np(model.embed.table),
                                  np.asarray(params["embed"]["table"].astype(jnp.float32)))
    stage = params["stages"][0]["b0"]
    for i, layer in enumerate(model.layers):
        for path, mod in (("mixer.wq", layer.mixer.wq), ("mixer.wo", layer.mixer.wo),
                          ("ffn.w1", layer.ffn.w1), ("ffn.w2", layer.ffn.w2)):
            a, b = path.split(".")
            pw = stage[a][b]["pw"]
            assert isinstance(mod, PackedLinear) and mod.K == pw.K
            np.testing.assert_array_equal(mod.packed5.numpy(), np.asarray(pw.packed5)[i])
            np.testing.assert_array_equal(mod.packed4.numpy(), np.asarray(pw.packed4)[i])
            np.testing.assert_array_equal(mod.scale.numpy(), np.asarray(pw.scale)[i])
        np.testing.assert_array_equal(layer.mixer_norm.scale.numpy(),
                                      np.asarray(stage["mixer_norm"]["scale"])[i])


def test_prefill_and_decode_logits(smoke):
    """Prefill of a left-padded batch (negative pad positions, as the
    engine's bucketed admission makes), then two decode steps."""
    dtype, jcfg, tcfg, params, model = smoke
    rng = np.random.default_rng(0)
    tok = rng.integers(0, jcfg.vocab, (2, 16)).astype(np.int32)
    start = np.array([-3, 0], np.int32)          # row 0: 3 pad tokens
    jc = jm.rollback_cache(jm.init_cache(jcfg, 2, 32), jnp.asarray(start))
    tc = tm.rollback_cache(tm.init_cache(tcfg, 2, 32, device="cpu"), torch.from_numpy(start))
    jl, jc = jm.prefill(params, jnp.asarray(tok), jc, jcfg)
    tl, tc = tm.prefill(model, torch.from_numpy(tok), tc, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL[dtype])
    for _ in range(2):
        nxt = rng.integers(0, jcfg.vocab, (2, 1)).astype(np.int32)
        jl, jc = jm.decode_step(params, jnp.asarray(nxt), jc, jcfg)
        tl, tc = tm.decode_step(model, torch.from_numpy(nxt), tc, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL[dtype])
    np.testing.assert_array_equal(tc[0]["idx"].numpy(), np.asarray(jc[0]["b0"]["idx"])[0])
    np.testing.assert_array_equal(tc[1]["slot_pos"].numpy(), np.asarray(jc[0]["b0"]["slot_pos"])[1])


def test_prefill_filling_the_whole_cache(smoke):
    """A prompt bucket equal to the cache length takes the `s >= buf`
    write branch."""
    dtype, jcfg, tcfg, params, model = smoke
    tok = np.random.default_rng(1).integers(0, jcfg.vocab, (1, 16)).astype(np.int32)
    start = np.array([-5], np.int32)
    jc = jm.rollback_cache(jm.init_cache(jcfg, 1, 16), jnp.asarray(start))
    tc = tm.rollback_cache(tm.init_cache(tcfg, 1, 16, device="cpu"), torch.from_numpy(start))
    jl, jc = jm.prefill(params, jnp.asarray(tok), jc, jcfg)
    tl, tc = tm.prefill(model, torch.from_numpy(tok), tc, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL[dtype])
    np.testing.assert_array_equal(tc[0]["slot_pos"].numpy(), np.asarray(jc[0]["b0"]["slot_pos"])[0])
    np.testing.assert_allclose(_np(tc[0]["k"]), np.asarray(jc[0]["b0"]["k"].astype(jnp.float32))[0],
                               rtol=0, atol=TOL[dtype])


def test_pack_params_matches_jax():
    """Dense "qw" weights carried by the bridge and packed by the port give
    the packed bytes JAX's pack_params gives (the per-channel scale to a
    few ulp: the absmean is summed in another order)."""
    jcfg, tcfg = _configs("float32")
    dense = jm.init_lm(jax.random.PRNGKey(1), jcfg)
    want = jm.pack_params(dense, jcfg)["stages"][0]["b0"]["ffn"]["w2"]["pw"]
    model = tm.pack_params(bridge.lm_from_jax(jax.tree.map(np.asarray, dense), tcfg,
                                              device="cpu"), tcfg)
    for i, layer in enumerate(model.layers):
        got = layer.ffn.w2
        assert isinstance(got, PackedLinear)
        np.testing.assert_array_equal(got.packed5.numpy(), np.asarray(want.packed5)[i])
        np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale)[i], rtol=1e-6)


@pytest.mark.parametrize("dense_max,chunk", [(2048, 512), (8, 8)])
@pytest.mark.parametrize("window", [0, 5])
def test_sdpa_dense_and_chunked(dense_max, chunk, window):
    """Both sdpa branches (dense below dense_max, online softmax over KV
    chunks above it) against JAX's, with invalid (-1) slots and a bf16
    cache on the dense branch. Tolerance: f32 sums in another order."""
    rng = np.random.default_rng(window + chunk)
    b, sq, h, kv, d, skv = 2, 3, 4, 2, 8, 32
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, kv, d)).astype(np.float32)
    kv_pos = np.tile(np.arange(skv, dtype=np.int32), (b, 1))
    kv_pos[0, 20:] = -1
    q_pos = np.array([[17, 18, 19], [29, 30, 31]], np.int32)
    kw = dict(causal=True, window=window, chunk=chunk, dense_max=dense_max)
    for vdt in ("float32", "bfloat16"):
        want = jattn.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v).astype(vdt),
                          jnp.asarray(q_pos), jnp.asarray(kv_pos), **kw)
        got = tattn.sdpa(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v).to(getattr(torch, vdt)),
                         torch.from_numpy(q_pos), torch.from_numpy(kv_pos), **kw)
        assert got.dtype == getattr(torch, str(want.dtype))
        np.testing.assert_allclose(_np(got), np.asarray(want.astype(jnp.float32)),
                                   rtol=0, atol=1e-5 if vdt == "float32" or dense_max == 8 else 1e-2)


def test_rope_rmsnorm_embed():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    pos = np.array([[-2, -1, 0, 1, 2], [7, 8, 9, 10, 11]], np.int32)
    np.testing.assert_allclose(
        tcommon.rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0).numpy(),
        np.asarray(jcommon.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)), rtol=0, atol=1e-5)
    scale = rng.standard_normal(8).astype(np.float32)
    np.testing.assert_allclose(
        tcommon.rmsnorm_apply(tcommon.RMSNorm(torch.from_numpy(scale)), torch.from_numpy(x)).numpy(),
        np.asarray(jcommon.rmsnorm_apply({"scale": jnp.asarray(scale)}, jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)
    jcfg, tcfg = _configs("float32")
    table = rng.standard_normal((11, 4)).astype(np.float32)
    tok = np.array([[3, 10, 0]], np.int32)
    for emb_scale in (False, True):
        np.testing.assert_array_equal(
            tcommon.embed_apply(tcommon.Embedding(torch.from_numpy(table)), torch.from_numpy(tok),
                                tcfg.with_(emb_scale_by_dim=emb_scale)).numpy(),
            np.asarray(jcommon.embed_apply({"table": jnp.asarray(table)}, jnp.asarray(tok),
                                           jcfg.with_(emb_scale_by_dim=emb_scale))))


def test_unported_paths_raise():
    """Both of JAX's remat policies are ported ("dots" since the port of
    dist); a policy JAX does not have still raises."""
    jcfg, tcfg = _configs("float32")
    model = tm.init_lm(tcfg, torch.Generator())
    z = torch.zeros((1, 4), dtype=torch.int32)
    loss, _ = tm.lm_loss(model.requires_grad_(True), z, z, tcfg.with_(remat_policy="dots"))
    assert torch.isfinite(loss)
    with pytest.raises(ValueError, match="remat_policy"):
        tm.lm_loss(model, z, z, tcfg.with_(remat_policy="offload"))


def test_unpacked_prefill_matches_jax():
    """An unpacked model ("qw" linears) serves through the dense ternarized
    compute of JAX's mode='serve' (no packing, no activation quantization)."""
    jcfg, tcfg = _configs("float32")
    params = jm.init_lm(jax.random.PRNGKey(2), jcfg)
    model = bridge.lm_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    tok = np.random.default_rng(5).integers(0, jcfg.vocab, (2, 12)).astype(np.int32)
    jl, _ = jm.prefill(params, jnp.asarray(tok), jm.init_cache(jcfg, 2, 16), jcfg)
    tl, _ = tm.prefill(model, torch.from_numpy(tok), tm.init_cache(tcfg, 2, 16, device="cpu"), tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL["float32"])
