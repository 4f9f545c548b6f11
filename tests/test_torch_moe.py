"""The port's Mixture-of-Experts FFN against the JAX package
(`repro.models.moe`) on seeded numpy inputs: `moe_apply` in every mode
(packed serving against the vmapped Pallas kernels in interpret mode),
the routing properties of tests/test_moe.py, the router's tie rule,
`linear_batched_apply` and `ternary_matmul_batched`, `pack_params` on
stacked experts, the bridge, `lm_loss` with the router loss, and serving
llama4-scout-17b-a16e's smoke config against the JAX engine.

Tolerances (f32): the port and XLA take float sums (router logits, the
QAT einsums, norms, attention) in other orders, a few f32 ulp apart. The
packed path's integer cores are exact; with two packed segments XLA fuses
the kernel's epilogue into the segment sum as a multiply-add (one rounding
fewer), so outputs agree to 1e-6 of their magnitude (as
tests/test_torch_kernels.py states), and here to `OUT_RTOL` after the
second BitLinear of the SwiGLU."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import models as jm  # noqa: E402
from repro import serve as js  # noqa: E402
from repro import spec as jspec  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch import serve as ts  # noqa: E402
from repro_torch import spec as tspec  # noqa: E402
from repro_torch.configs import MoEConfig  # noqa: E402
from repro_torch.core import PackedWeight  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

ARCH = "llama4-scout-17b-a16e"
#: max |port - JAX| over the output, relative to its largest entry (f32)
OUT_RTOL = 1e-5
#: lm_loss and each gradient leaf, relative (f32; as tests/test_torch_train.py)
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-5
#: deepseek-style routing on the llama4 smoke model: top-2 over 4 experts,
#: aux-free bias routing, a wider shared expert, capacity factor 1.0
DEEPSEEK_MOE = dict(n_experts=4, top_k=2, d_ff_expert=32, n_shared=1, d_ff_shared=48,
                    capacity_factor=1.0, router_aux_free=True)
IMPLS = ("decode", "lookup")

# The JAX functions under jit (cfg and mode static), as the JAX package runs
# them. The packed paths read the mpGeMM impl from the dispatch config while
# tracing, so each impl gets a jitted function (and a trace cache) of its own.
_jit_moe = jax.jit(jmoe.moe_apply, static_argnums=(2, 3), static_argnames="n_blocks")
_jit_moe_packed = {impl: jax.jit(lambda p, x, cfg: jmoe.moe_apply(p, x, cfg, "serve"),
                                 static_argnums=2) for impl in IMPLS}
_jit_batched = jax.jit(jcommon.linear_batched_apply, static_argnums=(2, 3))
_jit_batched_packed = {impl: jax.jit(lambda p, x, cfg: jcommon.linear_batched_apply(p, x, cfg, "serve"),
                                     static_argnums=2) for impl in IMPLS}
_jit_hidden = jax.jit(jm.lm_hidden, static_argnums=2, static_argnames="mode")


def _cfgs(moe=None, **kw):
    jcfg = jget_config(ARCH, smoke=True).with_(dtype="float32", **kw)
    tcfg = tget_config(ARCH, smoke=True).with_(dtype="float32", **kw)
    if moe is not None:
        jcfg, tcfg = jcfg.with_(moe=JMoEConfig(**moe)), tcfg.with_(moe=MoEConfig(**moe))
    return jcfg, tcfg


def _port_ffn(p):
    """The port's MoEFFN from a JAX `moe_init` dict (stacked as one layer)."""
    return bridge._ffn(jax.tree.map(lambda a: np.asarray(a)[None], p), 0, "cpu")


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _both(p, x, jcfg, tcfg, mode, n_blocks=None, *, bias=None):
    """moe_apply of both packages on the same params and input. → numpy
    (out_jax, aux_jax, out_port, aux_port)."""
    if bias is not None:
        p = dict(p, router_bias=jnp.asarray(bias))
    jo, ja = _jit_moe(p, jnp.asarray(x), jcfg, mode, n_blocks=n_blocks)
    with torch.no_grad():
        to, ta = tmoe.moe_apply(_port_ffn(p), torch.from_numpy(x), tcfg, mode, n_blocks=n_blocks)
    return np.asarray(jo), float(ja), to.numpy(), float(ta)


def _close(got, want, rtol=OUT_RTOL):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


# --------------------------------------------------------------------------
# moe_apply against JAX
# --------------------------------------------------------------------------
@pytest.mark.parametrize("impl", IMPLS)
def test_packed_serve_matches_jax_interpret(impl):
    """Packed experts in 'serve' mode: the port's fused plain path against
    JAX's vmapped Pallas kernels of the same impl in interpret mode."""
    jcfg, tcfg = _cfgs()
    p = jm.pack_params(jmoe.moe_init(jax.random.PRNGKey(0), jcfg), jcfg)
    x = _x((2, 8, jcfg.d_model))
    with jops.dispatch_override(impl=impl, interpret=True):
        want, aux = _jit_moe_packed[impl](p, jnp.asarray(x), jcfg)
    want, aux = np.asarray(want), float(aux)
    with ops.dispatch_override(impl=impl), torch.no_grad():
        got, taux = tmoe.moe_apply(_port_ffn(p), torch.from_numpy(x), tcfg, "serve")
    _close(got.numpy(), want)
    assert taux.item() == aux == 0.0


@pytest.mark.parametrize("moe", [None, DEEPSEEK_MOE], ids=["llama4", "deepseek_routing"])
@pytest.mark.parametrize("mode", ["eval", "train"])
def test_moe_apply_matches_jax(mode, moe):
    """'eval' and 'train' (QAT fake-quant experts): out and the aux loss
    (load balance + z-loss in train; 0 with aux-free routing). The
    deepseek-style case routes top-2 through a nonzero router bias."""
    jcfg, tcfg = _cfgs(moe)
    p = jmoe.moe_init(jax.random.PRNGKey(1), jcfg)
    bias = _x((jcfg.moe.n_experts,), seed=5, scale=0.1) if moe else None
    want, jaux, got, taux = _both(p, _x((2, 12, jcfg.d_model), seed=2), jcfg, tcfg, mode,
                                  bias=bias)
    _close(got, want)
    np.testing.assert_allclose(taux, jaux, rtol=1e-6)
    assert (jaux > 0) == (mode == "train" and moe is None)


def _routing_case(name):
    """(moe overrides, input shape, mode, n_blocks) of each ported case of
    tests/test_moe.py, on its config: 4 experts, top-2, d_ff 32."""
    return {
        "aux_free_zero_aux": (dict(router_aux_free=True), (2, 8), "train", None),
        "small_batch_dropless": (dict(capacity_factor=0.01), (2, 1), "serve", None),
        "capacity_drops": (dict(n_shared=0, capacity_factor=0.25), (4, 32), "train", None),
        "shared_contributes": (dict(n_shared=1, capacity_factor=0.25), (4, 32), "train", None),
        "top1_argmax": (dict(top_k=1, capacity_factor=8.0), (1, 4), "eval", None),
        "block_local": (dict(capacity_factor=8.0), (4, 16), "eval", 4),
    }[name]


@pytest.mark.parametrize("name", ["aux_free_zero_aux", "small_batch_dropless", "capacity_drops",
                                  "shared_contributes", "top1_argmax", "block_local"])
def test_routing_properties(name):
    """The properties tests/test_moe.py holds the JAX package to, held by
    the port, whose output also matches JAX's on the same weights."""
    over, (b, s), mode, nb = _routing_case(name)
    moe = {**dict(n_experts=4, top_k=2, d_ff_expert=32, capacity_factor=1.25), **over}
    jcfg, tcfg = _cfgs(moe)
    p = jmoe.moe_init(jax.random.PRNGKey(0), jcfg)
    x = _x((b, s, jcfg.d_model), seed=7)
    want, jaux, got, taux = _both(p, x, jcfg, tcfg, mode, nb)
    _close(got, want)
    np.testing.assert_allclose(taux, jaux, rtol=1e-6)
    rows = np.abs(got).sum(-1)
    if name == "aux_free_zero_aux":
        assert taux == 0.0
    elif name in ("small_batch_dropless", "shared_contributes"):
        assert np.all(rows > 0)
    elif name == "capacity_drops":
        assert (rows < 1e-7).any()
    elif name == "top1_argmax":
        xt = x.reshape(-1, jcfg.d_model)
        eidx = (xt @ np.asarray(p["router"]["w"])).argmax(-1)
        ffn = _port_ffn(p)
        manual = np.stack([_expert_eval(ffn, int(e), xt[i]) for i, e in enumerate(eidx)])
        _close(got.reshape(-1, jcfg.d_model), manual + _shared_eval(ffn, xt))
    else:   # block-local dispatch = global dispatch where capacity does not bind
        with torch.no_grad():
            glob, _ = tmoe.moe_apply(_port_ffn(p), torch.from_numpy(x), tcfg, mode, n_blocks=1)
        np.testing.assert_allclose(got, glob.numpy(), rtol=1e-5, atol=1e-6)


def _expert_eval(ffn, e, xi):
    """Expert e alone on one token, through the single-linear QAT path."""
    x = torch.from_numpy(xi)[None]
    lin = [tcommon.QLinear(w.qw[e]) for w in (ffn.experts.w1, ffn.experts.w3, ffn.experts.w2)]
    with torch.no_grad():
        h = torch.nn.functional.silu(tcommon.linear_apply(lin[0], x, "eval")) \
            * tcommon.linear_apply(lin[1], x, "eval")
        return tcommon.linear_apply(lin[2], h, "eval")[0].numpy()


def _shared_eval(ffn, xt):
    if ffn.shared is None:
        return 0.0
    with torch.no_grad():
        return tmoe.dense_ffn_apply(ffn.shared, torch.from_numpy(xt), "eval").numpy()


def test_router_ties_break_toward_lower_ids():
    """Tied router scores: the port's top-k keeps the experts
    `jax.lax.top_k` keeps (lower ids first), where torch.topk need not;
    and moe_apply with two identical router columns routes as JAX does."""
    rng = np.random.default_rng(4)
    scores = rng.integers(0, 3, (64, 6)).astype(np.float32)          # many ties
    for k in (1, 2, 3):
        _, want = jax.lax.top_k(jnp.asarray(scores), k)
        got = tmoe.top_k_indices(torch.from_numpy(scores), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jcfg, tcfg = _cfgs(dict(n_experts=4, top_k=2, d_ff_expert=32, capacity_factor=8.0))
    p = jmoe.moe_init(jax.random.PRNGKey(2), jcfg)
    w = np.asarray(p["router"]["w"]).copy()
    w[:, 3] = w[:, 1]
    w[:, 2] = w[:, 0]
    p = dict(p, router={"w": jnp.asarray(w)})
    want, _, got, _ = _both(p, _x((2, 6, jcfg.d_model), seed=3), jcfg, tcfg, "eval")
    _close(got, want)


# --------------------------------------------------------------------------
# Stacked expert linears
# --------------------------------------------------------------------------
def _stacked(e=3, k=64, m=24, seed=0):
    w = _x((e, k, m), seed=seed)
    return w, {"qw": jnp.asarray(w)}


@pytest.mark.parametrize("branch", ["packed_decode", "packed_lookup", "qw_train", "qw_eval",
                                    "qw_serve", "w"])
def test_linear_batched_apply_matches_jax(branch):
    """Every branch of linear_batched_apply: packed (E, M, KG) weights
    through the grouped kernels' plain versions against the vmapped Pallas
    kernels (interpret), the QAT einsum (fake-quant weight, no transpose),
    and the plain einsums of unconverted 'serve' and non-quantized weights."""
    jcfg, tcfg = _cfgs()
    w, jp = _stacked()
    x = _x((3, 5, 64), seed=1, scale=2.0)
    mode = branch.split("_")[1] if branch.startswith("qw") else "serve"
    if branch.startswith("packed"):
        impl = branch.split("_")[1]
        jp = jm.pack_params(jp, jcfg)
        with jops.dispatch_override(impl=impl, interpret=True):
            want = _jit_batched_packed[impl](jp, jnp.asarray(x), jcfg)
        mod = tm.pack_params(torch.nn.ModuleDict({"l": tcommon.QLinear(torch.from_numpy(w))}),
                             tcfg)["l"]
        with ops.dispatch_override(impl=impl):
            got = tcommon.linear_batched_apply(mod, torch.from_numpy(x), "serve")
    else:
        if branch == "w":
            jp = {"w": jp["qw"]}
        want = _jit_batched(jp, jnp.asarray(x), jcfg, mode)
        mod = (tcommon.Linear if branch == "w" else tcommon.QLinear)(torch.from_numpy(w))
        got = tcommon.linear_batched_apply(mod, torch.from_numpy(x), mode)
    _close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fusion", ["fused", "unfused"])
@pytest.mark.parametrize("impl", IMPLS)
def test_batched_matmul_is_the_per_expert_matmul(impl, fusion):
    """ternary_matmul_batched's expert e is ternary_matmul on expert e's
    weight and rows, bit for bit: per-(expert, row) activation scales over
    the full K, the segment rules, the output dtype (K = 64: two segments;
    K = 40: one; bf16 and f32; a strided x)."""
    for k, dt in ((64, torch.float32), (40, torch.bfloat16)):
        w = torch.from_numpy(_x((3, k, 20), seed=k))
        mod = tm.pack_params(torch.nn.ModuleDict({"l": tcommon.QLinear(w)}),
                             tget_config(ARCH, smoke=True))["l"]
        x = torch.from_numpy(_x((3, 6, k + 2), seed=1))[..., 2:].to(dt)
        got = ops.ternary_matmul_batched(mod.pw, x, impl=impl, fusion=fusion)
        assert got.shape == (3, 6, 20) and got.dtype == dt
        for e in range(3):
            pw = PackedWeight(mod.packed5[e], mod.packed4[e], mod.scale[e], mod.K)
            assert torch.equal(got[e], ops.ternary_matmul(pw, x[e], impl=impl, fusion=fusion))


def test_pack_params_on_stacked_experts_matches_jax():
    """pack_params on a MoE layer: the stacked (E, K, M) expert weights pack
    along K per expert (swapaxes, not a full transpose), byte for byte as
    JAX's pack_params; the absmean scales are float means summed in another
    order than XLA's, a few f32 ulp apart (ROADMAP C)."""
    jcfg, tcfg = _cfgs()
    p = jmoe.moe_init(jax.random.PRNGKey(3), jcfg)
    want = jm.pack_params(p, jcfg)
    got = tm.pack_params(_port_ffn(p), tcfg)
    for name in ("w1", "w3", "w2"):
        jpw, tl = want["experts"][name]["pw"], getattr(got.experts, name)
        assert tl.K == jpw.K and tl.packed5.shape[0] == jcfg.moe.n_experts
        for f in ("packed5", "packed4"):
            np.testing.assert_array_equal(getattr(tl, f).numpy(), np.asarray(getattr(jpw, f)))
        np.testing.assert_allclose(tl.scale.numpy(), np.asarray(jpw.scale), rtol=1e-6)
    np.testing.assert_array_equal(got.router.w.numpy(), np.asarray(p["router"]["w"]))


# --------------------------------------------------------------------------
# The llama4 smoke model: bridge, lm_loss, init
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def llama4():
    jcfg, tcfg = _cfgs(loss_chunk=32)
    params = jm.init_lm(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, params, jax.tree.map(np.asarray, params)


def test_bridge_round_trip_unpacked(llama4):
    """lm_from_jax then lm_to_jax gives back every leaf of the unpacked MoE
    model bit for bit, router and stacked experts included."""
    jcfg, tcfg, _, nparams = llama4
    model = bridge.lm_from_jax(nparams, tcfg, device="cpu")
    assert isinstance(model.layers[0].ffn, tmoe.MoEFFN)
    back = bridge.lm_to_jax(model, tcfg)
    want = jax.tree_util.tree_flatten_with_path(nparams)[0]
    got = jax.tree.leaves(back)
    assert len(want) == len(got)
    for (path, a), b in zip(want, got):
        np.testing.assert_array_equal(b, a, err_msg=jax.tree_util.keystr(path))


def test_lm_loss_with_router_loss_matches_jax(llama4):
    """lm_loss in f32 (QAT, per-layer remat, S 40 in chunks of 32, a loss
    mask): loss, ce, the summed router aux loss (nonzero) and every gradient
    leaf against jax.value_and_grad, to ~1e-6 relative (other summation
    orders), as tests/test_torch_train.py bounds the dense model."""
    jcfg, tcfg, params, nparams = llama4
    model = bridge.lm_from_jax(nparams, tcfg, device="cpu").requires_grad_(True)
    rng = np.random.default_rng(3)
    tok, lab = (rng.integers(0, jcfg.vocab, (2, 40)).astype(np.int32) for _ in range(2))
    mask = (rng.random((2, 40)) < 0.8).astype(np.float32)
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: jm.lm_loss(p, jnp.asarray(tok), jnp.asarray(lab), jcfg,
                             loss_mask=jnp.asarray(mask)), has_aux=True)(params)
    tl, tmet = tm.lm_loss(model, torch.from_numpy(tok), torch.from_numpy(lab), tcfg,
                          loss_mask=torch.from_numpy(mask))
    assert float(jmet["aux"]) > 0
    for got, want in ((tl, jl), (tmet["ce"], jmet["ce"]), (tmet["aux"], jmet["aux"])):
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=LOSS_RTOL)
    named = dict(model.named_parameters())
    tg = bridge.to_jax_tree(dict(zip(named, torch.autograd.grad(tl, list(named.values())))),
                            tcfg)
    jleaves = jax.tree_util.tree_flatten_with_path(jg)[0]
    tleaves = jax.tree.leaves(tg)
    assert len(jleaves) == len(tleaves)
    for (path, a), b in zip(jleaves, tleaves):
        a, b = np.asarray(a), np.asarray(b, np.float32)
        assert np.abs(a - b).max() <= GRAD_RTOL * np.abs(a).max(), jax.tree_util.keystr(path)


def test_mixed_ffn_layers_match_jax():
    """Blocks of every ported FFN kind in one stack (dense, MoE, none),
    bridged from JAX: lm_hidden's output and summed router aux in 'train'
    mode, as JAX's."""
    from repro.configs.base import LayerSpec as JLayerSpec
    from repro_torch.configs import LayerSpec

    kinds = ("dense", "moe", "none")
    jcfg, tcfg = _cfgs()
    jcfg = jcfg.with_(n_layers=3, layers=tuple(JLayerSpec(ffn=f, rope_theta=5e5) for f in kinds))
    tcfg = tcfg.with_(n_layers=3, layers=tuple(LayerSpec(ffn=f, rope_theta=5e5) for f in kinds))
    params = jm.init_lm(jax.random.PRNGKey(4), jcfg)
    model = bridge.lm_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    assert model.layers[2].ffn is None and isinstance(model.layers[1].ffn, tmoe.MoEFFN)
    tok = np.random.default_rng(5).integers(0, jcfg.vocab, (2, 12)).astype(np.int32)
    jh, _, jaux = _jit_hidden(params, jnp.asarray(tok), jcfg, mode="train")
    with torch.no_grad():
        th, _, taux = tm.lm_hidden(model, torch.from_numpy(tok), tcfg, mode="train")
    _close(th.numpy(), np.asarray(jh))
    assert float(jaux) > 0
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


def test_init_lm_packed_is_pack_params_of_init_lm():
    """init_lm(packed=True) draws the same weights in the same order and
    packs each layer as it goes: equal to pack_params(init_lm(...))."""
    cfg = tget_config(ARCH, smoke=True)
    want = tm.pack_params(tm.init_lm(cfg, torch.Generator().manual_seed(5)), cfg)
    got = tm.init_lm(cfg, torch.Generator().manual_seed(5), packed=True)
    a, b = dict(want.named_buffers()), dict(got.named_buffers())
    a.update(want.named_parameters())
    b.update(got.named_parameters())
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)


# --------------------------------------------------------------------------
# Serving the llama4 smoke model against the JAX engine
# --------------------------------------------------------------------------
_STATS = ("prefill_tokens", "prefill_pad_tokens", "decode_tokens", "decode_steps", "chunk_steps",
          "spec_steps", "spec_slot_steps", "spec_skipped_steps", "drafted_tokens",
          "accepted_tokens", "verified_nodes", "completed", "rejected",
          "prefix_hit_tokens", "prefix_hit_requests")
SERVE_LENS = (7, 19, 34, 4, 25)
SERVE_CASES = {
    "whole_prompt": dict(),
    "chunked_chain": dict(prefill_chunk=16, spec=dict(k=3)),
    "paged": dict(paged=dict(page_size=8)),
}


@pytest.fixture(scope="module")
def served():
    jcfg, tcfg = _cfgs()
    params = jm.pack_params(jm.init_lm(jax.random.PRNGKey(0), jcfg), jcfg)
    return jcfg, tcfg, params, jax.tree.map(np.asarray, params)


def _serve(pkg, eng, prompts, max_new=6):
    sched = pkg.ContinuousBatchingScheduler(eng)
    reqs = [pkg.Request(rid=i, prompt=p.copy(), max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    sched.submit(reqs)
    return [r.generated for r in reqs], sched.run_to_completion()


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_engine_matches_jax(served, case):
    """Greedy serving in f32 with 3 slots (padding rows of free slots route
    tokens too, as in JAX): the port's engine emits the JAX engine's tokens
    exactly and every ServeStats counter matches."""
    jcfg, tcfg, params, nparams = served
    kw = dict(SERVE_CASES[case])
    spec, paged = kw.pop("spec", None), kw.pop("paged", None)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab, size=n).astype(np.int32) for n in SERVE_LENS]
    common = dict(max_slots=3, max_len=96, **kw)
    jeng = js.Engine(params, jcfg, spec=None if spec is None else jspec.SpecConfig(**spec),
                     paged_kv=None if paged is None else js.PagedKVConfig(**paged), **common)
    teng = ts.Engine(bridge.lm_from_jax(nparams, tcfg, device="cpu"), tcfg, device="cpu",
                     spec=None if spec is None else tspec.SpecConfig(**spec),
                     paged_kv=None if paged is None else ts.PagedKVConfig(**paged), **common)
    want, jst = _serve(js, jeng, prompts)
    got, tst = _serve(ts, teng, prompts)
    assert got == want and all(len(g) == 6 for g in got)
    for f in _STATS:
        assert getattr(tst, f) == getattr(jst, f), f
    assert len(tst.ttft_s) == len(jst.ttft_s)
