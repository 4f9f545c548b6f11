"""The port's Mamba2 SSD mixer (`repro_torch.models.ssm`) and the two SSM
architectures against the JAX package on seeded numpy inputs, in f32:
`_causal_conv` (causality, streaming with a history, S < d_conv - 1),
`_ssd_chunked` against JAX and against the exact sequential recurrence at
padded and unpadded chunk tails, `ssm_apply` in train, eval and packed
serving (JAX under `dispatch_override(impl="decode", interpret=True)`,
n_groups 1 and 2), the prefill -> decode consistency of tests/test_ssm.py,
the bridge and the stacked layout, `pack_params`, `lm_loss` and its
gradients, the engine's and the block's refusals of SSM layers with JAX's
texts, and greedy whole-prompt serving of mamba2-1.3b's and
jamba-1.5-large-398b's smoke configs against the JAX engine.

Tolerances (f32): `OUT_RTOL` bounds max |port - JAX| relative to the
output's largest entry; the two packages take float sums (the scan's
einsums, the conv taps, norms) in other orders, a few f32 ulp apart.
`REC_TOL` is tests/test_ssm.py's bound of the chunked scan against the
float64 recurrence (rtol and atol). `LOSS_RTOL`, `GRAD_RTOL`: as
tests/test_torch_train.py bounds the dense model's QAT loss and gradients.
`DECODE_TOL` is tests/test_ssm.py's bound of prefill + decode against the
no-cache forward (its int8 activation scales see other token sets).
Serving parity is exact: tokens and every `ServeStats` counter."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import models as jm  # noqa: E402
from repro import serve as js  # noqa: E402
from repro import spec as jspec  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import SSMConfig as JSSMConfig  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch import serve as ts  # noqa: E402
from repro_torch import spec as tspec  # noqa: E402
from repro_torch.configs import SSMConfig  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

ARCH = "mamba2-1.3b"
HYBRID = "jamba-1.5-large-398b"
OUT_RTOL = 1e-5
REC_TOL = 2e-3
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-5
DECODE_TOL = 2e-2


def _cfgs(arch=ARCH, groups=1, **kw):
    jcfg = jget_config(arch, smoke=True).with_(dtype="float32", **kw)
    tcfg = tget_config(arch, smoke=True).with_(dtype="float32", **kw)
    if groups != 1:
        f = dict(vars(jcfg.ssm), n_groups=groups)
        jcfg, tcfg = jcfg.with_(ssm=JSSMConfig(**f)), tcfg.with_(ssm=SSMConfig(**f))
    return jcfg, tcfg


def _close(got, want, rtol=OUT_RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# The causal conv
# --------------------------------------------------------------------------
@pytest.mark.parametrize("s,hist", [(10, False), (5, True), (3, True), (2, True), (1, True)],
                         ids=["s10", "s5_hist", "s3_hist", "s2_hist", "s1_hist"])
def test_causal_conv_matches_jax(s, hist):
    """Output and new history against JAX's, with and without a history,
    at S >= d_conv - 1 and S < d_conv - 1 (JAX's second history case)."""
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    h = rng.standard_normal((2, 3, 6)).astype(np.float32) if hist else None
    want, wh = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                 None if h is None else jnp.asarray(h))
    got, gh = tssm._causal_conv(_t(x), _t(w), _t(b), None if h is None else _t(h))
    _close(got.numpy(), want)
    np.testing.assert_array_equal(gh.numpy(), np.asarray(wh))


def test_causal_conv_is_causal_and_streams():
    """A change at step 7 leaves the outputs before it alone, and two
    chunks with the carried history equal one pass (tests/test_ssm.py)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, 3)).astype(np.float32)
    w, b = (_t(rng.standard_normal(sh).astype(np.float32)) for sh in ((4, 3), (3,)))
    full, _ = tssm._causal_conv(_t(x), w, b, None)
    x2 = x.copy()
    x2[:, 7:] = 99.0
    changed, _ = tssm._causal_conv(_t(x2), w, b, None)
    assert torch.equal(changed[:, :7], full[:, :7])
    y1, h = tssm._causal_conv(_t(x[:, :7]), w, b, None)
    y2, _ = tssm._causal_conv(_t(x[:, 7:]), w, b, h)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), full.numpy(), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# The chunked scan
# --------------------------------------------------------------------------
def _recurrence(x, dt, a, b_mat, c_mat, h0):
    """The exact sequential recurrence in float64: h_t = exp(dt_t a) h_{t-1}
    + dt_t B_t x_t, y_t = C_t h_t."""
    hst = np.array(h0, np.float64)
    ys = np.zeros(x.shape)
    for t in range(x.shape[1]):
        da = np.exp(dt[:, t] * a)
        hst = hst * da[:, :, None, None] + np.einsum("bhn,bhp,bh->bhpn", b_mat[:, t], x[:, t],
                                                      dt[:, t])
        ys[:, t] = np.einsum("bhn,bhpn->bhp", c_mat[:, t], hst)
    return ys, hst


@pytest.mark.parametrize("s", [1, 7, 16, 17, 64, 65, 130])
def test_ssd_chunked_matches_jax_and_recurrence(s):
    """Chunk 16: one short unpadded chunk (S < 16), whole chunks, and padded
    tails (17, 65, 130). Against JAX to OUT_RTOL and against the float64
    recurrence to REC_TOL, output and final state."""
    rng = np.random.default_rng(s)
    bsz, h, p, n, chunk = 2, 3, 4, 5, 16
    x = rng.standard_normal((bsz, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (bsz, s, h)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, (h,)).astype(np.float32)
    b_mat, c_mat = (rng.standard_normal((bsz, s, h, n)).astype(np.float32) for _ in range(2))
    h0 = rng.standard_normal((bsz, h, p, n)).astype(np.float32)
    args = (x, dt, a, b_mat, c_mat)
    want, wh = jssm._ssd_chunked(*map(jnp.asarray, args), chunk, jnp.asarray(h0))
    got, gh = tssm._ssd_chunked(*map(_t, args), chunk, _t(h0))
    _close(got.numpy(), want)
    _close(gh.numpy(), wh)
    y_ref, h_ref = _recurrence(*args, h0)
    np.testing.assert_allclose(got.numpy(), y_ref, rtol=REC_TOL, atol=REC_TOL)
    np.testing.assert_allclose(gh.numpy(), h_ref, rtol=REC_TOL, atol=REC_TOL)


def test_ssd_chunked_overflowing_decay_stays_finite():
    """A chunk whose summed decay passes f32's exp range: the intra-chunk
    decay above the diagonal overflows, and the masked entries must not
    turn into NaN (forward or backward)."""
    rng = np.random.default_rng(1)
    s, h = 32, 2
    x = _t(rng.standard_normal((1, s, h, 4)).astype(np.float32))
    dt = torch.full((1, s, h), 8.0, requires_grad=True)
    a = torch.tensor([-1.0, -2.0])
    b_mat, c_mat = (_t(rng.standard_normal((1, s, h, 3)).astype(np.float32)) for _ in range(2))
    y, hf = tssm._ssd_chunked(x, dt, a, b_mat, c_mat, 32, torch.zeros((1, h, 4, 3)))
    assert torch.isfinite(y).all() and torch.isfinite(hf).all()
    (g,) = torch.autograd.grad(y.sum() + hf.sum(), dt)
    assert torch.isfinite(g).all()


# --------------------------------------------------------------------------
# ssm_apply
# --------------------------------------------------------------------------
#: path: (tokens S, mode, packed, cached)
APPLY_PATHS = {
    "train": (20, "train", False, False),
    "eval": (20, "eval", False, False),
    "serve_prefill": (20, "serve", True, True),
    "serve_decode": (1, "serve", True, True),
    "serve_short": (2, "serve", True, True),
}


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("path", list(APPLY_PATHS))
def test_ssm_apply_matches_jax(path, groups):
    """One ssm_apply call of both packages on the same weights, input and
    cache (random state and conv history): the output and the new cache to
    OUT_RTOL, idx exactly. Packed serving runs JAX's Pallas decode kernel
    interpreted and the port's plain version. n_groups 2 catches a group
    broadcast that tiles instead of repeating each group."""
    s, mode, packed, cached = APPLY_PATHS[path]
    jcfg, tcfg = _cfgs(groups=groups)
    sc = jcfg.ssm
    p = jssm.ssm_init(jax.random.PRNGKey(groups), jcfg, None)
    if packed:
        p = jm.pack_params(p, jcfg)
    mod = bridge._mixer(jax.tree.map(lambda v: np.asarray(v)[None], p), 0, "cpu")
    rng = np.random.default_rng(s + 10 * groups)
    u = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    jc = tc = None
    if cached:
        conv_ch = sc.d_inner + 2 * sc.n_groups * sc.d_state
        c = {"conv": rng.standard_normal((2, sc.d_conv - 1, conv_ch)).astype(np.float32),
             "state": rng.standard_normal((2, sc.n_heads, sc.head_dim, sc.d_state)).astype(np.float32),
             "idx": np.array([3, 11], np.int32)}
        jc = {k: jnp.asarray(v) for k, v in c.items()}
        tc = {k: _t(v) for k, v in c.items()}
    jfn = jax.jit(functools.partial(jssm.ssm_apply, cfg=jcfg, spec=None, mode=mode))
    with jops.dispatch_override(impl="decode", interpret=True):
        want, jnew = jfn(p, jnp.asarray(u), cache=jc)
    with ops.dispatch_override(impl="decode"), torch.no_grad():
        got, tnew = tssm.ssm_apply(mod, _t(u), cfg=tcfg, spec=None, mode=mode, cache=tc)
    _close(got.numpy(), want)
    if not cached:
        assert tnew is None and jnew is None
        return
    np.testing.assert_array_equal(tnew["idx"].numpy(), np.asarray(jnew["idx"]))
    for key in ("conv", "state"):
        assert tnew[key].dtype == tc[key].dtype
        _close(tnew[key].numpy(), jnew[key])


def test_softplus_has_no_threshold():
    """dt = softplus(dt_raw + dt_bias) is jax.nn.softplus, log(1 + e^x),
    without torch's linear switch above 20: at x = 20.5 the two differ by
    e^-20.5, which the port must carry like JAX."""
    x = np.array([-30.0, -1.0, 0.0, 19.9, 20.5, 40.0], np.float32)
    v = _t(x)
    got = torch.logaddexp(v, torch.zeros_like(v)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.nn.softplus(jnp.asarray(x))))


def test_gated_rmsnorm_matches_jax():
    rng = np.random.default_rng(2)
    x, gate = (rng.standard_normal((2, 5, 16)).astype(np.float32) for _ in range(2))
    scale = rng.standard_normal(16).astype(np.float32)
    from repro.models import common as jcommon

    want = jcommon.gated_rmsnorm_apply({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                                       jnp.asarray(gate), 1e-5)
    got = tcommon.gated_rmsnorm_apply(tcommon.RMSNorm(_t(scale)), _t(x), _t(gate), 1e-5)
    _close(got.numpy(), want)


# --------------------------------------------------------------------------
# The smoke model: consistency, bridge, layout, packing, loss
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def unpacked():
    jcfg, tcfg = _cfgs(loss_chunk=32)
    params = jm.init_lm(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, params, jax.tree.map(np.asarray, params)


def test_prefill_decode_consistency(unpacked):
    """tests/test_ssm.py's check on the port: prefill of 20 tokens then one
    decode step against the no-cache forward over 21, within DECODE_TOL."""
    _, tcfg, _, nparams = unpacked
    model = bridge.lm_from_jax(nparams, tcfg, device="cpu")
    tok = torch.from_numpy(np.random.default_rng(1).integers(0, tcfg.vocab, (2, 21))
                           .astype(np.int32))
    with torch.no_grad():
        h, _, _ = tm.lm_hidden(model, tok, tcfg, mode="eval")
        want = tm.lm_logits(model, h[:, -1:], tcfg)[:, 0]
        cache = tm.init_cache(tcfg, 2, 32, device="cpu")
        _, cache, _ = tm.lm_hidden(model, tok[:, :20], tcfg, mode="eval", cache=cache)
        h, _, _ = tm.lm_hidden(model, tok[:, 20:], tcfg, mode="eval", cache=cache)
        got = tm.lm_logits(model, h, tcfg)[:, 0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=DECODE_TOL, atol=DECODE_TOL)


@pytest.mark.parametrize("arch", [ARCH, HYBRID])
def test_bridge_round_trip_and_packed_init(arch):
    """lm_from_jax then lm_to_jax gives back every leaf of the unpacked
    model bit for bit (SSM mixers; jamba's attention, MoE and dense layers
    in their stage positions), and init_lm(packed=True) equals
    pack_params(init_lm(...))."""
    jcfg, tcfg = _cfgs(arch)
    nparams = jax.tree.map(np.asarray, jm.init_lm(jax.random.PRNGKey(0), jcfg))
    model = bridge.lm_from_jax(nparams, tcfg, device="cpu")
    kinds = [type(layer.mixer).__name__ for layer in model.layers]
    assert kinds == ["Attention" if s.mixer == "attn" else "SSM" for s in tcfg.layer_specs()]
    want = jax.tree_util.tree_flatten_with_path(nparams)[0]
    got = jax.tree.leaves(bridge.lm_to_jax(model, tcfg))
    assert len(want) == len(got)
    for (path, a), b in zip(want, got):
        np.testing.assert_array_equal(b, a, err_msg=jax.tree_util.keystr(path))
    cfg = tget_config(arch, smoke=True)
    a = tm.pack_params(tm.init_lm(cfg, torch.Generator().manual_seed(5)), cfg).state_dict()
    b = tm.init_lm(cfg, torch.Generator().manual_seed(5), packed=True).state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _jax_leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_stacked_shapes_follow_jax_stages():
    """stacked_shapes on jamba's smoke pattern repeated twice (one stage of
    two 4-layer periods) and on mamba2 (one stage of 2): each parameter's
    shape is its JAX leaf's, the stage's repeat count leading."""
    from repro.configs.base import LayerSpec as JLayerSpec
    from repro_torch.configs import LayerSpec

    for arch in (ARCH, HYBRID):
        jcfg, tcfg = _cfgs(arch)
        if arch == HYBRID:
            specs = [dict(mixer=s.mixer, ffn=s.ffn) for s in jcfg.layer_specs()] * 2
            jcfg = jcfg.with_(n_layers=8, layers=tuple(JLayerSpec(**s) for s in specs))
            tcfg = tcfg.with_(n_layers=8, layers=tuple(LayerSpec(**s) for s in specs))
        shapes = jax.eval_shape(lambda cfg=jcfg: jm.init_lm(jax.random.PRNGKey(0), cfg))
        model = tm.init_lm(tcfg, torch.Generator().manual_seed(0))
        ((pattern, reps),) = tm.compress_layout(tcfg.layer_specs())
        assert reps == 2
        for name, shape in tm.stacked_shapes(model, tcfg).items():
            parts = name.split(".")
            if parts[0] == "layers":
                parts = ["stages", 0, f"b{int(parts[1]) % len(pattern)}", *parts[2:]]
            assert shape == _jax_leaf(shapes, parts).shape, name


def test_pack_params_packs_the_two_projections_only():
    """pack_params turns in_proj and out_proj into packed linears with
    JAX's codes and scales, and leaves the conv, A_log, D, dt_bias and the
    norm as they were (JAX packs exactly its "qw" leaves)."""
    jcfg, tcfg = _cfgs()
    p = jssm.ssm_init(jax.random.PRNGKey(3), jcfg, None)
    jp = jm.pack_params(p, jcfg)
    mod = bridge._mixer(jax.tree.map(lambda v: np.asarray(v)[None], p), 0, "cpu")
    tm.pack_params(mod, tcfg)
    packed = {n for n, m in mod.named_modules() if isinstance(m, tcommon.PackedLinear)}
    assert packed == {"in_proj", "out_proj"}
    assert {k for k, v in jp.items() if isinstance(v, dict) and "pw" in v} == packed
    for name in packed:
        got, want = getattr(mod, name).pw, jp[name]["pw"]
        for f in ("packed5", "packed4"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
        np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale), rtol=1e-6)
    for key in ("conv_w", "conv_b", "A_log", "D", "dt_bias"):
        np.testing.assert_array_equal(getattr(mod, key).numpy(), np.asarray(p[key]))


def test_lm_loss_matches_jax(unpacked):
    """lm_loss in f32 (QAT, S 40 over chunks of 16 with a padded tail, a
    loss mask): loss, ce and every gradient leaf against
    jax.value_and_grad. No kernel is involved: the scan's backward is
    autograd's."""
    jcfg, tcfg, params, nparams = unpacked
    model = bridge.lm_from_jax(nparams, tcfg, device="cpu").requires_grad_(True)
    rng = np.random.default_rng(3)
    tok, lab = (rng.integers(0, jcfg.vocab, (2, 40)).astype(np.int32) for _ in range(2))
    mask = (rng.random((2, 40)) < 0.8).astype(np.float32)
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: jm.lm_loss(p, jnp.asarray(tok), jnp.asarray(lab), jcfg,
                             loss_mask=jnp.asarray(mask)), has_aux=True)(params)
    tl, tmet = tm.lm_loss(model, torch.from_numpy(tok), torch.from_numpy(lab), tcfg,
                          loss_mask=torch.from_numpy(mask))
    for got, want in ((tl, jl), (tmet["ce"], jmet["ce"])):
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


# --------------------------------------------------------------------------
# Refusals
# --------------------------------------------------------------------------
def _error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("arch", [ARCH, HYBRID])
@pytest.mark.parametrize("what", ["paged", "chunked", "spec"])
def test_engine_refuses_ssm_layers_with_jax_text(arch, what):
    """Paging, chunked prefill and speculation need per-position caches
    that roll back; both engines refuse SSM layers with the same text."""
    jcfg, tcfg = _cfgs(arch)
    kw = {"paged": lambda pkg: dict(paged_kv=pkg.PagedKVConfig(page_size=8)),
          "chunked": lambda pkg: dict(prefill_chunk=16),
          "spec": lambda pkg: dict(spec=(jspec if pkg is js else tspec).SpecConfig(k=3))}[what]
    want = _error(lambda: js.Engine(None, jcfg, max_slots=2, max_len=64, **kw(js)))
    got = _error(lambda: ts.Engine(None, tcfg, max_slots=2, max_len=64, device="cpu", **kw(ts)))
    assert got == want and "ssm" in got


def test_verify_and_paged_cache_refuse_ssm_with_jax_text(unpacked):
    """verify_step raises on an SSM layer (its state cannot be verified),
    and a paged cache refuses SSM layers, with JAX's texts."""
    jcfg, tcfg, params, nparams = unpacked
    tok = np.zeros((1, 3), np.int32)
    want = _error(lambda: jm.verify_step(params, jnp.asarray(tok),
                                         jm.init_cache(jcfg, 1, 16), jcfg))
    model = bridge.lm_from_jax(nparams, tcfg, device="cpu")
    got = _error(lambda: tm.verify_step(model, torch.from_numpy(tok),
                                        tm.init_cache(tcfg, 1, 16, device="cpu"), tcfg))
    assert got == want and "ssm" in got
    spec = tcfg.layer_specs()[0]
    want = _error(lambda: jm.init_cache(jcfg, 1, 16, page_size=8, n_pages=4))
    got = _error(lambda: tblocks.block_cache_init(tcfg, spec, 1, 16, torch.bfloat16, "cpu",
                                                  page_size=8, n_pages=4))
    assert got == want


# --------------------------------------------------------------------------
# Serving against the JAX engine
# --------------------------------------------------------------------------
_STATS = ("prefill_tokens", "prefill_pad_tokens", "decode_tokens", "decode_steps", "chunk_steps",
          "spec_steps", "spec_slot_steps", "spec_skipped_steps", "drafted_tokens",
          "accepted_tokens", "verified_nodes", "completed", "rejected",
          "prefix_hit_tokens", "prefix_hit_requests")
#: prompt lengths: exact-length prefill runs one short chunk (7, 4), a
#: padded second chunk (19, 25) and three chunks (34) of 16
SERVE_LENS = (7, 19, 34, 4, 25)
#: jamba's: each length is a JAX prefill compile of its own (interpreted
#: Pallas under vmapped MoE experts), so fewer lengths, one of them reused
HYBRID_LENS = (19, 4, 19, 4)
#: (impl, fusion) of both engines
SERVE_PATHS = {"decode": ("decode", "fused"), "lookup": ("lookup", "fused"),
               "unfused": ("decode", "unfused")}


@pytest.fixture(scope="module")
def served():
    """arch → (cfgs, packed JAX params, their numpy leaves), built once."""
    @functools.cache
    def get(arch):
        jcfg, tcfg = _cfgs(arch)
        params = jm.pack_params(jm.init_lm(jax.random.PRNGKey(0), jcfg), jcfg)
        return jcfg, tcfg, params, jax.tree.map(np.asarray, params)
    return get


def _serve(pkg, eng, prompts, max_new=6):
    sched = pkg.ContinuousBatchingScheduler(eng)
    reqs = [pkg.Request(rid=i, prompt=p.copy(), max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    sched.submit(reqs)
    return [r.generated for r in reqs], sched.run_to_completion()


@pytest.mark.parametrize("arch,path", [(ARCH, p) for p in SERVE_PATHS] + [(HYBRID, "decode")])
def test_engine_matches_jax(served, arch, path):
    """Greedy whole-prompt serving in f32 with 3 slots: exact-length
    admission (no bucket, no left pad), then recurrent decode. The port's
    engine emits the JAX engine's tokens exactly and every ServeStats
    counter matches (prefill_pad_tokens 0). mamba2 on every path; jamba
    (SSM, attention and MoE layers) on fused decode."""
    jcfg, tcfg, params, nparams = served(arch)
    impl, fusion = SERVE_PATHS[path]
    lens = SERVE_LENS if arch == ARCH else HYBRID_LENS
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab, size=n).astype(np.int32) for n in lens]
    common = dict(max_slots=3, max_len=64, mpgemm_impl=impl, mpgemm_fusion=fusion)
    jeng = js.Engine(params, jcfg, mpgemm_interpret=True, **common)
    teng = ts.Engine(bridge.lm_from_jax(nparams, tcfg, device="cpu"), tcfg, device="cpu",
                     **common)
    want, jst = _serve(js, jeng, prompts)
    got, tst = _serve(ts, teng, prompts)
    assert got == want and all(len(g) == 6 for g in got)
    for f in _STATS:
        assert getattr(tst, f) == getattr(jst, f), f
    assert tst.prefill_pad_tokens == 0 and tst.prefill_tokens == sum(lens)


def test_jamba_prefill_and_decode_logits_match_jax():
    """jamba's smoke model packed (SSM, attention, dense and MoE layers):
    prefill logits and three decode steps' logits against JAX's packed path
    (Pallas decode kernel interpreted), to OUT_RTOL of the largest logit."""
    jcfg, tcfg = _cfgs(HYBRID)
    params = jm.pack_params(jm.init_lm(jax.random.PRNGKey(1), jcfg), jcfg)
    model = bridge.lm_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    rng = np.random.default_rng(4)
    tok = rng.integers(0, jcfg.vocab, (2, 21)).astype(np.int32)
    jpre = jax.jit(functools.partial(jm.prefill, cfg=jcfg))
    jdec = jax.jit(functools.partial(jm.decode_step, cfg=jcfg))
    with jops.dispatch_override(impl="decode", interpret=True):
        wants = [jpre(params, jnp.asarray(tok[:, :18]), jm.init_cache(jcfg, 2, 32))]
        for t in range(18, 21):
            wants.append(jdec(params, jnp.asarray(tok[:, t:t + 1]), wants[-1][1]))
    with ops.dispatch_override(impl="decode"), torch.no_grad():
        gots = [tm.prefill(model, _t(tok[:, :18]), tm.init_cache(tcfg, 2, 32, device="cpu"), tcfg)]
        for t in range(18, 21):
            gots.append(tm.decode_step(model, _t(tok[:, t:t + 1]), gots[-1][1], tcfg))
    for (got, _), (want, _) in zip(gots, wants):
        _close(got.numpy(), want)
