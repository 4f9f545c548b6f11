"""The port's Multi-head Latent Attention and deepseek-v3-671b's smoke config
against the JAX package (`repro.models.mla`, the JAX engine) on seeded
inputs in f32: `mla_apply` on each of its paths (the naive expansion with
and without a cache, the absorbed decode and verify, the chunked-prefill
`prefill_resume` read, tree verify) and each `wkv_b` kind, the latent
cache's size (tests/test_attention.py `TestMLA`), `verify_step` against
sequential decode (tests/test_spec.py), `compact_tree_cache` on dense and
paged latent caches, the bridge, and greedy serving against the JAX
`Engine` in whole-prompt, chunked + chain (its last chunk crossing
max_len), tree and paged (whole-prompt and chunked) modes.

The JAX side runs its packed path under `dispatch_override(impl="decode",
interpret=True)` (the Pallas kernels interpreted), the port its fused
kernels' plain versions: both sum each packed segment in f32 (ROADMAP C 1).

Tolerances: `OUT_RTOL` bounds max |port - JAX| of an `mla_apply` output
(and of the latents it writes) relative to the output's largest entry:
the two packages take float sums (norms, the absorbed einsums, the
softmax) in other orders, a few f32 ulp apart (~6e-7 observed).
`VERIFY_TOL` is tests/test_spec.py's bound of verify against sequential
decode. Serving parity is exact: tokens and every `ServeStats` counter."""
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
from repro.kernels import ops as jops  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch import serve as ts  # noqa: E402
from repro_torch import spec as tspec  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.models import mla as tmla  # noqa: E402

ARCH = "deepseek-v3-671b"
OUT_RTOL = 1e-5
VERIFY_TOL = 2e-4
B, L = 2, 16                      # the mla_apply cases' batch and cache length
IDX = np.array([5, 9], np.int32)  # their cache write positions


def _cfgs(**kw):
    return (jget_config(ARCH, smoke=True).with_(dtype="float32", **kw),
            tget_config(ARCH, smoke=True).with_(dtype="float32", **kw))


def _port_mixer(p):
    """The port's MLA from a JAX `mla_init` dict (stacked as one layer)."""
    return bridge._mixer(jax.tree.map(lambda a: np.asarray(a)[None], p), 0, "cpu")


@pytest.fixture(scope="module")
def mla_params():
    """{kind: (JAX params, port MLA, cfgs, mode)} for the three wkv_b kinds
    `_wkv_b_dense` reads: packed ("pw", served), QAT ("qw", eval) and
    non-quantized ("w")."""
    jcfg, tcfg = _cfgs()
    p = jmla.mla_init(jax.random.PRNGKey(0), jcfg, None)
    wcfg = _cfgs(quant="none")
    pw = jm.pack_params(p, jcfg)
    pn = jmla.mla_init(jax.random.PRNGKey(1), wcfg[0], None)
    return {"pw": (pw, _port_mixer(pw), (jcfg, tcfg), "serve"),
            "qw": (p, _port_mixer(p), (jcfg, tcfg), "eval"),
            "w": (pn, _port_mixer(pn), wcfg, "serve")}


#: (path, tokens S, mla_apply options); "tree" uses DraftTree (2, 2) of depth 2
PATHS = {
    "naive": (7, None),
    "prefill": (6, {}),
    "decode": (1, {}),
    "verify": (4, dict(verify=True)),
    "resume": (4, dict(verify=True, prefill_resume=True)),
    "tree": (7, dict(verify=True, tree=True)),
}


@pytest.mark.parametrize("path,kind", [(p, "pw") for p in PATHS]
                         + [("naive", "qw"), ("decode", "qw"), ("decode", "w")])
def test_mla_apply_matches_jax(mla_params, path, kind):
    """One mla_apply call of both packages on the same weights, input and
    cache (random latents, write positions 5 and 9 of 16): the output and
    the latents written, to OUT_RTOL, and the advanced idx exactly."""
    jp, mod, (jcfg, tcfg), mode = mla_params[kind]
    s, opts = PATHS[path]
    rng = np.random.default_rng(len(path) + len(kind))
    x = rng.standard_normal((B, s, jcfg.d_model)).astype(np.float32)
    jkw, tkw = dict(opts or {}), dict(opts or {})
    if "tree" in jkw:
        jkw["tree"], tkw["tree"] = jspec.build_tree(2, (2, 2)), tspec.build_tree(2, (2, 2))
        assert jkw["tree"].n_nodes == s
    jc = tc = None
    if opts is not None:
        kvl, rp = jcfg.mla.kv_lora_rank, jcfg.mla.qk_rope_dim
        ckv = rng.standard_normal((B, L, kvl)).astype(np.float32)
        krope = rng.standard_normal((B, L, rp)).astype(np.float32)
        jc = {"ckv": jnp.asarray(ckv), "krope": jnp.asarray(krope), "idx": jnp.asarray(IDX)}
        tc = {"ckv": torch.from_numpy(ckv), "krope": torch.from_numpy(krope),
              "idx": torch.from_numpy(IDX.copy())}

    jfn = jax.jit(functools.partial(jmla.mla_apply, cfg=jcfg, spec=None, mode=mode, **jkw))
    with jops.dispatch_override(impl="decode", interpret=True):
        want, jnew = jfn(jp, jnp.asarray(x), cache=jc)
    with torch.no_grad():
        got, tnew = tmla.mla_apply(mod, torch.from_numpy(x), cfg=tcfg, spec=None, mode=mode,
                                   cache=tc, **tkw)
    want = np.asarray(want)
    assert got.shape == want.shape == (B, s, jcfg.d_model)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=OUT_RTOL * scale)
    if opts is None:
        assert tnew is None and jnew is None
        return
    np.testing.assert_array_equal(tnew["idx"].numpy(), np.asarray(jnew["idx"]))
    for key in ("ckv", "krope"):
        np.testing.assert_allclose(tnew[key].numpy(), np.asarray(jnew[key]), rtol=0,
                                   atol=OUT_RTOL * np.abs(np.asarray(jnew[key])).max())


def test_dense_writes_drop_past_the_buffer_and_wrap_negative_positions():
    """The latent writes follow JAX's scatter with mode="drop": a position
    past the buffer end is dropped, a negative (left-padding) one wraps
    onto the buffer's end."""
    leaf = torch.zeros((2, 6, 3))
    slots = torch.tensor([[4, 5, 6, 7], [-2, -1, 0, 1]], dtype=torch.int32)
    vals = torch.arange(1, 25, dtype=torch.float32).reshape(2, 4, 3)
    tmla._write_dense(leaf, slots, vals)
    want = np.asarray(jnp.zeros((2, 6, 3)).at[jnp.arange(2)[:, None], jnp.asarray(slots.numpy())]
                      .set(jnp.asarray(vals.numpy()), mode="drop"))
    np.testing.assert_array_equal(leaf.numpy(), want)


def test_latent_cache_is_compact():
    """The MLA cache-compression win (tests/test_attention.py TestMLA): the
    latent and rope key per token take less than half of naive K+V; the
    layouts are JAX's (the paged pools one sink page longer)."""
    jcfg, tcfg = _cfgs()
    c = tmla.mla_cache_init(tcfg, None, 2, 10, torch.bfloat16, "cpu")
    jc = jmla.mla_cache_init(jcfg, None, batch=2, max_len=10, dtype=jnp.bfloat16)
    assert {k: tuple(v.shape) for k, v in c.items()} == {k: v.shape for k, v in jc.items()}
    per_tok = c["ckv"].shape[-1] + c["krope"].shape[-1]
    assert per_tok < tcfg.n_heads * tcfg.mla.v_dim * 2 / 2
    pc = tmla.mla_cache_init(tcfg, None, 2, 16, torch.bfloat16, "cpu", page_size=8, n_pages=5)
    jpc = jmla.mla_cache_init(jcfg, None, 2, 16, jnp.bfloat16, page_size=8, n_pages=5)
    assert tuple(pc["ckv"].shape) == (6,) + jpc["ckv"].shape[1:]
    assert tuple(pc["tab"].shape) == jpc["tab"].shape and "slot_pos" not in pc


# --------------------------------------------------------------------------
# The decoder on the smoke model
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def unpacked():
    """The JAX smoke model's QAT weights (f32), as numpy leaves."""
    jcfg, tcfg = _cfgs()
    return jcfg, tcfg, jm.init_lm(jax.random.PRNGKey(0), jcfg)


@pytest.fixture(scope="module")
def served(unpacked):
    jcfg, tcfg, params = unpacked
    params = jm.pack_params(params, jcfg)
    return jcfg, tcfg, params, jax.tree.map(np.asarray, params)


def test_absorbed_decode_close_to_naive(unpacked):
    """The absorbed decode after a prefill against the naive no-cache
    forward over the same 17 tokens (tests/test_attention.py TestMLA's
    check, here on the f32 smoke model's QAT weights in 'eval'): only the
    int8 activation quantization differs, within that test's bound."""
    jcfg, cfg, params = unpacked
    model = bridge.lm_from_jax(jax.tree.map(np.asarray, params), cfg, device="cpu")
    tok = torch.from_numpy(np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 17), 0,
                                                         jcfg.vocab)).astype(np.int32))
    with torch.no_grad():
        h, _, _ = tm.lm_hidden(model, tok, cfg, mode="eval")
        want = tm.lm_logits(model, h[:, -1:], cfg)[:, 0]
        cache = tm.init_cache(cfg, 2, 24, device="cpu")
        _, cache, _ = tm.lm_hidden(model, tok[:, :16], cfg, mode="eval", cache=cache)
        h, _, _ = tm.lm_hidden(model, tok[:, 16:], cfg, mode="eval", cache=cache)
        got = tm.lm_logits(model, h, cfg)[:, 0]
    rel = (got - want).abs().max() / (want.abs().max() + 1e-9)
    assert rel < 5e-2, rel


def _model(served):
    return bridge.lm_from_jax(served[3], served[1], device="cpu")


def _clone(cache):
    return [{k: v.clone() for k, v in layer.items()} for layer in cache]


def _sequential(model, cache, toks, cfg):
    cache = _clone(cache)
    out = []
    for t in toks:
        logits, cache = tm.decode_step(model, torch.tensor([[t]], dtype=torch.int32), cache, cfg)
        out.append(logits[0])
    return torch.stack(out), cache


def test_verify_matches_sequential_decode(served):
    """verify_step on the absorbed-latent path (tests/test_spec.py): a
    chain of K+1 tokens equals K+1 sequential decode steps and leaves the
    same idx; every node of a (2, 2) tree equals sequential decode along
    its root-to-node path."""
    _, tcfg, _, _ = served
    model = _model(served)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(0, tcfg.vocab, (1, 12))
                              .astype(np.int32))
    logits, cache = tm.prefill(model, prompt, tm.init_cache(tcfg, 1, 64, device="cpu"), tcfg)
    t0 = int(torch.argmax(logits[0]))
    toks = [t0, 17, 401, 3]
    seq, seq_cache = _sequential(model, cache, toks, tcfg)
    ver, ver_cache = tm.verify_step(model, torch.tensor([toks], dtype=torch.int32),
                                    _clone(cache), tcfg)
    np.testing.assert_allclose(ver[0].numpy(), seq.numpy(), rtol=VERIFY_TOL, atol=VERIFY_TOL)
    for s, v in zip(seq_cache, ver_cache):
        np.testing.assert_array_equal(s["idx"].numpy(), v["idx"].numpy())
    tree = tspec.build_tree(3, (2, 2))
    ttoks = np.random.default_rng(1).integers(0, tcfg.vocab, tree.n_nodes).astype(np.int32)
    ttoks[0] = t0
    ver, _ = tm.verify_step(model, torch.from_numpy(ttoks[None]), _clone(cache), tcfg, tree=tree)
    for path in tree.leaf_paths:
        seq, _ = _sequential(model, cache, [int(ttoks[j]) for j in path], tcfg)
        np.testing.assert_allclose(ver[0, path].numpy(), seq.numpy(),
                                   rtol=VERIFY_TOL, atol=VERIFY_TOL)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_compact_tree_cache_matches_jax(paged):
    """compact_tree_cache on latent caches (ckv, krope: no slot_pos) against
    JAX's, on random caches and windows: a row's winning path moved onto
    contiguous slots, a row whose window crosses the buffer end, and a row
    left as it was (identity sel, take = N). Paged: through a block table
    with unmapped pages; the port's pools carry one sink page more."""
    rng = np.random.default_rng(3)
    n_pages, ps, cap, kvl, rp, b, n = 9, 4, 4, 6, 2, 3, 5
    length = cap * ps
    shape = (n_pages + 1, ps) if paged else (b, length)
    leaves = {k: rng.standard_normal(shape + (d,)).astype(np.float32)
              for k, d in (("ckv", kvl), ("krope", rp))}
    pos = np.array([3, length - 3, 7])
    sel = np.tile(np.arange(n), (b, 1))
    sel[0, 1:4] = [2, 4, 3]
    take = np.array([4, 2, n])
    tcache = {k: torch.from_numpy(v.copy()) for k, v in leaves.items()}
    tcache["idx"] = torch.zeros(b, dtype=torch.int32)
    jleaf = {k: jnp.asarray(v[:n_pages] if paged else v)[None] for k, v in leaves.items()}
    jleaf["idx"] = jnp.zeros((1, b), jnp.int32)
    if paged:
        tab = np.array([[1, 2, 3, 0], [4, 5, 6, 7], [8, 0, 0, 0]], np.int32)
        tcache["tab"] = torch.from_numpy(tab)
        jleaf["tab"] = jnp.asarray(tab)[None]
    tm.compact_tree_cache([tcache], torch.from_numpy(pos), torch.from_numpy(sel),
                          torch.from_numpy(take))
    jout = jm.compact_tree_cache([{"b0": jleaf}], jnp.asarray(pos), jnp.asarray(sel),
                                 jnp.asarray(take))
    for k in ("ckv", "krope"):
        got = tcache[k].numpy()
        np.testing.assert_array_equal(got[:n_pages] if paged else got, np.asarray(jout[0]["b0"][k])[0])
        assert not np.array_equal(got, leaves[k])


def test_bridge_round_trip_and_packed_init(unpacked):
    """lm_from_jax then lm_to_jax gives back every leaf of the unpacked
    deepseek smoke model (MLA mixers, dense and MoE FFNs) bit for bit, and
    init_lm(packed=True) equals pack_params(init_lm(...))."""
    jcfg, tcfg, params = unpacked
    nparams = jax.tree.map(np.asarray, params)
    model = bridge.lm_from_jax(nparams, tcfg, device="cpu")
    assert all(isinstance(layer.mixer, tmla.MLA) for layer in model.layers)
    want = jax.tree_util.tree_flatten_with_path(nparams)[0]
    got = jax.tree.leaves(bridge.lm_to_jax(model, tcfg))
    assert len(want) == len(got)
    for (path, a), b in zip(want, got):
        np.testing.assert_array_equal(b, a, err_msg=jax.tree_util.keystr(path))
    cfg = tget_config(ARCH, smoke=True)
    a = tm.pack_params(tm.init_lm(cfg, torch.Generator().manual_seed(5)), cfg).state_dict()
    b = tm.init_lm(cfg, torch.Generator().manual_seed(5), packed=True).state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


# --------------------------------------------------------------------------
# Serving the deepseek smoke model against the JAX engine
# --------------------------------------------------------------------------
_STATS = ("prefill_tokens", "prefill_pad_tokens", "decode_tokens", "decode_steps", "chunk_steps",
          "spec_steps", "spec_slot_steps", "spec_skipped_steps", "drafted_tokens",
          "accepted_tokens", "verified_nodes", "completed", "rejected",
          "prefix_hit_tokens", "prefix_hit_requests")
#: prompt lengths; the chunked case's 81-token prompt ends in a chunk
#: writing positions 80..95 past its max_len of 90 (those columns dropped)
SERVE_CASES = {
    "whole_prompt": dict(lens=(7, 19, 34, 4, 25)),
    "chunked_chain": dict(lens=(7, 19, 34, 4, 81), max_len=90, prefill_chunk=16, spec=dict(k=3)),
    "tree": dict(lens=(12, 8, 25), spec=dict(k=3, tree=(2, 2))),
    "paged": dict(lens=(7, 19, 34, 4, 25), paged=dict(page_size=8)),
    "paged_chunked": dict(lens=(7, 19, 34), paged=dict(page_size=8), prefill_chunk=16),
}


def _serve(pkg, eng, prompts, max_new=6):
    sched = pkg.ContinuousBatchingScheduler(eng)
    reqs = [pkg.Request(rid=i, prompt=p.copy(), max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    sched.submit(reqs)
    return [r.generated for r in reqs], sched.run_to_completion()


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_engine_matches_jax(served, case):
    """Greedy serving in f32 with 3 slots: the port's engine emits the JAX
    engine's tokens exactly and every ServeStats counter matches. MLA
    decode rows never ride a chunk step (absorbed decode, resume reads):
    both engines run a decode step of their own each tick."""
    jcfg, tcfg, params, nparams = served
    kw = dict(SERVE_CASES[case])
    lens, spec, paged = kw.pop("lens"), kw.pop("spec", None), kw.pop("paged", None)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab, size=n).astype(np.int32) for n in lens]
    if case == "tree":      # a repetitive prompt the n-gram drafter can follow
        prompts[0] = np.tile([7, 3, 9], 4).astype(np.int32)
    common = dict(max_slots=3, max_len=kw.pop("max_len", 96), **kw)
    jeng = js.Engine(params, jcfg, spec=None if spec is None else jspec.SpecConfig(**spec),
                     paged_kv=None if paged is None else js.PagedKVConfig(**paged),
                     mpgemm_impl="decode", mpgemm_interpret=True, **common)
    teng = ts.Engine(bridge.lm_from_jax(nparams, tcfg, device="cpu"), tcfg, device="cpu",
                     spec=None if spec is None else tspec.SpecConfig(**spec),
                     paged_kv=None if paged is None else ts.PagedKVConfig(**paged), **common)
    assert not teng._decode_rides
    want, jst = _serve(js, jeng, prompts)
    got, tst = _serve(ts, teng, prompts)
    assert got == want and all(len(g) == 6 for g in got)
    for f in _STATS:
        assert getattr(tst, f) == getattr(jst, f), f
    if spec is not None:
        assert tst.spec_steps > 0
    if kw.get("prefill_chunk"):
        assert tst.chunk_steps > 0
