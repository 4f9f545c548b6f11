"""The port's architecture registry and its four dense GQA architectures
(gemma3-1b, internlm2-1.8b, command-r-35b, chameleon-34b) against the JAX
package, in f32 on their smoke configs: every registered config (the
ten of the JAX package, whisper-medium's included) equal to JAX's field by
field, prefill and decode logits of the packed models
(JAX's Pallas decode kernel interpreted, the port's plain version) over
gemma3's window of 16 (the ring cache wraps), dual RoPE bases, q/k norms,
the embedding scale and tied and untied heads, the four models' greedy
whole-prompt serving against the JAX engine, and the engine's refusals of
windowed layers with JAX's texts.

Tolerance: `OUT_RTOL` bounds max |port - JAX| of the logits relative to
their largest entry: the packages take float sums (norms, attention,
softmax) in other orders, a few f32 ulp apart. An activation that lies
within an ulp of an int8 rounding boundary can take another code in the
two packages (ROADMAP C 1): with the token seed 4, gemma3's second row
holds one 1.9e-6 of a step from the boundary and its logits part by 4e-3
of their largest entry from the prefill on, so the tokens come from seed
5, which holds no such activation. Serving parity is exact: tokens and
every `ServeStats` counter."""
import dataclasses
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
from repro.configs import list_archs as jlist_archs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch import serve as ts  # noqa: E402
from repro_torch import spec as tspec  # noqa: E402
from repro_torch.configs import _MODULES  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

ARCHS = ("smollm-360m", "gemma3-1b", "internlm2-1.8b", "command-r-35b", "chameleon-34b",
         "llama4-scout-17b-a16e", "deepseek-v3-671b", "mamba2-1.3b", "jamba-1.5-large-398b",
         "whisper-medium")
DENSE = ("gemma3-1b", "internlm2-1.8b", "command-r-35b", "chameleon-34b")
OUT_RTOL = 1e-5
#: prefill length and decode steps: gemma3's smoke window is 16, so the
#: prefill fills 14 of its ring slots and the decode steps wrap it
PREFILL, STEPS = 14, 6


@pytest.mark.parametrize("smoke", [False, True], ids=["published", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_jax(arch, smoke):
    """Every field, nested ones (layer specs, MoE, MLA, SSM) included."""
    assert dataclasses.asdict(tget_config(arch, smoke=smoke)) == \
        dataclasses.asdict(jget_config(arch, smoke=smoke))


def test_registry_is_every_decoder_only_arch():
    """The port registers every architecture of the JAX package, the
    encoder-decoder whisper-medium included, and refuses an unknown id as
    JAX does."""
    assert sorted(_MODULES) == sorted(ARCHS) == sorted(jlist_archs())
    with pytest.raises(KeyError, match="no-such-arch"):
        tget_config("no-such-arch")


def _cfgs(arch):
    return (jget_config(arch, smoke=True).with_(dtype="float32"),
            tget_config(arch, smoke=True).with_(dtype="float32"))


@pytest.fixture(scope="module")
def packed():
    """arch → (cfgs, packed JAX params, the port's model), built once."""
    @functools.cache
    def get(arch):
        jcfg, tcfg = _cfgs(arch)
        params = jm.pack_params(jm.init_lm(jax.random.PRNGKey(0), jcfg), jcfg)
        model = bridge.lm_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
        return jcfg, tcfg, params, model
    return get


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=OUT_RTOL * np.abs(want).max())


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_jax(packed, arch):
    """A 14-token prefill and 6 decode steps (B 2, max_len 32): the logits
    of each against JAX's, to OUT_RTOL; on gemma3 the decode steps wrap
    the windowed layers' ring of 16."""
    jcfg, tcfg, params, model = packed(arch)
    tok = np.random.default_rng(5).integers(0, jcfg.vocab, (2, PREFILL + STEPS)).astype(np.int32)
    jpre = jax.jit(functools.partial(jm.prefill, cfg=jcfg))
    jdec = jax.jit(functools.partial(jm.decode_step, cfg=jcfg))
    with jops.dispatch_override(impl="decode", interpret=True):
        wants = [jpre(params, jnp.asarray(tok[:, :PREFILL]), jm.init_cache(jcfg, 2, 32))]
        for t in range(PREFILL, PREFILL + STEPS):
            wants.append(jdec(params, jnp.asarray(tok[:, t:t + 1]), wants[-1][1]))
    with ops.dispatch_override(impl="decode"), torch.no_grad():
        cache = tm.init_cache(tcfg, 2, 32, device="cpu")
        gots = [tm.prefill(model, torch.from_numpy(tok[:, :PREFILL]), cache, tcfg)]
        for t in range(PREFILL, PREFILL + STEPS):
            gots.append(tm.decode_step(model, torch.from_numpy(tok[:, t:t + 1]), gots[-1][1],
                                       tcfg))
    if arch == "gemma3-1b":
        ring = [layer["k"].shape[1] for layer in gots[-1][1]]
        assert min(ring) == 16 < PREFILL + STEPS and max(ring) == 32
    for (got, _), (want, _) in zip(gots, wants):
        _close(got.numpy(), want)


# --------------------------------------------------------------------------
# Serving the four dense smoke models against the JAX engine
# --------------------------------------------------------------------------
_STATS = ("prefill_tokens", "prefill_pad_tokens", "decode_tokens", "decode_steps", "chunk_steps",
          "spec_steps", "spec_slot_steps", "spec_skipped_steps", "drafted_tokens",
          "accepted_tokens", "verified_nodes", "completed", "rejected",
          "prefix_hit_tokens", "prefix_hit_requests")
#: 19, 34 and 25 tokens wrap gemma3's ring of 16 in prefill, every prompt in decode
SERVE_LENS = (7, 19, 34, 4, 25)


def _serve(pkg, eng, prompts, max_new=14):
    sched = pkg.ContinuousBatchingScheduler(eng)
    reqs = [pkg.Request(rid=i, prompt=p.copy(), max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    sched.submit(reqs)
    return [r.generated for r in reqs], sched.run_to_completion()


@pytest.mark.parametrize("arch", DENSE)
def test_engine_matches_jax(packed, arch):
    """Greedy whole-prompt serving in f32 with 3 slots and 14 new tokens:
    the port's engine emits the JAX engine's tokens exactly and every
    ServeStats counter matches."""
    jcfg, tcfg, params, model = packed(arch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab, size=n).astype(np.int32) for n in SERVE_LENS]
    common = dict(max_slots=3, max_len=64, mpgemm_impl="decode")
    want, jst = _serve(js, js.Engine(params, jcfg, mpgemm_interpret=True, **common), prompts)
    got, tst = _serve(ts, ts.Engine(model, tcfg, device="cpu", **common), prompts)
    assert got == want and all(len(g) == 14 for g in got)
    for f in _STATS:
        assert getattr(tst, f) == getattr(jst, f), f


def _error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("what", ["paged", "chunked", "spec"])
def test_engine_refuses_windowed_layers_with_jax_text(what):
    """Paging, chunked prefill and speculation are exact only for
    full-buffer caches; both engines refuse gemma3's ring-cache layers with
    the same text."""
    jcfg, tcfg = _cfgs("gemma3-1b")
    kw = {"paged": lambda pkg: dict(paged_kv=pkg.PagedKVConfig(page_size=8)),
          "chunked": lambda pkg: dict(prefill_chunk=16),
          "spec": lambda pkg: dict(spec=(jspec if pkg is js else tspec).SpecConfig(k=3))}[what]
    want = _error(lambda: js.Engine(None, jcfg, max_slots=2, max_len=64, **kw(js)))
    got = _error(lambda: ts.Engine(None, tcfg, max_slots=2, max_len=64, device="cpu", **kw(ts)))
    assert got == want and "windowed" in got
