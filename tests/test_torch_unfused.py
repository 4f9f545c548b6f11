"""The unfused mpGeMM pipeline of repro_torch against the JAX package's: the
integer kernels' plain versions against the JAX Pallas kernels in interpret
mode (as the JAX package's own CPU tests run them), `vlut_mpgemm` and
`segment_mpgemm` with fusion off, the dispatch knob, the wrappers' device
contract, and greedy serving with `Engine(mpgemm_fusion="unfused")`."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import models as jm  # noqa: E402
from repro import serve as js  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import pack_ternary as jpack_ternary  # noqa: E402
from repro.core import pack_weight as jpack_weight  # noqa: E402
from repro.core import ternary_quantize as jternary  # noqa: E402
from repro.kernels import segment_mpgemm as jsegment_mpgemm  # noqa: E402
from repro.kernels import ternary_decode_gemm as jdecode  # noqa: E402
from repro.kernels import vlut_lookup_gemm as jlookup  # noqa: E402
from repro.kernels import vlut_mpgemm as jvlut_mpgemm  # noqa: E402
from repro_torch import bridge, resolve_device  # noqa: E402
from repro_torch import serve as ts  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.core import PackedWeight  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ternary_decode_gemm as tdg  # noqa: E402
from repro_torch.kernels import vlut_lookup_gemm as vlg  # noqa: E402

INT_KERNELS = {"decode": tdg.ternary_decode_gemm, "lookup": vlg.vlut_lookup_gemm}
ALL_KERNELS = (tdg.ternary_decode_gemm, vlg.vlut_lookup_gemm,
               tdg.ternary_decode_gemm_fused, vlg.vlut_lookup_gemm_fused)
# (M, KG, N) of the JAX suite's integer-kernel tests (tests/test_kernels.py)
INT_SHAPES = [(8, 1, 8), (16, 4, 32), (64, 16, 128), (128, 40, 256), (256, 7, 64)]
# the JAX kernels' blocks; min() clamps them, and every shape above divides
BLOCKS = dict(bm=32, bn=64, bkg=8)


def _int_operands(m, kg, n, g, seed):
    """(JAX packed, JAX a_r, port packed, port a_r, ternary w, a_q)."""
    rng = np.random.default_rng(seed)
    w = rng.integers(-1, 2, (m, kg * g)).astype(np.int8)
    a_q = rng.integers(-127, 128, (kg * g, n)).astype(np.int8)
    packed = jpack_ternary(jnp.asarray(w), g)
    a_r = np.ascontiguousarray(a_q.reshape(kg, g, n).transpose(1, 0, 2))
    return packed, jnp.asarray(a_r), torch.tensor(np.asarray(packed)), torch.from_numpy(a_r), w, a_q


def _jax_int(kernel, packed, a_r, g):
    if kernel == "decode":
        return jdecode(packed, a_r, g=g, interpret=True, **BLOCKS)
    return jlookup(packed, a_r, g=g, lookup=kernel.removeprefix("lookup-"), interpret=True, **BLOCKS)


@pytest.mark.parametrize("kernel", ["decode", "lookup-onehot", "lookup-serial"])
@pytest.mark.parametrize("g", [4, 5])
@pytest.mark.parametrize("m,kg,n", INT_SHAPES)
def test_plain_int_kernels_match_jax_interpret(kernel, g, m, kg, n):
    """Each integer wrapper (its plain version on the CPU) against the JAX
    Pallas kernel of the same name, interpreted, bit for bit; the lookup
    against both of JAX's row-select lowerings."""
    jp, ja, tp, ta, w, a_q = _int_operands(m, kg, n, g, seed=m + kg + g)
    want = np.asarray(_jax_int(kernel, jp, ja, g))
    got = INT_KERNELS[kernel.split("-")[0]](tp, ta, g=g)
    assert got.dtype == torch.int32 and got.shape == (m, n) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), w.astype(np.int32) @ a_q.astype(np.int32))


@pytest.mark.parametrize("impl", ["decode", "lookup"])
@pytest.mark.parametrize("g", [4, 5])
def test_int_kernels_saturated(impl, g):
    """All +1 weights and activations 127: every sum is 127*K, exact in
    int32 (and each table entry 127*g, exact in int16)."""
    m, kg, n = 8, 64, 16
    k = kg * g
    packed = jpack_ternary(jnp.ones((m, k), jnp.int8), g)
    a_r = np.full((g, kg, n), 127, np.int8)
    got = INT_KERNELS[impl](torch.tensor(np.asarray(packed)), torch.from_numpy(a_r), g=g)
    assert int(got.min()) == int(got.max()) == 127 * k
    want = np.asarray(jdecode(packed, jnp.asarray(a_r), g=g, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)


def _packed(m, k, seed=0):
    """(JAX PackedWeight, port PackedWeight) of the same weights."""
    rng = np.random.default_rng(seed)
    tw = jternary(jnp.asarray(rng.standard_normal((m, k)).astype(np.float32)))
    jp = jpack_weight(tw.values, tw.scale)
    tp = PackedWeight(torch.tensor(np.asarray(jp.packed5)), torch.tensor(np.asarray(jp.packed4)),
                      torch.tensor(np.asarray(jp.scale)), K=jp.K)
    return jp, tp


def _acts(k, n, seed=1):
    return (np.random.default_rng(seed).standard_normal((k, n)) * 3).astype(np.float32)


# (M, K, N): K = 40 and 60 have one g=5 segment; 57 = 5*9 + 4*3 and
# 964 = 5*192 + 4 (smollm-360m's widths plus one g=4 group) have two
MPGEMM_SHAPES = [(24, 40, 9), (32, 60, 16), (17, 57, 5), (9, 964, 3)]


@pytest.mark.parametrize("impl", ["decode", "lookup"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", MPGEMM_SHAPES)
def test_vlut_mpgemm_unfused_matches_jax(impl, dtype, m, k, n):
    """The three-pass pipeline against JAX's (interpreted Pallas kernels):
    the same materialized quantizer over the full K, exact integers summed
    in int32 across segments, one dequant in f32, one cast: bit for bit."""
    jp, tp = _packed(m, k, seed=m + k)
    a = _acts(k, n)
    want = jvlut_mpgemm(jp, jnp.asarray(a).astype(dtype), impl=impl, interpret=True,
                        out_dtype=jnp.dtype(dtype), fusion="unfused")
    got = ops.vlut_mpgemm(tp, torch.from_numpy(a).to(getattr(torch, dtype)), impl=impl,
                          out_dtype=getattr(torch, dtype), fusion="unfused")
    assert got.dtype == getattr(torch, dtype) and got.shape == (m, n)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("impl", ["decode", "lookup"])
@pytest.mark.parametrize("m,k,n", MPGEMM_SHAPES)
def test_fused_vs_unfused_in_the_port(impl, m, k, n):
    """One segment: the two pipelines are the same operations in the same
    order, bit-identical. Two segments: the fused pipeline sums one f32
    partial per segment, the unfused one int32 before a single dequant, so
    they agree to f32 rounding (1e-6 of the output's magnitude)."""
    _, tp = _packed(m, k, seed=m + k)
    a = torch.from_numpy(_acts(k, n))
    fused = ops.vlut_mpgemm(tp, a, impl=impl)
    unfused = ops.vlut_mpgemm(tp, a, impl=impl, fusion="unfused")
    if tp.k4 and tp.k5:
        torch.testing.assert_close(unfused, fused, rtol=0, atol=1e-6 * fused.abs().max().item())
    else:
        assert torch.equal(unfused, fused)


@pytest.mark.parametrize("impl", ["decode", "lookup"])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("g,kg,n", [(5, 12, 7), (4, 9, 20)])
def test_segment_mpgemm_matches_jax(impl, fused, g, kg, n):
    """One homogeneous-g segment at unit weight scale, fused or not, bit for
    bit against JAX's `segment_mpgemm` (interpreted)."""
    rng = np.random.default_rng(g * kg + n)
    m = 19
    packed = jpack_ternary(jnp.asarray(rng.integers(-1, 2, (m, kg * g)).astype(np.int8)), g)
    a = _acts(kg * g, n, seed=n)
    want = np.asarray(jsegment_mpgemm(packed, jnp.asarray(a), g, impl, fused=fused, interpret=True))
    got = ops.segment_mpgemm(torch.tensor(np.asarray(packed)), torch.from_numpy(a), g, impl,
                             fused=fused)
    assert got.shape == (m, n) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_ternary_matmul_unfused_leading_dims(monkeypatch):
    """`ternary_matmul` with fusion "unfused" (explicit or from the dispatch
    knob) reads (..., K), returns (..., M), goes through the integer
    kernels only, and equals the (K, N) → (M, N) public form transposed;
    `dispatch_override` restores the old value, also on error."""
    calls = []
    for name, kern in INT_KERNELS.items():
        monkeypatch.setitem(ops._INT_KERNELS, name,
                            lambda *a, _k=kern, _n=name, **kw: calls.append(_n) or _k(*a, **kw))
    for name in ops._KERNELS:
        monkeypatch.setitem(ops._KERNELS, name, lambda *a, **kw: pytest.fail("fused kernel"))
    _, tp = _packed(20, 57)                                  # two segments
    x = torch.from_numpy(_acts(24, 57).T.copy()).reshape(2, 3, 4, 57)
    y = ops.ternary_matmul(tp, x, fusion="unfused")
    assert y.shape == (2, 3, 4, 20)
    want = ops.vlut_mpgemm(tp, x.reshape(24, 57).T, fusion="unfused").T.reshape(2, 3, 4, 20)
    assert torch.equal(y, want)
    base = ops.dispatch_config()
    assert base.fusion == "fused"
    with ops.dispatch_override(impl="lookup", fusion="unfused") as cfg:
        assert (cfg.impl, cfg.fusion) == ("lookup", "unfused")
        with ops.dispatch_override(fusion=None):             # None is ignored
            assert ops.dispatch_config().fusion == "unfused"
        assert torch.equal(ops.ternary_matmul(tp, x), y)
    assert (base.impl, base.fusion) == ("decode", "fused")
    with pytest.raises(RuntimeError):
        with ops.dispatch_override(fusion="unfused"):
            raise RuntimeError("boom")
    assert base.fusion == "fused"
    assert calls == ["decode", "decode"] * 2 + ["lookup", "lookup"]
    with pytest.raises(ValueError):
        ops.ternary_matmul(tp, x, fusion="staged")
    with pytest.raises(ValueError):
        ops.vlut_mpgemm(tp, x.reshape(24, 57).T, fusion="staged")
    with pytest.raises(NotImplementedError):
        ops.vlut_mpgemm(tp, x.reshape(24, 57).T, impl="xla", fusion="unfused")


def test_int_argument_checks():
    packed = torch.zeros((4, 8), dtype=torch.uint8)
    a_r = torch.zeros((5, 8, 3), dtype=torch.int8)
    for kern in INT_KERNELS.values():
        assert kern(packed, a_r, g=5).shape == (4, 3)
        bad = [
            (packed, a_r, 3),                                          # g
            (packed.to(torch.int8), a_r, 5),                           # packed dtype
            (packed[:, :4], a_r, 5),                                   # packed not contiguous
            (packed, a_r.to(torch.int16), 5),                          # a_r dtype
            (packed, torch.zeros((4, 8, 3), dtype=torch.int8), 5),     # a_r's g
            (packed, torch.zeros((5, 7, 3), dtype=torch.int8), 5),     # a_r's KG
            (packed, torch.zeros((5, 3, 8), dtype=torch.int8).transpose(1, 2), 5),
            (packed, a_r[0], 5),                                       # rank
            (packed, a_r.to("meta"), 5),                               # two devices
        ]
        for p, a, g in bad:
            with pytest.raises(ValueError):
                kern(p, a, g=g)


def test_launch_counters_untouched_on_cpu():
    before = [k.launches for k in ALL_KERNELS]
    _, tp = _packed(16, 57)
    for impl in INT_KERNELS:
        ops.ternary_matmul(tp, torch.ones((4, 57)), impl=impl, fusion="unfused")
        ops.segment_mpgemm(tp.packed5, torch.ones((45, 2)), 5, impl, fused=False)
    assert [k.launches for k in ALL_KERNELS] == before


def test_cuda_call_without_cuda_raises():
    """A tensor on any device but the CPU never takes the plain version:
    there is no CUDA here, so the wrappers raise."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    packed = torch.zeros((4, 8), dtype=torch.uint8, device="meta")
    a_r = torch.zeros((5, 8, 3), dtype=torch.int8, device="meta")
    for kern in INT_KERNELS.values():
        with pytest.raises(ValueError, match="CUDA"):
            kern(packed, a_r, g=5)


def test_engine_unfused_token_identical_to_jax():
    """Greedy serving of the smoke config with the unfused pipeline, both
    impls, against the JAX Engine running its unfused interpreted Pallas
    decode pipeline on the same (bridged) weights."""
    jcfg = jget_config("smollm-360m", smoke=True).with_(dtype="float32")
    tcfg = tget_config("smollm-360m", smoke=True).with_(dtype="float32")
    params = jm.pack_params(jm.init_lm(jax.random.PRNGKey(0), jcfg), jcfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab, size=n).astype(np.int32) for n in (5, 13, 20)]

    def run(pkg, engine):
        sched = pkg.ContinuousBatchingScheduler(engine)
        reqs = [pkg.Request(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
        sched.submit(reqs)
        assert sched.run_to_completion().completed == len(reqs)
        return [list(map(int, r.generated)) for r in reqs]

    want = run(js, js.Engine(params, jcfg, max_slots=2, max_len=32, mpgemm_impl="decode",
                             mpgemm_fusion="unfused", mpgemm_interpret=True))
    for impl in ("decode", "lookup"):
        model = bridge.lm_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
        eng = ts.Engine(model, tcfg, max_slots=2, max_len=32, mpgemm_impl=impl,
                        mpgemm_fusion="unfused", device="cpu")
        assert run(ts, eng) == want
    assert ops.dispatch_config().fusion == "fused"
