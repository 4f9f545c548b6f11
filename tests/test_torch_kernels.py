"""repro_torch.kernels against the JAX package's fused Pallas kernels (run
in interpret mode, as the JAX package's own CPU tests run them), plus the
dispatch and device contracts of the port's kernel wrappers."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import pack_weight as jpack_weight  # noqa: E402
from repro.core import ternary_quantize as jternary  # noqa: E402
from repro.kernels import vlut_mpgemm as jvlut_mpgemm  # noqa: E402
from repro_torch import resolve_device  # noqa: E402
from repro_torch.core import PackedWeight, act_token_scale  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import ternary_decode_gemm as tdg  # noqa: E402
from repro_torch.kernels import vlut_lookup_gemm as vlg  # noqa: E402

KERNELS = {
    "decode": (tdg.ternary_decode_gemm_fused, tdg.ternary_decode_gemm_fused_plain),
    "lookup": (vlg.vlut_lookup_gemm_fused, vlg.vlut_lookup_gemm_fused_plain),
}


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


# (M, K, N): K = 57 = 5*9 + 4*3 and 64 = 5*12 + 4 have both segments;
# K = 40 only a g=5 segment
SHAPES = [(24, 57, 5), (17, 64, 3), (9, 40, 1)]


@pytest.mark.parametrize("impl", ["decode", "lookup"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_plain_matches_jax_fused_interpret(impl, dtype, m, k, n):
    """The port's fused mpGeMM (plain versions on the CPU) against the JAX
    fused kernel of the same impl, interpreted: the same quantizer, an exact
    integer core, the same f32 epilogue, and a per-segment f32 sum before
    the one final cast. Expected bit-identical, except in f32 with two
    segments: interpreted under one jit, XLA fuses the kernel's epilogue
    into the segment sum as a fused multiply-add (one rounding fewer), so
    there the two agree to 1e-6 of the output's magnitude."""
    jp, tp = _packed(m, k, seed=m + k)
    a = _acts(k, n)
    want = jvlut_mpgemm(jp, jnp.asarray(a).astype(dtype), impl=impl, interpret=True,
                        out_dtype=jnp.dtype(dtype), fusion="fused")
    got = ops.vlut_mpgemm(tp, torch.from_numpy(a).to(getattr(torch, dtype)), impl=impl,
                          out_dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (m, n)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32" and tp.k4 and tp.k5:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())
    else:
        np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("g", [4, 5])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 7, 33])
def test_plain_lookup_equals_plain_decode(g, out_dtype, n):
    """The literal table gather and the trit decode are two computations of
    one function: bit-identical, including a per-tensor (1,) w_scale."""
    rng = np.random.default_rng(g * 100 + n)
    m, kg = 37, 29
    packed = torch.tensor(rng.integers(0, 3 ** g, (m, kg)).astype(np.uint8))
    x = torch.tensor(rng.standard_normal((n, kg * g + 3)).astype(np.float32))[:, 3:]
    a_scale = act_token_scale(x.T).contiguous()
    for w_scale in (torch.tensor(rng.random(m).astype(np.float32)), torch.tensor([0.37])):
        outs = [plain(packed, x, a_scale, w_scale, g=g, out_dtype=out_dtype)
                for _, plain in KERNELS.values()]
        assert outs[0].shape == (n, m) and outs[0].dtype == out_dtype
        assert torch.equal(outs[0], outs[1])


def test_ternary_matmul_layout_and_leading_dims():
    """ternary_matmul reads (..., K) token-major and returns (..., M); equal
    to the (K, N) → (M, N) public form transposed."""
    _, tp = _packed(20, 64)
    x = torch.tensor(np.random.default_rng(3).standard_normal((2, 3, 64)).astype(np.float32))
    y = ops.ternary_matmul(tp, x)
    assert y.shape == (2, 3, 20)
    ref = ops.vlut_mpgemm(tp, x.reshape(6, 64).T).T.reshape(2, 3, 20)
    assert torch.equal(y, ref)


def test_dispatch_semantics(monkeypatch):
    base = ops.dispatch_config()
    assert base.impl == "decode"
    calls = []
    for name, (kern, _) in KERNELS.items():
        monkeypatch.setitem(ops._KERNELS, name,
                            lambda *a, _k=kern, _n=name, **kw: calls.append(_n) or _k(*a, **kw))
    _, tp = _packed(8, 40)
    x = torch.ones((2, 40))
    with ops.dispatch_override(impl="lookup") as cfg:
        assert cfg.impl == "lookup"
        ops.ternary_matmul(tp, x)
        with ops.dispatch_override(impl=None):          # None is ignored
            assert ops.dispatch_config().impl == "lookup"
    assert base.impl == "decode"                         # restored
    ops.ternary_matmul(tp, x)
    ops.ternary_matmul(tp, x, impl="lookup")             # explicit impl wins
    assert calls == ["lookup", "decode", "lookup"]
    with pytest.raises(RuntimeError):
        with ops.dispatch_override(impl="lookup"):
            raise RuntimeError("boom")
    assert base.impl == "decode"                         # restored on error
    with pytest.raises(TypeError):
        ops.configure_dispatch(interpret=True)             # a TPU-only knob
    with pytest.raises(ValueError):
        ops.configure_dispatch(fusion="staged")
    with pytest.raises(NotImplementedError):
        ops.configure_dispatch(impl="xla")
    with pytest.raises(ValueError):
        ops.configure_dispatch(impl="onehot")
    assert ops.configure_dispatch(impl=None).impl == "decode"


def test_launch_counters_untouched_on_cpu():
    before = {n: k.launches for n, (k, _) in KERNELS.items()}
    _, tp = _packed(16, 57)
    for impl in KERNELS:
        ops.ternary_matmul(tp, torch.ones((4, 57)), impl=impl)
    assert {n: k.launches for n, (k, _) in KERNELS.items()} == before


def test_no_cpu_fallback_without_cuda():
    """Where there is no card, asking for CUDA raises; a tensor on any
    device but the CPU never takes the plain version; a missing nvcc makes
    the build raise."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    packed = torch.zeros((4, 8), dtype=torch.uint8, device="meta")
    x = torch.zeros((2, 40), device="meta")
    a_scale = torch.ones((2,), device="meta")
    w_scale = torch.ones((4,), device="meta")
    for kern, _ in KERNELS.values():
        with pytest.raises(ValueError, match="CUDA"):
            kern(packed, x, a_scale, w_scale, g=5)
    if _build.shutil.which("nvcc") is None and not _build.os.path.exists("/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.build()


def test_argument_checks():
    packed = torch.zeros((4, 8), dtype=torch.uint8)
    x = torch.zeros((2, 40))
    ok = dict(a_scale=torch.ones((2,)), w_scale=torch.ones((4,)))
    for kern, _ in KERNELS.values():
        with pytest.raises(ValueError):
            kern(packed, x, g=3, **ok)
        with pytest.raises(ValueError):
            kern(packed, torch.zeros((2, 41)), g=5, **ok)
        with pytest.raises(ValueError):
            kern(packed, x, a_scale=torch.ones((3,)), w_scale=ok["w_scale"], g=5)
        with pytest.raises(ValueError):
            kern(packed, x, g=5, out_dtype=torch.float16, **ok)
