"""The port's AdamW (int8 moments, schedule) and synthetic data pipeline
against the JAX package's, on inputs made by numpy from a seed."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import optim as jopt  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM, host_batch_slice  # noqa: E402


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------
def _opt_case(rng):
    shapes = {"w": (64, 96), "e": (80, 60), "norm": (60,), "b": (5000,)}
    params = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: (rng.standard_normal(s) * 0.1).astype(np.float32) for n, s in shapes.items()}
             for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("int8_state", [False, True], ids=["f32_state", "int8_state"])
@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_matches_jax(int8_state, steps):
    """Parameters and moments after 1 and 3 updates (gradient clipping and
    the warmup schedule active). f32 state: the same f32 arithmetic, 1e-6.
    int8 state: m is requantized every step; a value at a rounding boundary
    may move one int8 code, so m agrees to one code step (row absmax/127)
    and the parameters to that step's share of the update."""
    rng = np.random.default_rng(4)
    params, grads = _opt_case(rng)
    cfg = dict(lr=3e-3, warmup_steps=2, total_steps=10, int8_state=int8_state, grad_clip=1.0)
    jcfg, tcfg = jopt.AdamWConfig(**cfg), topt.AdamWConfig(**cfg)
    jp = {n: jnp.asarray(p) for n, p in params.items()}
    js = jopt.adamw_init(jp, jcfg)
    tp = {n: torch.tensor(p) for n, p in params.items()}
    ts = topt.adamw_init(tp, tcfg)
    for g in grads[:steps]:
        jp, js, jmet = jopt.adamw_update(jp, {n: jnp.asarray(x) for n, x in g.items()}, js, jcfg)
        out = topt.adamw_update(tp, {n: torch.tensor(x) for n, x in g.items()}, ts, tcfg)
        assert out[0] is tp and out[1] is ts          # updated in place
        tmet = out[2]
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tmet["lr"]), float(jmet["lr"]), rtol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == steps
    for n in params:
        jm_, tm_ = js["m"][n], ts["m"][n]
        quant = isinstance(tm_, topt.QTensor)
        assert quant == isinstance(jm_, jopt.QTensor) == (int8_state and params[n].size >= 4096)
        if quant:
            step = np.asarray(jm_.scale)[..., None]
            np.testing.assert_allclose(topt.dequantize_blockwise(tm_).numpy(),
                                       np.asarray(jopt.dequantize_blockwise(jm_)),
                                       rtol=0, atol=float(step.max()) * 1.001)
            assert ts["v"][n].dtype == torch.bfloat16
        else:
            np.testing.assert_allclose(tm_.numpy(), np.asarray(jm_), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(_np(ts["v"][n]), _np(js["v"][n]), rtol=1e-5, atol=1e-12)
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]), rtol=1e-6, atol=2e-6)


def test_quantize_blockwise_and_lr_schedule_match_jax():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((7, 300)) * rng.random((7, 1)) * 5).astype(np.float32)
    jqt, tqt = jopt.quantize_blockwise(jnp.asarray(x)), topt.quantize_blockwise(torch.tensor(x))
    np.testing.assert_array_equal(tqt.q.numpy(), np.asarray(jqt.q))
    np.testing.assert_array_equal(tqt.scale.numpy(), np.asarray(jqt.scale))
    assert tqt.shape == jqt.shape == (7, 300)
    cfg = dict(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(
            float(topt.lr_at(topt.AdamWConfig(**cfg), torch.tensor(step))),
            float(jopt.lr_at(jopt.AdamWConfig(**cfg), jnp.asarray(step))), rtol=1e-6)


# --------------------------------------------------------------------------
# Data
# --------------------------------------------------------------------------
def test_synthetic_batches_byte_equal_to_jax():
    cfg = dict(vocab=512, seq_len=33, global_batch=6, seed=7)
    for pi, pc in ((0, 1), (1, 2)):
        a = SyntheticLM(DataConfig(**cfg), process_index=pi, process_count=pc)
        b = JSyntheticLM(JDataConfig(**cfg), process_index=pi, process_count=pc)
        for _ in range(3):
            x, y = next(a), next(b)
            for k in ("tokens", "labels"):
                assert x[k].dtype == y[k].dtype and x[k].tobytes() == y[k].tobytes()
        assert a.state_dict() == b.state_dict()
    assert host_batch_slice(8, 1, 4) == slice(2, 4)
