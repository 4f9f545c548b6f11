"""The port's encoder-decoder (`repro_torch.models.encdec`, the
cross-attention of `models.attention` and `models.blocks`, the bridge, the
trainer's enc-dec path and `launch.steps`) against the JAX package on
whisper-medium's smoke config (2 encoder + 2 decoder layers, d 64: K 64
and K 128 each pack into a g=5 and a g=4 segment), in f32, on seeded numpy
inputs. The JAX params and the port's models are built once per module.

Tolerances (f32): `OUT_RTOL` bounds max |port - JAX| relative to the
output's largest entry (float sums in other orders, a few f32 ulp).
`LOSS_RTOL`, `GRAD_RTOL`: as tests/test_torch_train.py bounds the dense
model's QAT loss and each gradient leaf. The sinusoidal positions go
through exp, sin and cos, which XLA and torch each compute to within an
ulp or two but not to the same bits (XLA's jitted and eager forms differ
from each other as much); their f32 step log(10000) / d and the integer
positions are the same bits, the angles then agree to a few ulp and the
table to `POS_ULPS` ulp of its largest angle. `TRAIN_RTOL`: as
tests/test_torch_trainer.py holds the LM's losses after 3 steps. Greedy
tokens are identical."""
import functools
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.train import TrainConfig as JTrainConfig  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.common import PackedLinear  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.train import TrainConfig, Trainer  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402

ARCH = "whisper-medium"
OUT_RTOL = 1e-5
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-5
POS_ULPS = 4
TRAIN_RTOL = 1e-4
STEP1_SHARE = 2e-3
#: serving: batch, encoder frames, prompt tokens, decode steps, cache length
B, S_ENC, PROMPT, STEPS, MAX_LEN = 2, 16, 8, 6, 32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The smoke model's ops are tiny: one intra-op thread each avoids the
    oversubscription of parallel test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    return (jget_config(ARCH, smoke=True).with_(dtype="float32", **kw),
            tget_config(ARCH, smoke=True).with_(dtype="float32", **kw))


@pytest.fixture(scope="module")
def whisper():
    """(jcfg, tcfg, JAX params, unpacked port model, packed JAX params,
    packed port model), built once."""
    jcfg, tcfg = _cfgs()
    params = jm.encdec_init(jax.random.PRNGKey(0), jcfg)
    packed = jm.pack_params(params, jcfg)
    model = bridge.encdec_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    pmodel = bridge.encdec_from_jax(jax.tree.map(np.asarray, packed), tcfg, device="cpu")
    return jcfg, tcfg, params, model, packed, pmodel


def _inputs(seed, b=B, s_enc=S_ENC, s=PROMPT + STEPS, vocab=512, d=64):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((b, s_enc, d)).astype(np.float32)
    return frames, rng.integers(0, vocab, (b, s)).astype(np.int32)


def _close(got, want, rtol=OUT_RTOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# --------------------------------------------------------------------------
# Positions, cross-attention, encode
# --------------------------------------------------------------------------
@pytest.mark.parametrize("s,d", [(16, 64), (112, 1024), (1500, 1024)])
def test_sinusoid_positions_match_jax(s, d):
    """The f32 frequency step and positions bit for bit; the table within
    POS_ULPS f32 ulp of its largest angle (exp, sin and cos are each
    framework's own); its layout (sin half, cos half) and dtypes."""
    step = np.asarray(jnp.log(10000.0) / d)
    t_step = torch.log(torch.tensor(10000.0, dtype=torch.float32)) / d
    assert t_step.dtype == torch.float32 and t_step.item() == step.item()
    want = np.asarray(jencdec.sinusoid_positions(s, d))
    got = tm.sinusoid_positions(s, d)
    assert got.shape == (s, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=POS_ULPS * np.spacing(np.float32(max(s - 1, 1))))
    np.testing.assert_array_equal(got[0].numpy(), want[0])        # angle 0: sin 0, cos 1
    bf = tm.sinusoid_positions(s, d, torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    np.testing.assert_array_equal(bf.float().numpy(), got.to(torch.bfloat16).float().numpy())


def test_cross_attention_matches_jax(whisper):
    """cross_attn_kv and cross_attn_apply of layer 0 alone (QAT eval mode):
    every query attends every encoder position."""
    jcfg, tcfg, params, model, _, _ = whisper
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, 5, 64)).astype(np.float32)
    enc = rng.standard_normal((B, S_ENC, 64)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], params["decoder"]["stages"][0]["b0"]["cross"])

    @jax.jit
    def jfn(x, enc):
        k, v = jattn.cross_attn_kv(jp, enc, jcfg, "eval")
        return k, v, jattn.cross_attn_apply(jp, x, k, v, jcfg, "eval")

    jk, jv, jy = jfn(jnp.asarray(x), jnp.asarray(enc))
    cross = model.decoder.layers[0].cross
    with torch.no_grad():
        tk, tv = tattn.cross_attn_kv(cross, torch.from_numpy(enc), tcfg, "eval")
        ty = tattn.cross_attn_apply(cross, torch.from_numpy(x), tk, tv, tcfg, "eval")
    assert tk.shape == (B, S_ENC, tcfg.n_kv_heads, tcfg.head_dim)
    for got, want in ((tk, jk), (tv, jv), (ty, jy)):
        _close(got.numpy(), want)


@pytest.mark.parametrize("mode", ["eval", "serve"])
def test_encode_matches_jax(whisper, mode):
    """The bidirectional encoder over seeded frames: QAT linears (eval) and
    the packed kernels' plain versions against the interpreted Pallas
    kernel (serve)."""
    jcfg, tcfg, params, model, packed, pmodel = whisper
    frames, _ = _inputs(2)
    jp, tmod = (params, model) if mode == "eval" else (packed, pmodel)
    jencode = jax.jit(functools.partial(jm.encode, cfg=jcfg, mode=mode))
    with jops.dispatch_override(impl="decode", interpret=True):
        want = jencode(jp, jnp.asarray(frames))
    with torch.no_grad(), ops.dispatch_override(impl="decode"):
        got = tm.encode(tmod, torch.from_numpy(frames), tcfg, mode=mode)
    _close(got.numpy(), want)


# --------------------------------------------------------------------------
# Loss and gradients
# --------------------------------------------------------------------------
def test_encdec_loss_and_grads_match_jax(whisper):
    """encdec_loss with a loss mask through the QAT linears and per-layer
    remat (encoder and decoder), against jax.value_and_grad(encdec_loss);
    the gradient of every leaf compared in JAX's layout through
    `encdec_tree`, the encoder's included (it flows through enc_out)."""
    jcfg, tcfg, params, model, _, _ = whisper
    frames, tok = _inputs(3, s=20)
    lab = np.random.default_rng(4).integers(0, jcfg.vocab, tok.shape).astype(np.int32)
    mask = (np.random.default_rng(5).random(tok.shape) < 0.8).astype(np.float32)
    jloss = jax.jit(jax.value_and_grad(
        lambda p: jm.encdec_loss(p, jnp.asarray(frames), jnp.asarray(tok), jnp.asarray(lab),
                                 jcfg, loss_mask=jnp.asarray(mask)), has_aux=True))
    (jl, jmet), jg = jloss(params)
    model.requires_grad_(True)
    try:
        tl, tmet = tm.encdec_loss(model, torch.from_numpy(frames), torch.from_numpy(tok),
                                  torch.from_numpy(lab), tcfg, loss_mask=torch.from_numpy(mask))
        named = dict(model.named_parameters())
        grads = torch.autograd.grad(tl, list(named.values()))
    finally:
        model.requires_grad_(False)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=LOSS_RTOL)
    assert float(tmet["tokens"]) == float(jmet["tokens"]) == mask.sum()
    tg = bridge.encdec_tree(dict(zip(named, grads)), tcfg)
    jleaves = jax.tree_util.tree_flatten_with_path(jg)[0]
    tleaves = jax.tree.leaves(tg)
    assert len(jleaves) == len(tleaves)
    for (path, a), b in zip(jleaves, tleaves):
        a = np.asarray(a)
        assert a.shape == b.shape, jax.tree_util.keystr(path)
        err = np.abs(a - b).max() / np.abs(a).max()
        assert err < GRAD_RTOL, (jax.tree_util.keystr(path), err)


def test_remat_keeps_the_gradients(whisper):
    """Per-layer remat (enc_out an input of each checkpointed decoder
    layer) gives the gradients of the plain forward, the encoder's too."""
    _, tcfg, _, model, _, _ = whisper
    frames, tok = _inputs(6, s=12)
    args = (torch.from_numpy(frames), torch.from_numpy(tok), torch.from_numpy(tok))
    model.requires_grad_(True)
    try:
        named = dict(model.named_parameters())
        grads = [torch.autograd.grad(tm.encdec_loss(model, *args, tcfg.with_(remat=r))[0],
                                     list(named.values())) for r in (True, False)]
    finally:
        model.requires_grad_(False)
    for name, a, b in zip(named, *grads):
        assert torch.equal(a, b), name
    assert any(n.startswith("encoder.") and g.abs().max() > 0 for n, g in zip(named, grads[0]))


def test_stacked_shapes_are_the_jax_layout(whisper):
    """AdamW's per-leaf rules read these: the encoder's and the decoder's
    stage of 2 layers each, every layer leaf with its leading 2."""
    jcfg, tcfg, params, model, _, _ = whisper
    shapes = tm.stacked_shapes(model, tcfg)
    assert shapes["encoder.layers.1.mixer_norm.scale"] == (2, 64)
    assert shapes["decoder.layers.0.cross.wk.qw"] == (2, 64, 64)
    assert shapes["encoder.final_norm.scale"] == (64,)
    assert shapes["decoder.embed.table"] == (jcfg.vocab, 64)
    want = sorted(tuple(np.shape(x)) for x in jax.tree.leaves(params))
    per_leaf = {}
    for name, shape in shapes.items():
        top, rest = name.split(".", 1)
        key = (top, rest.split(".", 2)[-1] if rest.startswith("layers.") else rest)
        per_leaf[key] = shape
    assert sorted(per_leaf.values()) == want


# --------------------------------------------------------------------------
# The bridge
# --------------------------------------------------------------------------
def _leaves_equal(got, want, scale_rtol=0.0):
    """Recursive equality of two numpy pytrees (dicts, lists, packed
    weights: codes exactly, scales to `scale_rtol`)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _leaves_equal(got[k], want[k], scale_rtol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _leaves_equal(a, b, scale_rtol)
    elif hasattr(want, "packed5"):
        assert got.K == want.K
        for f in ("packed5", "packed4"):
            np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)))
        np.testing.assert_allclose(got.scale, np.asarray(want.scale), rtol=scale_rtol)
    else:
        want = np.asarray(want)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_bridge_round_trip(whisper, packed):
    """encdec_from_jax then encdec_to_jax gives back every leaf bit for bit,
    packed bytes included; the layers land in the stage scan's order."""
    jcfg, tcfg, params, model, pparams, pmodel = whisper
    jp, tmod = (pparams, pmodel) if packed else (params, model)
    _leaves_equal(bridge.encdec_to_jax(tmod, tcfg), jax.tree.map(np.asarray, jp))
    assert len(tmod.encoder.layers) == tcfg.enc_layers and len(tmod.decoder.layers) == tcfg.n_layers
    kinds = {type(m).__name__ for m in tmod.modules()}
    assert ("PackedLinear" in kinds) == packed and ("QLinear" in kinds) != packed
    np.testing.assert_array_equal(
        tmod.decoder.layers[1].cross_norm.scale.numpy(),
        np.asarray(jp["decoder"]["stages"][0]["b0"]["cross_norm"]["scale"])[1])


def test_pack_params_packs_every_linear(whisper):
    """`pack_params` on the port's EncDec packs the encoder's, the
    cross-attention's and the decoder's linears to JAX's codes (the
    per-channel scale to a few ulp: the absmean is summed in another
    order, as tests/test_torch_models.py holds it)."""
    jcfg, tcfg, params, model, pparams, _ = whisper
    import copy

    packed = tm.pack_params(copy.deepcopy(model), tcfg)
    assert not any(type(m).__name__ == "QLinear" for m in packed.modules())
    n = sum(isinstance(m, PackedLinear) for m in packed.modules())
    assert n == tcfg.enc_layers * 7 + tcfg.n_layers * 11
    _leaves_equal(bridge.encdec_to_jax(packed, tcfg), jax.tree.map(np.asarray, pparams),
                  scale_rtol=1e-6)


# --------------------------------------------------------------------------
# Packed serving: encode + prefill, decode steps, greedy steps
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def served(whisper):
    """JAX and the port served from the same packed weights: encode +
    prefill logits, STEPS decode steps' logits (teacher-forced tokens), and
    the greedy tokens of the step builders."""
    jcfg, tcfg, _, _, packed, pmodel = whisper
    frames, tok = _inputs(7)
    jframes = jnp.asarray(frames)
    jencode = jax.jit(functools.partial(jm.encode, cfg=jcfg, mode="serve"))
    with jops.dispatch_override(impl="decode", interpret=True):
        enc = jencode(packed, jframes)
        jpre = jax.jit(functools.partial(jm.prefill, cfg=jcfg))
        jdec = jax.jit(functools.partial(jm.decode_step, cfg=jcfg))
        jlog = [jpre(packed["decoder"], jnp.asarray(tok[:, :PROMPT]),
                     jm.init_cache(jcfg, B, MAX_LEN, enc_len=S_ENC), enc_out=enc)]
        for t in range(PROMPT, PROMPT + STEPS):
            jlog.append(jdec(packed["decoder"], jnp.asarray(tok[:, t:t + 1]), jlog[-1][1]))
        jstep_pre = jax.jit(jsteps.make_prefill_step(jcfg))
        jstep_dec = jax.jit(jsteps.make_decode_step(jcfg))
        nt, cache = jstep_pre(packed, jm.init_cache(jcfg, B, MAX_LEN, enc_len=S_ENC),
                              {"tokens": jnp.asarray(tok[:, :PROMPT]), "frames": jframes})
        jgreedy = [np.asarray(nt)]
        for _ in range(STEPS):
            nt, cache = jstep_dec(packed, cache, nt[:, None])
            jgreedy.append(np.asarray(nt))
    with torch.no_grad(), ops.dispatch_override(impl="decode"):
        tframes = torch.from_numpy(frames)
        tenc = tm.encode(pmodel, tframes, tcfg, mode="serve")
        tlog = [tm.prefill(pmodel.decoder, torch.from_numpy(tok[:, :PROMPT]),
                           tm.init_cache(tcfg, B, MAX_LEN, enc_len=S_ENC, device="cpu"), tcfg,
                           enc_out=tenc)]
        for t in range(PROMPT, PROMPT + STEPS):
            tlog.append(tm.decode_step(pmodel.decoder, torch.from_numpy(tok[:, t:t + 1]),
                                       tlog[-1][1], tcfg))
        pre = tsteps.make_prefill_step(tcfg, device="cpu")
        dec = tsteps.make_decode_step(tcfg, device="cpu")
        nt, cache = pre(pmodel, tm.init_cache(tcfg, B, MAX_LEN, enc_len=S_ENC, device="cpu"),
                        {"tokens": torch.from_numpy(tok[:, :PROMPT]), "frames": tframes})
        tgreedy = [nt.numpy()]
        for _ in range(STEPS):
            nt, cache = dec(pmodel, cache, nt[:, None])
            tgreedy.append(nt.numpy())
    return (jlog, jgreedy), (tlog, tgreedy, cache)


def test_prefill_and_decode_logits_match_jax(served):
    """encode + prefill logits, then each decode step's (reading the cross
    K/V the prefill cached), to OUT_RTOL."""
    (jlog, _), (tlog, _, _) = served
    assert len(tlog) == 1 + STEPS
    for (got, _), (want, _) in zip(tlog, jlog):
        _close(got.numpy(), want)


def test_greedy_steps_match_jax(served):
    """make_prefill_step + STEPS make_decode_step calls: identical tokens;
    the cache holds the encoder's cross K/V in bf16 and advanced idx."""
    (_, jgreedy), (_, tgreedy, cache) = served
    np.testing.assert_array_equal(np.stack(tgreedy), np.stack(jgreedy))
    assert all(t.dtype == np.int32 for t in tgreedy)
    layer = cache[0]
    assert layer["xk"].shape == (B, S_ENC, 4, 16) and layer["xk"].dtype == torch.bfloat16
    assert layer["idx"].tolist() == [PROMPT + STEPS] * B


def test_decode_after_prefill_matches_a_cache_free_forward(whisper):
    """The cached cross K/V reused by decode steps equal recomputing them:
    the last decode step's logits against `encode` + `lm_hidden` of the
    whole sequence with no cache (the packed plain path, bf16 cache)."""
    _, tcfg, _, _, _, pmodel = whisper
    frames, tok = _inputs(8)
    with torch.no_grad(), ops.dispatch_override(impl="decode"):
        enc = tm.encode(pmodel, torch.from_numpy(frames), tcfg, mode="serve")
        logits, cache = tm.prefill(pmodel.decoder, torch.from_numpy(tok[:, :PROMPT]),
                                   tm.init_cache(tcfg, B, MAX_LEN, torch.float32, S_ENC,
                                                 device="cpu"), tcfg, enc_out=enc)
        for t in range(PROMPT, PROMPT + STEPS):
            logits, cache = tm.decode_step(pmodel.decoder, torch.from_numpy(tok[:, t:t + 1]),
                                           cache, tcfg)
        h, _, _ = tm.lm_hidden(pmodel.decoder, torch.from_numpy(tok[:, :PROMPT + STEPS]), tcfg,
                               mode="serve", enc_out=enc)
        want = tm.lm_logits(pmodel.decoder, h[:, -1], tcfg)
    _close(logits.numpy(), want.numpy())


def test_serve_launcher_refuses_encdec():
    """`launch.serve` names the enc-dec serving path and exits 2 (argparse)."""
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
                          "--smoke", "--device", "cpu"], capture_output=True, text=True,
                         timeout=120, env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 2
    assert "repro_torch.launch.steps" in out.stderr and "encoder-decoder" in out.stderr


# --------------------------------------------------------------------------
# Training
# --------------------------------------------------------------------------
@pytest.mark.parametrize("b,s,seed", [(4, 32, 0), (2, 3, 5), (3, 448, 1)])
def test_stub_frames_bit_equal(b, s, seed):
    """The trainer's frames: JAX's numpy draw rounded f64 -> bf16 once,
    bit for bit; s < enc_frame_ratio still gives one frame."""
    cfg = tget_config(ARCH, smoke=True)
    got = ttrainer._stub_frames(cfg, b, s, seed)
    want = np.asarray(jtrainer._stub_frames(jget_config(ARCH, smoke=True), b, s, seed))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape == (b, max(s // 4, 1), 64)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))


def test_three_steps_match_the_jax_trainer(tmp_path):
    """The same weights (the JAX Trainer's init, carried by the bridge), the
    same synthetic batches and stub frames, f32 config and f32 optimizer
    state: after one step all but STEP1_SHARE of the model's elements agree
    to 1e-6 and none moves by a whole lr (Adam's first step divides each
    gradient by its own magnitude, so an element whose gradient is at the
    noise level of the sums' order takes an update of up to lr either way,
    see tests/test_torch_trainer.py; 1.25e-3 of this model's elements do),
    and the losses of 3 steps to TRAIN_RTOL.
    The checkpoint then resumes a second trainer on the same weights."""
    jcfg, tcfg = _cfgs()
    opt = dict(lr=3e-3, warmup_steps=2, total_steps=10, int8_state=False)
    data = dict(vocab=jcfg.vocab, seq_len=32, global_batch=4)
    jtr = JTrainer(jcfg, JAdamWConfig(**opt),
                   JTrainConfig(total_steps=1, log_every=1, checkpoint_dir=str(tmp_path / "j")),
                   JDataConfig(**data))
    model = bridge.encdec_from_jax(jax.tree.map(np.asarray, jtr.state["params"]), tcfg,
                                   device="cpu")
    tc = TrainConfig(total_steps=1, log_every=1, checkpoint_dir=str(tmp_path / "t"))
    ttr = Trainer(tcfg, AdamWConfig(**opt), tc, DataConfig(**data), device="cpu", model=model)
    jtr.run(), ttr.run()
    want = jax.tree.leaves(jax.tree.map(np.asarray, jtr.state["params"]))
    got = jax.tree.leaves(bridge.encdec_to_jax(ttr.model, tcfg))
    assert len(got) == len(want)
    diffs = np.concatenate([np.abs(a - b).ravel() for a, b in zip(got, want)])
    assert (diffs > 1e-6).mean() < STEP1_SHARE and diffs.max() < opt["lr"]
    jtr.tc.total_steps = ttr.tc.total_steps = 3
    jlog, tlog = jtr.run(), ttr.run()
    assert [r["step"] for r in tlog] == [r["step"] for r in jlog] == [1, 2, 3]
    np.testing.assert_allclose([r["loss"] for r in tlog], [r["loss"] for r in jlog],
                               rtol=TRAIN_RTOL)
    resumed = Trainer(tcfg, AdamWConfig(**opt), tc, DataConfig(**data), device="cpu")
    assert resumed.step == 3 and isinstance(resumed.model, tm.EncDec)
    for (n, p), (_, q) in zip(ttr.model.named_parameters(), resumed.model.named_parameters()):
        assert torch.equal(p, q), n
