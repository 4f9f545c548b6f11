"""The port's distribution layer in one process, held to JAX on the CPU:

  * the sharding rules (`repro_torch.dist.sharding`) against
    `repro.dist.sharding` for every leaf of every registered arch — dense
    and packed params, AdamW state with its int8 `QTensor` moments, the
    serving caches (GQA, windowed, MLA, SSM, enc-dec), the batches — and
    `act_spec` for every name, on shape-only meshes (JAX's side with
    tests/test_sharding.py's FakeMesh on `jax.eval_shape` trees). The port
    keeps one module per layer where JAX stacks a stage's layers: each JAX
    stage leaf stands for its layers, its spec with the stage axis
    (replicated) dropped;
  * the dry run's per-device bytes of every applicable (arch × shape) cell
    on both production meshes, against the same bytes from JAX's specs on
    JAX's abstract trees; `count_params` and `model_flops` against JAX's;
  * `to_placements`, `shard_act` (the identity outside a context or on a
    plain tensor) and `dispatch_blocks` (1 there);
  * the "xla" mpGeMM impl, int32 bit-exact to JAX's `_xla_streamed_decode`
    (K-groups <= 512 and the chunked scan above), `ternary_matmul` against
    JAX's, and greedy serving with it against the JAX `Engine`, where
    "xla" is JAX's default on the CPU;
  * remat_policy="dots": `lm_loss` gradients equal "full" and no remat, and
    JAX's "dots".
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import cell_is_applicable as jcell_is_applicable  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.dist import sharding as jsh  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import encdec_init as jencdec_init  # noqa: E402
from repro.models import init_cache as jinit_cache  # noqa: E402
from repro.models import init_lm as jinit_lm  # noqa: E402
from repro.models import pack_params as jpack_params  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro.roofline import analysis as janalysis  # noqa: E402
from repro_torch.configs import SHAPES, cell_is_applicable, get_config  # noqa: E402
from repro_torch.dist import sharding as sh  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.dryrun import cell_bytes, run_cell  # noqa: E402
from repro_torch.launch.mesh import ShapeMesh, axis_size, batch_axes, mesh_axes  # noqa: E402
from repro_torch.models import compress_layout, encoder_specs  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.roofline import count_params, model_flops  # noqa: E402

ARCHS = list_archs()


class FakeMesh:
    """Shape-only stand-in of a JAX mesh (tests/test_sharding.py's)."""

    def __init__(self, **axes):
        self.axis_names = tuple(axes)
        self.shape = dict(axes)


MESHES = {
    "4x2": dict(data=4, model=2),
    "2x2x2": dict(pod=2, data=2, model=2),
    "16x16": dict(data=16, model=16),
    "2x16x16": dict(pod=2, data=16, model=16),
}
PRODUCTION = ("16x16", "2x16x16")


# --------------------------------------------------------------------------
# trees, built once per arch
# --------------------------------------------------------------------------
_JAX, _PORT = {}, {}


def _jinit(cfg):
    rng = jax.random.PRNGKey(0)
    if cfg.family == "encdec":
        return lambda: jencdec_init(rng, cfg)
    return lambda: jinit_lm(rng, cfg)


def _cache_dims(cfg, shape):
    enc = shape.seq_len // cfg.enc_frame_ratio if cfg.family == "encdec" else 0
    return shape.global_batch, shape.seq_len, enc


def jax_trees(arch):
    if arch not in _JAX:
        cfg = jget_config(arch)
        params = jax.eval_shape(_jinit(cfg))
        init = _jinit(cfg)
        trees = {
            "params": params,
            "opt": jax.eval_shape(lambda p: jadamw_init(p, JAdamWConfig()), params),
            "packed": jax.eval_shape(lambda: jpack_params(init(), cfg)),
        }
        for name, shape in JSHAPES.items():
            if shape.kind != "train" and jcell_is_applicable(arch, name):
                b, s, enc = _cache_dims(cfg, shape)
                c = cfg.with_(max_cache_len=s)
                trees[name] = jax.eval_shape(
                    lambda c=c, b=b, s=s, enc=enc: jinit_cache(c, b, s, dtype=jnp.bfloat16,
                                                                enc_len=enc))
        _JAX[arch] = trees
    return _JAX[arch]


def port_trees(arch):
    if arch not in _PORT:
        cfg = get_config(arch)
        mesh = ShapeMesh(**MESHES["4x2"])
        state, _ = steps.abstract_train_state(cfg, AdamWConfig(), mesh)
        packed, _ = steps.abstract_serve_params(cfg, mesh)
        trees = {"params": state["params"], "opt": state["opt"], "packed": packed}
        for name, shape in SHAPES.items():
            if shape.kind != "train" and cell_is_applicable(arch, name):
                b, s, enc = _cache_dims(cfg, shape)
                trees[name], _ = steps.abstract_cache(cfg.with_(max_cache_len=s), mesh, b, s, enc)
        _PORT[arch] = trees
    return _PORT[arch]


def _layer_map(cfg):
    """{(stage prefix, stage, pattern position): [layer index per repeat]}
    for the decoder (prefix "") and an enc-dec model's encoder."""
    stacks = {"": cfg.layer_specs()}
    if cfg.family == "encdec":
        stacks = {"encoder": encoder_specs(cfg), "decoder": cfg.layer_specs()}
    out = {}
    for prefix, specs in stacks.items():
        layer = 0
        for si, (pattern, reps) in enumerate(compress_layout(specs)):
            for pos in range(len(pattern)):
                out[(prefix, si, pos)] = [layer + r * len(pattern) + pos for r in range(reps)]
            layer += reps * len(pattern)
    return out


def jax_specs(tree, rule, jmesh, cfg, *, cache=False):
    """{port-style names: (JAX spec without stage axes, per-layer shape)}:
    every JAX leaf, a stage leaf expanded to its layers (its stage axis
    replicated, which the test asserts)."""
    layers = _layer_map(cfg)
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = [jsh._key_name(e) for e in path]
        spec = tuple(rule(path, leaf, jmesh, cfg))
        shape = tuple(leaf.shape)
        if cache:                                   # [si]/b{pos}/key, one list per stage
            si, pos = int(names[0][1:-1]), int(names[1][1:])
            assert spec[0] is None, names
            for li in layers[("decoder" if cfg.family == "encdec" else "", si, pos)]:
                out[(f"[{li}]", *names[2:])] = (spec[1:], shape[1:])
        elif "stages" in names:
            i = names.index("stages")
            head = names[:i]
            prefix = head[-1] if head and head[-1] in ("encoder", "decoder") else ""
            si, pos = int(names[i + 1][1:-1]), int(names[i + 2][1:])
            assert spec[0] is None, names
            for li in layers[(prefix, si, pos)]:
                out[(*head, "layers", str(li), *names[i + 3:])] = (spec[1:], shape[1:])
        else:
            out[tuple(names)] = (spec, shape)
    return out


def port_specs(tree, rule, mesh, cfg):
    return {names: (rule(names, leaf.shape, mesh, cfg), tuple(leaf.shape))
            for names, leaf in sh.leaves_with_names(tree)}


# --------------------------------------------------------------------------
# spec parity
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_parity_with_jax(arch):
    """param_spec (dense and packed), opt_spec, cache_spec and batch_spec
    equal JAX's for every leaf, on all four meshes."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    jt, pt = jax_trees(arch), port_trees(arch)
    parts = [("params", jsh.param_spec, sh.param_spec, False),
             ("packed", jsh.param_spec, sh.param_spec, False),
             ("opt", jsh.opt_spec, sh.opt_spec, False)]
    parts += [(name, jsh.cache_spec, sh.cache_spec, True) for name in pt
              if name in SHAPES]
    assert {n for n, *_ in parts} >= {"params", "packed", "opt"}
    for mesh_name, axes in MESHES.items():
        jmesh, mesh = FakeMesh(**axes), ShapeMesh(**axes)
        for part, jrule, rule, cache in parts:
            want = jax_specs(jt[part], jrule, jmesh, jcfg, cache=cache)
            got = port_specs(pt[part], rule, mesh, cfg)
            assert got == want, (mesh_name, part)
        for name, shape in SHAPES.items():
            batch, _ = steps.input_specs(cfg, shape, mesh)
            for key, leaf in batch.items():
                assert (sh.batch_spec([key], leaf.shape, mesh, cfg)
                        == tuple(jsh.batch_spec(None, leaf, jmesh, jcfg))), (mesh_name, name, key)


def test_spec_parity_covers_every_cache_kind():
    """The archs above hold every cache layout the rules know: GQA k/v
    (windowed too), MLA latents, SSM state and conv, enc-dec cross K/V."""
    terms = set()
    for arch in ("gemma3-1b", "deepseek-v3-671b", "jamba-1.5-large-398b", "whisper-medium"):
        for names, _ in sh.leaves_with_names(port_trees(arch)["decode_32k"]):
            terms.add(names[-1])
    assert {"k", "v", "slot_pos", "idx", "ckv", "krope", "state", "conv", "xk", "xv"} <= terms
    q_leaves = [n for n, _ in sh.leaves_with_names(port_trees("smollm-360m")["opt"])
                if n[-1] in ("q", "scale")]
    assert q_leaves                                  # QTensor moments are in the opt tree


ACT_NAMES = ("tokens", "btd", "btv", "kv_cache", "ssm_state", "moe_buf", "moe_buf_blocked",
             "unknown")
ACT_SHAPES = [(8, 16), (1, 64), (8, 16, 64), (1, 64, 64), (1, 1, 64), (8, 4, 512),
              (8, 64, 8, 32), (1, 64, 2, 32), (16, 96, 64), (2, 16, 24, 64)]


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_act_spec_parity(mesh_name):
    jmesh, mesh = FakeMesh(**MESHES[mesh_name]), ShapeMesh(**MESHES[mesh_name])
    cfg, jcfg = get_config("smollm-360m"), jget_config("smollm-360m")
    for name in ACT_NAMES:
        for shape in ACT_SHAPES:
            want = jsh.act_spec(name, shape, jmesh, jcfg)
            got = sh.act_spec(name, shape, mesh, cfg)
            assert got == (None if want is None else tuple(want)), (name, shape)


def test_mesh_helpers():
    m = ShapeMesh(pod=2, data=16, model=16)
    assert mesh_axes(m) == {"pod": 2, "data": 16, "model": 16} and m.size() == 512
    assert batch_axes(m) == ("pod", "data") and axis_size(m, ("pod", "data")) == 32
    assert axis_size(m, "expert") == 1
    # a JAX-style mesh (shape by name) reads the same
    assert mesh_axes(FakeMesh(data=4, model=2)) == {"data": 4, "model": 2}


def test_to_placements_and_local_shape():
    from torch.distributed.tensor import Replicate, Shard

    m = ShapeMesh(pod=2, data=4, model=2)
    spec = (("pod", "data"), "model", None)
    assert sh.to_placements(spec, m) == (Shard(0), Shard(0), Shard(1))
    assert sh.to_placements((None, None), m) == (Replicate(),) * 3
    assert sh.local_shape(spec, (16, 6, 5), m) == (2, 3, 5)
    with pytest.raises(ValueError):
        sh.to_placements((("data", "pod"),), m)          # minor before major
    with pytest.raises(ValueError):
        sh.local_shape(("model",), (5,), m)


def test_shard_act_and_dispatch_blocks_outside_a_context():
    x = torch.randn(4, 8, 16)
    assert sh.shard_act(x, "btd") is x
    assert sh.dispatch_blocks(32) == 1
    cfg = get_config("llama4-scout-17b-a16e", smoke=True).with_(moe_block_dispatch=True)
    with sh.use_sharding_ctx(ShapeMesh(data=4, model=2), cfg):
        assert sh.shard_act(x, "btd") is x               # a plain tensor: no constraint
        assert sh.dispatch_blocks(32) == 4 and sh.dispatch_blocks(30) == 1
        with sh.use_sharding_ctx(ShapeMesh(data=4, model=2), cfg.with_(moe_block_dispatch=False)):
            assert sh.dispatch_blocks(32) == 1           # re-entrant, innermost wins
        assert sh.dispatch_blocks(32) == 4
    assert sh.current_ctx() is None


# --------------------------------------------------------------------------
# the dry run's figures
# --------------------------------------------------------------------------
def _jax_bytes(tree, rule, jmesh, cfg) -> int:
    total = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        spec = tuple(rule(path, leaf, jmesh, cfg))
        n = 1
        for d, size in enumerate(leaf.shape):
            k = 1
            entry = spec[d] if d < len(spec) else None
            for a in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
                k *= jmesh.shape[a]
            assert size % k == 0
            n *= size // k
        total += n * jnp.dtype(leaf.dtype).itemsize
    return total


def _jax_inputs(cfg, shape):
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": jax.ShapeDtypeStruct((b, 1), jnp.int32)}
    batch = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}
    if shape.kind == "train":
        batch["labels"] = jax.ShapeDtypeStruct((b, s), jnp.int32)
    if cfg.family == "encdec":
        batch["frames"] = jax.ShapeDtypeStruct((b, s // cfg.enc_frame_ratio, cfg.d_model),
                                               jnp.bfloat16)
    return batch


@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_bytes_match_jax(arch):
    """Bytes on one device of params, optimizer state, cache and inputs of
    every applicable cell on both production meshes, from the port's
    abstract state, equal those from JAX's specs on JAX's abstract trees
    (JAX's `_per_device_bytes` over local shard shapes)."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    jt = jax_trees(arch)
    for mesh_name in PRODUCTION:
        jmesh, mesh = FakeMesh(**MESHES[mesh_name]), ShapeMesh(**MESHES[mesh_name])
        for name, shape in SHAPES.items():
            if not cell_is_applicable(arch, name):
                continue
            got = cell_bytes(cfg.with_(max_cache_len=shape.seq_len), shape, mesh)
            want = {"inputs": _jax_bytes(_jax_inputs(jcfg, shape), jsh.batch_spec, jmesh, jcfg)}
            if shape.kind == "train":
                want["params"] = _jax_bytes(jt["params"], jsh.param_spec, jmesh, jcfg)
                want["opt"] = _jax_bytes(jt["opt"], jsh.opt_spec, jmesh, jcfg)
            else:
                want["params"] = _jax_bytes(jt["packed"], jsh.param_spec, jmesh, jcfg)
                want["cache"] = _jax_bytes(jt[name], jsh.cache_spec, jmesh, jcfg)
            assert got == want, (mesh_name, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_and_model_flops_match_jax(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    got, want = count_params(cfg), janalysis.count_params(jcfg)
    assert got == want
    for name in SHAPES:
        assert model_flops(cfg, SHAPES[name], *got) == janalysis.model_flops(
            jcfg, JSHAPES[name], *want)


def test_dryrun_cells_and_cli(tmp_path, capsys, monkeypatch):
    """The registry of cells equals JAX's; a cell's record carries the
    bytes and roofline, the trace's memory analysis and collective term,
    nulls where JAX reads a compiler's output; the CLI appends one JSON
    line a cell (the traces saved under the working directory's
    results/graphs/): a full-width training cell, its step traced forward,
    backward and AdamW on the small mesh (~100 s)."""
    import json

    from repro_torch.launch import dryrun

    monkeypatch.chdir(tmp_path)
    assert list(SHAPES) == list(JSHAPES)
    for arch in ARCHS:
        for name in SHAPES:
            assert cell_is_applicable(arch, name) == jcell_is_applicable(arch, name)
    rec = run_cell("deepseek-v3-671b", "long_500k", verbose=False)
    assert rec["status"] == "skipped"
    rec = run_cell("mamba2-1.3b", "long_500k", multi_pod=True, verbose=False)
    assert rec["status"] == "ok" and rec["chips"] == 512
    assert rec["memory_analysis"]["temp_size_in_bytes"] > 0
    assert rec["memory_analysis"]["argument_size_in_bytes"] > 0
    assert isinstance(rec["roofline"]["collective_s"], float)
    assert rec["compile_s"] is None and rec["xla_cost_analysis"] is None and rec["lower_s"] > 0
    assert rec["state_bytes_per_device"] == rec["bytes_per_device"]["params"] + \
        rec["bytes_per_device"]["cache"]
    out = tmp_path / "d.jsonl"
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "smollm-360m", "--shape", "train_4k", "--small-mesh",
                     "--out", str(out)])
    assert e.value.code == 0
    (line,) = out.read_text().splitlines()
    row = json.loads(line)
    assert row["mesh"] == "small" and row["status"] == "ok" and row["chips"] == 8
    assert row["memory_analysis"]["temp_size_in_bytes"] > 0
    assert isinstance(row["roofline"]["collective_s"], float) and row["lower_s"] > 0
    assert row["state_bytes_per_device"] == row["bytes_per_device"]["params"] + \
        row["bytes_per_device"]["opt"]
    assert "[OK] smollm-360m" in capsys.readouterr().out


# --------------------------------------------------------------------------
# the "xla" impl
# --------------------------------------------------------------------------
def _codes(rng, m, kg, g):
    return rng.integers(0, 3 ** g, (m, kg)).astype(np.uint8)


@pytest.mark.parametrize("kg", [7, 512, 513, 1200])
@pytest.mark.parametrize("g", [4, 5])
def test_xla_streamed_decode_bit_exact(kg, g):
    """int32 equal to JAX's, one product (KG <= 512) or the chunked scan."""
    from repro_torch.kernels.ops import _xla_streamed_decode

    rng = np.random.default_rng(kg * 10 + g)
    packed = _codes(rng, 24, kg, g)
    a = rng.integers(-127, 128, (kg * g, 5)).astype(np.int8)
    want = np.asarray(jops._xla_streamed_decode(jnp.asarray(packed), jnp.asarray(a), g))
    got = _xla_streamed_decode(torch.from_numpy(packed), torch.from_numpy(a), g)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [57, 2560 + 4 * 3])
def test_ternary_matmul_xla_matches_jax(k):
    """`ternary_matmul(impl="xla")` (the unfused pipeline around the
    streamed decode) equals JAX's jitted one, and the port's unfused
    "decode" pipeline bit for bit (the same integer sums)."""
    from repro.core import pack_weight as jpack_weight
    from repro.core import ternary_quantize as jternary_quantize
    from repro_torch.core import PackedWeight
    from repro_torch.kernels import ops

    rng = np.random.default_rng(k)
    w = rng.standard_normal((40, k)).astype(np.float32)
    x = rng.standard_normal((3, 7, k)).astype(np.float32)
    jtw = jternary_quantize(jnp.asarray(w))
    jpw = jpack_weight(jtw.values, jtw.scale)
    pw = PackedWeight(*(torch.from_numpy(np.array(getattr(jpw, f)))
                        for f in ("packed5", "packed4", "scale")), K=jpw.K)
    xla_matmul = jax.jit(lambda p, a: jops.ternary_matmul(p, a, impl="xla"))
    want = np.asarray(xla_matmul(jpw, jnp.asarray(x)))
    got = ops.ternary_matmul(pw, torch.from_numpy(x), impl="xla")
    np.testing.assert_array_equal(got.numpy(), want)
    unfused = ops.ternary_matmul(pw, torch.from_numpy(x), impl="decode", fusion="unfused")
    assert torch.equal(got, unfused)
    assert ops.launch_tiles(pw, 21, "xla") == []


def test_engine_xla_matches_jax_engine():
    """Greedy serving of the smoke model with impl="xla" gives the JAX
    Engine's tokens and counters (JAX's default impl on the CPU)."""
    from repro import serve as js
    from repro_torch import bridge
    from repro_torch import serve as ts

    jcfg = jget_config("smollm-360m", smoke=True).with_(dtype="float32")
    cfg = get_config("smollm-360m", smoke=True).with_(dtype="float32")
    jparams = jpack_params(jinit_lm(jax.random.PRNGKey(3), jcfg), jcfg)
    model = bridge.lm_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (5, 11, 3)]

    def run(pkg, engine):
        sched = pkg.ContinuousBatchingScheduler(engine)
        reqs = [pkg.Request(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
        sched.submit(reqs)
        return reqs, sched.run_to_completion()

    with jops.dispatch_override(impl="xla"):
        jreqs, jstats = run(js, js.Engine(jparams, jcfg, max_slots=2, max_len=48))
    treqs, tstats = run(ts, ts.Engine(model, cfg, max_slots=2, max_len=48, device="cpu",
                                      mpgemm_impl="xla"))
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert all(len(r.generated) == 6 for r in treqs)
    for field in ("prefill_tokens", "decode_tokens", "decode_steps", "completed"):
        assert getattr(tstats, field) == getattr(jstats, field), field


# --------------------------------------------------------------------------
# remat_policy="dots"
# --------------------------------------------------------------------------
def test_dots_remat_gradients():
    """"dots" saves the linears' products and recomputes the rest: the
    gradients equal "full" and no remat exactly (the same ops, recomputed),
    and JAX's "dots" to f32 summation order."""
    from repro_torch import bridge
    from repro_torch.models import lm_loss
    from repro.models import lm_loss as jlm_loss

    over = dict(dtype="float32", loss_chunk=64)
    jcfg = jget_config("smollm-360m", smoke=True).with_(**over)
    cfg = get_config("smollm-360m", smoke=True).with_(**over)
    jparams = jinit_lm(jax.random.PRNGKey(1), jcfg)
    rng = np.random.default_rng(2)
    tok = rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    grads = {}
    for name, c in (("dots", cfg.with_(remat_policy="dots")), ("full", cfg),
                    ("none", cfg.with_(remat=False))):
        model = bridge.lm_from_jax(jax.tree.map(np.asarray, jparams), c,
                                   device="cpu").requires_grad_(True)
        loss, _ = lm_loss(model, torch.from_numpy(tok), torch.from_numpy(lab), c)
        loss.backward()
        grads[name] = {n: p.grad for n, p in model.named_parameters()}
    for n in grads["dots"]:
        assert torch.equal(grads["dots"][n], grads["full"][n]), n
        assert torch.equal(grads["dots"][n], grads["none"][n]), n
    jcfg_dots = jcfg.with_(remat_policy="dots")
    grad_fn = jax.jit(jax.grad(lambda p: jlm_loss(p, jnp.asarray(tok), jnp.asarray(lab),
                                                  jcfg_dots, mode="train")[0]))
    jg = grad_fn(jparams)
    want = jax.tree.leaves(jax.tree.map(np.asarray, jg))
    got = jax.tree.leaves(bridge.to_jax_tree(grads["dots"], cfg))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6 * np.abs(b).max())


def test_unknown_remat_policy_raises():
    from repro_torch.models import init_lm, lm_loss

    cfg = get_config("smollm-360m", smoke=True).with_(remat_policy="offload")
    model = init_lm(cfg, torch.Generator()).requires_grad_(True)
    z = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="remat_policy"):
        lm_loss(model, z, z, cfg)
