"""The port's sharded training on 4 gloo ranks (CPU), a (2, 2) ("data",
"model") mesh, held to JAX's unsharded training and to the port's own
unsharded paths. One spawn runs every check (`_torch_dist_worker`); the
JAX references are computed here.

  * `Trainer(mesh=...)`: 3 QAT steps from the bridged weights of JAX's
    trainer, the losses within 1e-4 of the JAX `Trainer`'s (whose step is
    `repro.train.trainer.make_train_step`) and the parameters after step 1
    within the unsharded trainer test's bounds; every ``qw`` leaf a DTensor
    with its rules' non-Replicate placements; the residual stream placed
    as ``act_spec("btd")`` says;
  * the flash path (local_map over (batch, heads) blocks) and gradient
    compression under the mesh against the port's unsharded runs;
  * MoE block-local dispatch under the mesh against ``moe_apply(n_blocks=2)``;
  * `compressed_psum` against JAX's blockwise quantizer summed over ranks;
  * elastic restore: the (2, 2) checkpoint onto a (4, 1) mesh and onto no
    mesh;
  * B = 1 prefill writes into caches sharded over their sequence
    (`dist.sharding.write_rows`), bit for bit the unsharded writes;
  * planted faults, one call each (a rule that replicates qw; shard_act
    dropped at the "btd" site), read as faults by the checks above.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_dist_worker as worker  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim import dequantize_blockwise as jdeq  # noqa: E402
from repro.optim import quantize_blockwise as jq  # noqa: E402
from repro.train import TrainConfig as JTrainConfig  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.dist.sharding import act_spec, param_spec, to_placements  # noqa: E402
from repro_torch.launch.mesh import ShapeMesh  # noqa: E402

#: the unsharded trainer test's config (tests/test_torch_trainer.py), so its
#: bounds apply as they stand
SMOKE = dict(dtype="float32", loss_chunk=64)
#: a smoke dense config whose heads (4 query, 2 KV) divide over "model":
#: the flash check's, where each rank attends its own heads
HEADS = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, dtype="float32",
             loss_chunk=64)
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=10, int8_state=False)
LOSS_RTOL = 1e-4          # ROADMAP C 1: QAT losses after Adam's first steps
MESH22 = ShapeMesh(data=2, model=2)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX references, then one spawn of the 4 ranks."""
    work = tmp_path_factory.mktemp("dist")
    jcfg = jget_config("smollm-360m", smoke=True).with_(**SMOKE)
    tcfg = get_config("smollm-360m", smoke=True).with_(**SMOKE)
    data = dict(vocab=jcfg.vocab, seq_len=32, global_batch=4)
    jtr = JTrainer(jcfg, JAdamWConfig(**OPT),
                   JTrainConfig(total_steps=1, log_every=1, checkpoint_dir=str(work / "jax")),
                   JDataConfig(**data))
    params0 = jax.tree.map(np.asarray, jtr.state["params"])
    jtr.run()
    params1 = jax.tree.map(np.asarray, jtr.state["params"])
    jtr.tc.total_steps = 3
    log = jtr.run()
    rng = np.random.default_rng(9)
    inputs = {
        "cfg": tcfg, "params": params0, "opt": OPT, "data": data,
        "heads_cfg": get_config("smollm-360m", smoke=True).with_(**HEADS),
        "tokens": rng.integers(0, tcfg.vocab, (4, 16)).astype(np.int32),
        "labels": rng.integers(0, tcfg.vocab, (4, 16)).astype(np.int32),
        "moe_cfg": get_config("llama4-scout-17b-a16e", smoke=True).with_(
            dtype="float32", moe_block_dispatch=True),
    }
    torch.save(inputs, work / "inputs.pt")
    ranks = worker.run_ranks(work)
    return {"ranks": ranks, "jax_losses": [r["loss"] for r in log], "jax_params1": params1,
            "cfg": tcfg}


def test_sharded_trainer_losses_match_jax(run):
    for res in run["ranks"]:
        assert len(res["losses"]) == 3
        np.testing.assert_allclose(res["losses"], run["jax_losses"], rtol=LOSS_RTOL)


def test_sharded_trainer_params_after_one_step(run):
    """The unsharded trainer test's bound (tests/test_torch_trainer.py):
    all but a few elements within 1e-6, none off by lr."""
    want = jax.tree.leaves(run["jax_params1"])
    got = jax.tree.leaves(run["ranks"][0]["params1"])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        diff = np.abs(np.asarray(a) - np.asarray(b))
        assert (diff > 1e-6).mean() < 1e-3 and diff.max() < OPT["lr"]


def test_qw_leaves_are_sharded(run):
    """Every qw weight is a DTensor with the rules' placements, sharded on
    both mesh dims, each rank holding a quarter of it."""
    from torch.distributed.tensor import Replicate

    cfg = run["cfg"]
    for res in run["ranks"]:
        assert res["qw_sharded"]
        pl = res["qw_placements"]
        assert len(pl) == 7 * cfg.n_layers
        for name, (placements, local) in pl.items():
            assert Replicate() not in placements, name
            assert np.prod(local) * 4 == np.prod(_qw_shape(name, cfg)), name


def _qw_shape(name, cfg):
    owner = name.split(".")[-2]
    d, q, kv, f = cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim, cfg.d_ff
    return {"wq": (d, q), "wk": (d, kv), "wv": (d, kv), "wo": (q, d),
            "w1": (d, f), "w3": (d, f), "w2": (f, d)}[owner]


def test_residual_stream_follows_btd(run):
    cfg = run["cfg"]
    want = to_placements(act_spec("btd", (4, 16, cfg.d_model), MESH22, cfg), MESH22)
    for res in run["ranks"]:
        assert res["residual"] == want


def test_planted_faults_are_caught(run):
    """A rule replicating qw fails the placement check; shard_act dropped
    at the "btd" site leaves the residual stream off its placements (or
    breaks the forward)."""
    cfg = run["cfg"]
    want = to_placements(act_spec("btd", (4, 16, cfg.d_model), MESH22, cfg), MESH22)
    for res in run["ranks"]:
        assert res["fault_rule_qw_sharded"] is False
        assert res["fault_btd_residual"] != want


def test_flash_under_the_mesh_matches_unsharded(run):
    for res in run["ranks"]:
        got, want = res["flash_loss"]
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert res["flash_grad_rel"] < 1e-5


def test_grad_compression_under_the_mesh(run):
    """The same two steps with int8 + error-feedback compression, sharded
    and not: the compressed gradients differ only by the reductions'
    order, so the losses agree to the QAT bound."""
    for res in run["ranks"]:
        assert len(res["compress_mesh"]) == 2
        np.testing.assert_allclose(res["compress_mesh"], res["compress_plain"], rtol=LOSS_RTOL)


def test_moe_block_dispatch_matches_unsharded(run):
    """f32; the sharded layer's sums run in another order (the expert
    products over sharded K, the aux means over shards). The router's
    gradient (largest entry ~2e-3) is a sum over tokens of terms some 1e3
    times larger: f32 rounding alone puts the unsharded layer's 2.2e-6 from
    its f64 value, hence the absolute bound of 1e-5 on the gradients."""
    for res in run["ranks"]:
        assert res["moe_nb"] == 2
        got, want = res["moe_out"]
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        got, want = res["moe_aux"]
        np.testing.assert_allclose(got, want, rtol=1e-6)
        got, want = res["moe_xgrad"]
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        for name, (got, want) in res["moe_grads"].items():
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5, msg=name)
        # the experts' stacks are expert-parallel over "model", K over "data"
        from torch.distributed.tensor import Shard

        for w in ("w1", "w3", "w2"):
            assert res["moe_placements"][f"experts.{w}.qw"] == (Shard(1), Shard(0))


def test_sequence_sharded_cache_writes_match_unsharded(run):
    """`write_rows` into a cache sharded over its sequence, B = 1 prefills
    longer than a block: bit for bit the unsharded cache's write."""
    for res in run["ranks"]:
        assert len(res["seq_cache"]) == 6
        for name, (got, want) in res["seq_cache"].items():
            assert torch.equal(got, want), name


def _jax_roundtrip(rank):
    return np.asarray(jdeq(jq(jnp.asarray(worker.psum_input(rank)))))


def test_compressed_psum_matches_jax(run):
    parts = [_jax_roundtrip(r) for r in range(worker.WORLD)]
    for rank, res in enumerate(run["ranks"]):
        np.testing.assert_allclose(res["psum_world"].numpy(), sum(parts), rtol=1e-6, atol=1e-6)
        m = rank % 2                                  # rank = data * 2 + model
        np.testing.assert_allclose(res["psum_data"].numpy(), parts[m] + parts[m + 2],
                                   rtol=1e-6, atol=1e-6)


def test_elastic_restore(run):
    """The (2, 2) run's checkpoint (global tensors) onto a (4, 1) mesh, with
    that mesh's placements, and onto no mesh: the same full tensors."""
    cfg = run["cfg"]
    mesh41 = ShapeMesh(data=4, model=1)
    for res in run["ranks"]:
        saved = res["saved_full"]
        assert set(res["restore41"]) == set(saved) == set(res["restore_plain"])
        for name, t in saved.items():
            assert torch.equal(res["restore41"][name], t), name
            assert torch.equal(res["restore_plain"][name], t), name
            want = to_placements(param_spec(name.split("."), t.shape, mesh41, cfg), mesh41)
            assert res["restore41_placements"][name] == want, name
        for name, t in res["saved_opt_m"].items():
            assert torch.equal(res["restore41_m"][name], t), name
