"""The port's checkpointer, trainer and fault tolerance: the tests of
tests/test_checkpoint.py (except the sharded restore) and
tests/test_trainer.py run against `repro_torch`, the port's checkpoint read
by the JAX checkpointer, and 3 `Trainer` steps held against the JAX
`Trainer` from the same weights and data."""
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.train import TrainConfig as JTrainConfig  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import pack_weight, ternary_quantize  # noqa: E402
from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.dist.fault_tolerance import StragglerMonitor, run_with_restarts  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.train import TrainConfig, Trainer  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The smoke model's ops are tiny: one intra-op thread each avoids the
    oversubscription that parallel test workers (each with all cores'
    worth of threads) otherwise pay many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# Checkpointer
# --------------------------------------------------------------------------
def _state(rng):
    w = torch.tensor(rng.standard_normal((8, 520)).astype(np.float32))  # >= 4096: int8 m
    tw = ternary_quantize(w)
    return {
        "params": {"w": w, "wb": w.to(torch.bfloat16), "pw": pack_weight(tw.values, tw.scale)},
        "opt": adamw_init({"w": w}, AdamWConfig(int8_state=True)),
        "count": torch.tensor(3),
    }


def _flat(tree):
    from repro_torch.checkpoint.checkpointer import _flatten

    return list(_flatten(tree))


def _trees_equal(a, b):
    la, lb = _flat(a), _flat(b)
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        x.dtype == y.dtype and torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))


class TestCheckpointer:
    def test_save_restore(self, tmp_path, rng):
        ck = Checkpointer(str(tmp_path))
        state = _state(rng)
        assert state["opt"]["m"]["w"].q.dtype == torch.int8     # a QTensor leaf
        ck.save(7, state, extra={"data": {"step": 7, "seed": 1}})
        template = {"params": {k: v for k, v in state["params"].items()},
                    "opt": state["opt"], "count": torch.empty((), device="meta")}
        restored, extra = ck.restore(template)
        assert _trees_equal(state, restored)
        assert restored["params"]["pw"].K == state["params"]["pw"].K
        assert extra["data"]["step"] == 7

    def test_async_save_snapshots_before_later_updates(self, tmp_path, rng):
        ck = Checkpointer(str(tmp_path))
        state = _state(rng)
        want = state["params"]["w"].clone()
        ck.save(1, state, blocking=False)
        state["params"]["w"].add_(1.0)                # the trainer updates in place
        ck.wait()
        assert ck.latest_step() == 1
        restored, _ = ck.restore(state)
        assert torch.equal(restored["params"]["w"], want)

    def test_incomplete_checkpoint_ignored(self, tmp_path, rng):
        ck = Checkpointer(str(tmp_path))
        ck.save(1, _state(rng))
        os.makedirs(tmp_path / "step_2")              # a torn write: no COMMIT
        (tmp_path / "step_2" / "manifest.json").write_text("{}")
        assert ck.latest_step() == 1

    def test_gc_keeps_last_k(self, tmp_path, rng):
        ck = Checkpointer(str(tmp_path), keep=2)
        state = _state(rng)
        for s in (1, 2, 3, 4):
            ck.save(s, state)
        assert ck.all_steps() == [3, 4]

    def test_shape_mismatch_raises(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        ck.save(1, {"w": torch.ones((4, 4))})
        with pytest.raises(ValueError):
            ck.restore({"w": torch.empty((5, 4), device="meta")})
        with pytest.raises(KeyError):
            ck.restore({"v": torch.empty((4, 4), device="meta")})

    def test_jax_checkpointer_reads_the_port_checkpoint(self, tmp_path, rng):
        """The same on-disk contract: leaf paths, manifest dtypes, bf16 as
        a raw u16 view, COMMIT — JAX restores what the port wrote."""
        ck = Checkpointer(str(tmp_path))
        w = rng.standard_normal((4, 6)).astype(np.float32)
        ck.save(3, {"p": {"w": torch.tensor(w), "b": torch.tensor(w).to(torch.bfloat16)},
                    "n": torch.tensor(5, dtype=torch.int32)}, extra={"k": 1})
        abstract = {"p": {"w": jax.ShapeDtypeStruct((4, 6), jnp.float32),
                          "b": jax.ShapeDtypeStruct((4, 6), jnp.bfloat16)},
                    "n": jax.ShapeDtypeStruct((), jnp.int32)}
        restored, extra = JCheckpointer(str(tmp_path)).restore(abstract)
        np.testing.assert_array_equal(np.asarray(restored["p"]["w"]), w)
        np.testing.assert_array_equal(np.asarray(restored["p"]["b"], np.float32),
                                      np.asarray(jnp.asarray(w, jnp.bfloat16), np.float32))
        assert int(restored["n"]) == 5 and extra == {"k": 1}


# --------------------------------------------------------------------------
# Trainer
# --------------------------------------------------------------------------
def _mk_trainer(tmp_path, steps=40, **kw):
    cfg = get_config("smollm-360m", smoke=True).with_(loss_chunk=64)
    tc = TrainConfig(total_steps=steps, checkpoint_every=20, log_every=10,
                     checkpoint_dir=str(tmp_path), **kw)
    opt = AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=steps)
    dc = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4)
    return Trainer(cfg, opt, tc, dc, device="cpu")


class TestTraining:
    def test_loss_decreases(self, tmp_path):
        tr = _mk_trainer(tmp_path / "a", steps=40)
        log = tr.run()
        assert log[-1]["loss"] < log[0]["loss"]
        assert all(np.isfinite(r["loss"]) for r in log)

    def test_resume_from_checkpoint(self, tmp_path):
        tr = _mk_trainer(tmp_path / "b", steps=20)
        tr.run()
        # a second trainer picks up at step 20 with the same weights and
        # optimizer state, and continues to 40
        tr2 = _mk_trainer(tmp_path / "b", steps=40)
        assert tr2.step == 20 and tr2.data.step == 20
        for (n, p), (_, q) in zip(tr.model.named_parameters(), tr2.model.named_parameters()):
            assert torch.equal(p, q), n
        assert int(tr2.state["opt"]["step"]) == 20
        tr2.run()
        assert tr2.step == 40

    def test_preemption_checkpoints_and_exits(self, tmp_path):
        tr = _mk_trainer(tmp_path / "c", steps=1000)
        orig_step = tr._step

        def step_and_preempt(state, batch):
            out = orig_step(state, batch)
            if tr.step >= 4:
                tr.guard.requested = True
            return out

        tr._step = step_and_preempt
        tr.run()
        assert tr.step < 1000
        assert tr.ckpt.latest_step() == tr.step  # saved on the way out

    def test_microbatch_accumulation(self, tmp_path):
        tr = _mk_trainer(tmp_path / "d", steps=3, microbatches=2)
        log = tr.run()
        assert np.isfinite(log[-1]["loss"])

    def test_microbatches_match_the_whole_batch(self, tmp_path):
        """Two microbatches of equal token counts: the mean of their losses
        and of their (f32-accumulated) gradients is the whole batch's, so
        one step gives the same loss and nearly the same weights (f32
        config: sums in another order only)."""
        cfg = get_config("smollm-360m", smoke=True).with_(dtype="float32", loss_chunk=64)
        runs = []
        for mb in (1, 2):
            tc = TrainConfig(total_steps=1, log_every=1, microbatches=mb,
                             checkpoint_dir=str(tmp_path / f"mb{mb}"))
            tr = Trainer(cfg, AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=10), tc,
                         DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4), device="cpu")
            runs.append((tr.run()[0]["loss"], dict(tr.model.named_parameters())))
        (l1, p1), (l2, p2) = runs
        np.testing.assert_allclose(l2, l1, rtol=1e-6)
        for n in p1:
            torch.testing.assert_close(p2[n], p1[n], rtol=1e-5, atol=1e-5)

    def test_grad_compression_trains(self, tmp_path):
        tr = _mk_trainer(tmp_path / "e", steps=30, grad_compression=True)
        log = tr.run()
        assert log[-1]["loss"] < log[0]["loss"] + 0.05
        assert set(tr.state["ef"]) == set(tr.state["params"])

    def test_three_steps_match_the_jax_trainer(self, tmp_path):
        """The same weights (the JAX Trainer's init, carried by the bridge)
        and the same synthetic batches, f32 config and f32 optimizer state.
        Gradients agree to ~1e-6 of each leaf's largest entry (sums in
        another order). Adam's first step divides each gradient by its own
        magnitude, so an element whose gradient is near zero (~eps) turns
        that noise into an update that differs by up to a share of lr: after
        step 1 all but a few elements agree to 1e-6. The QAT quantizers then
        move a few ternary or int8 codes where such an element sits at a
        rounding boundary, and the losses of steps 2-3 differ by ~2e-5 of
        their value; 1e-4 is the bound."""
        cfg = dict(dtype="float32", loss_chunk=64)
        jcfg = jget_config("smollm-360m", smoke=True).with_(**cfg)
        tcfg = get_config("smollm-360m", smoke=True).with_(**cfg)
        opt = dict(lr=3e-3, warmup_steps=2, total_steps=10, int8_state=False)
        data = dict(vocab=jcfg.vocab, seq_len=32, global_batch=4)
        jtr = JTrainer(jcfg, JAdamWConfig(**opt),
                       JTrainConfig(total_steps=1, log_every=1, checkpoint_dir=str(tmp_path / "j")),
                       JDataConfig(**data))
        model = bridge.lm_from_jax(jax.tree.map(np.asarray, jtr.state["params"]), tcfg,
                                   device="cpu")
        ttr = Trainer(tcfg, AdamWConfig(**opt),
                      TrainConfig(total_steps=1, log_every=1, checkpoint_dir=str(tmp_path / "t")),
                      DataConfig(**data), device="cpu", model=model)
        jlog, tlog = jtr.run(), ttr.run()
        want = jax.tree.leaves(jax.tree.map(np.asarray, jtr.state["params"]))
        got = jax.tree.leaves(bridge.lm_to_jax(ttr.model, tcfg))
        for a, b in zip(got, want):
            diff = np.abs(a - b)
            assert (diff > 1e-6).mean() < 1e-3 and diff.max() < opt["lr"]
        jtr.tc.total_steps = ttr.tc.total_steps = 3
        jlog, tlog = jtr.run(), ttr.run()
        assert [r["step"] for r in tlog] == [r["step"] for r in jlog] == [1, 2, 3]
        np.testing.assert_allclose([r["loss"] for r in tlog], [r["loss"] for r in jlog],
                                   rtol=1e-4)


class TestFaultTolerance:
    def test_straggler_monitor_flags_slow_host(self):
        events = []
        mon = StragglerMonitor(n_hosts=4, threshold=1.5, patience=2,
                               on_straggler=events.append)
        for step in range(10):
            mon.record(step, [0.1, 0.1, 0.1, 0.5])  # host 3 consistently 5x slower
        assert events and all(e.host == 3 for e in events)

    def test_straggler_monitor_ignores_uniform(self):
        mon = StragglerMonitor(n_hosts=4)
        for step in range(10):
            mon.record(step, [0.1, 0.11, 0.09, 0.1])
        assert not mon.events

    def test_trainer_feeds_the_monitor(self, tmp_path):
        tr = _mk_trainer(tmp_path / "f", steps=2)
        seen = []
        tr.monitor.record = lambda step, times: seen.append((step, len(times)))
        tr.run()
        assert seen == [(1, 1), (2, 1)]

    def test_run_with_restarts_retries(self):
        calls = []

        def fn(attempt):
            calls.append(attempt)
            if attempt < 2:
                raise RuntimeError("node lost")

        used = run_with_restarts(fn, max_restarts=3, sleep=lambda s: None)
        assert used == 2 and calls == [0, 1, 2]

    def test_run_with_restarts_gives_up(self):
        def fn(attempt):
            raise RuntimeError("permanent")

        with pytest.raises(RuntimeError):
            run_with_restarts(fn, max_restarts=2, sleep=lambda s: None)

    def test_non_retryable_propagates(self):
        def fn(attempt):
            raise ValueError("bug, not a fault")

        with pytest.raises(ValueError):
            run_with_restarts(fn, max_restarts=5, sleep=lambda s: None)
