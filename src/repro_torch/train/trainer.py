"""Fault-tolerant training loop (ported from `repro.train.trainer`).

  * a train step over the model's parameters: microbatch gradient
    accumulation in f32, optional int8 + error-feedback gradient
    compression at the accumulation boundary, AdamW updating the
    parameters in place;
  * periodic + preemption-triggered atomic checkpoints (async writer),
    including the data-pipeline state → exact replay on restart;
  * auto-resume from the latest complete checkpoint;
  * straggler monitor fed by per-step timings;
  * bounded-restart supervision via dist.fault_tolerance.run_with_restarts.

The state is ``{"params": {name: parameter}, "opt": adamw state[, "ef":
error feedback]}``; the parameters are the model's own tensors. AdamW and
the compression pick their per-leaf rules on the JAX stacked layout
(`models.stacked_shapes`), so both packages treat the same leaves alike. An
encoder-decoder config trains an `EncDec` on `encdec_loss`, its batches
carrying the JAX package's stub audio frames (`_stub_frames`).

With ``mesh=`` (a `DeviceMesh` with dims ("data", "model") or ("pod",
"data", "model"); every rank runs the same program) the training is
sharded by the `dist.sharding` rules: every rank draws the full tensors
from the seeded generator, then the parameters become DTensors placed by
`param_shardings`, the AdamW state (the int8 moments' ``q`` as its
parameter, ``scale`` without the last axis) and the error feedback by
`opt_shardings` / `param_shardings`, and each step's global batch — the
one JAX's single-process trainer reads — by `batch_shardings`. Steps run
under `use_sharding_ctx` (the models' activation constraints) and DTensor's
implicit replication of plain tensors (masks, positions, constants); each
gradient is reduced onto its parameter's placements before the update.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch import resolve_device
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.dist.compression import compress_tree, decompress_tree, ef_init
from repro_torch.dist.fault_tolerance import PreemptionGuard, StragglerMonitor
from repro_torch.dist.sharding import (
    batch_shardings,
    distribute,
    distribute_tree,
    full_tensor,
    opt_shardings,
    param_shardings,
    use_sharding_ctx,
)
from repro_torch.models import encdec_init, encdec_loss, init_lm, lm_loss, stacked_shapes
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

#: checkpoints go under the repository's build directory unless told otherwise
DEFAULT_CKPT_DIR = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "..", "build", "repro_torch_ckpt"))


@dataclasses.dataclass
class TrainConfig:
    total_steps: int = 100
    microbatches: int = 1
    checkpoint_every: int = 50
    checkpoint_dir: str = DEFAULT_CKPT_DIR
    keep_checkpoints: int = 3
    log_every: int = 10
    grad_compression: bool = False
    seed: int = 0


def make_loss_fn(cfg: ModelConfig):
    if cfg.family == "encdec":
        def loss_fn(model, batch):
            return encdec_loss(model, batch["frames"], batch["tokens"], batch["labels"], cfg,
                               mode="train")
    else:
        def loss_fn(model, batch):
            return lm_loss(model, batch["tokens"], batch["labels"], cfg, mode="train")
    return loss_fn


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, tc: TrainConfig):
    """→ ``train_step(model, state, batch) -> (state, metrics)``; the
    model's parameters (``state["params"]``) are updated in place."""
    loss_fn = make_loss_fn(cfg)

    def grads_of(model, params, batch):
        loss, metrics = loss_fn(model, batch)
        # a parameter the loss does not reach (deepseek-v3's router bias:
        # it only picks the top-k) gets a zero gradient, as under jax.grad
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                                    materialize_grads=True)
        # a sharded parameter's gradient comes back partial or otherwise
        # placed: reduce it onto the parameter's own placements
        grads = [g.redistribute(p.device_mesh, p.placements) if isinstance(p, DTensor) else g
                 for p, g in zip(params.values(), grads)]
        return loss.detach(), metrics, dict(zip(params, grads))

    def train_step(model, state, batch):
        params = state["params"]
        shapes = stacked_shapes(model, cfg)
        if tc.microbatches > 1:
            acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for n, p in params.items()}
            loss = 0.0
            for i in range(tc.microbatches):
                mb = {k: v.reshape(tc.microbatches, -1, *v.shape[1:])[i] for k, v in batch.items()}
                l, _, g = grads_of(model, params, mb)
                for n in acc:
                    acc[n] = acc[n] + g[n]
                loss = loss + l
            grads = {n: g / tc.microbatches for n, g in acc.items()}
            loss = loss / tc.microbatches
            metrics = {"ce": loss}
        else:
            loss, metrics, grads = grads_of(model, params, batch)
            metrics = {k: v.detach() for k, v in metrics.items()}

        if tc.grad_compression:
            comp, state["ef"] = compress_tree(grads, state["ef"], shapes)
            grads = decompress_tree(comp)
        _, state["opt"], om = adamw_update(params, grads, state["opt"], opt_cfg, shapes)
        return state, dict(metrics, loss=loss, **om)

    return train_step


class Trainer:
    """`model` (optional): the LM (or `EncDec`) to train, e.g. weights
    carried over from another run; by default `init_lm` (`encdec_init`)
    draws them from a ``torch.Generator`` seeded with ``tc.seed`` on
    `device`. A checkpoint in ``tc.checkpoint_dir`` takes precedence over
    both. `mesh`: shard the training over it (module docstring); its
    device type must be `device`'s."""

    def __init__(
        self,
        cfg: ModelConfig,
        opt_cfg: AdamWConfig,
        tc: TrainConfig,
        data_cfg: DataConfig,
        install_signals: bool = False,
        *,
        device="cuda",
        model=None,
        mesh=None,
    ):
        self.cfg, self.opt_cfg, self.tc = cfg, opt_cfg, tc
        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh cannot train on {self.device}")
        self.data = SyntheticLM(data_cfg)
        self.ckpt = Checkpointer(tc.checkpoint_dir, keep=tc.keep_checkpoints)
        self.guard = PreemptionGuard(install=install_signals)
        self.monitor = StragglerMonitor(n_hosts=1)
        self.metrics_log: list[dict] = []
        self._build_state(model)
        step_fn = make_train_step(cfg, opt_cfg, tc)
        self._step = lambda state, batch: step_fn(self.model, state, batch)

    # ------------------------------------------------------------------
    def _build_state(self, model):
        if model is None:
            init = encdec_init if self.cfg.family == "encdec" else init_lm
            model = init(self.cfg, torch.Generator(device=self.device).manual_seed(self.tc.seed))
        self.model = model.to(self.device).requires_grad_(True)
        params = dict(self.model.named_parameters())
        shapes = stacked_shapes(self.model, self.cfg)
        state = {"params": params, "opt": adamw_init(params, self.opt_cfg, shapes)}
        if self.tc.grad_compression:
            state["ef"] = ef_init(params)
        if self.mesh is not None:
            state = self._distribute(state)
        self.state = state
        self.step = 0
        # resume if a checkpoint exists
        latest = self.ckpt.latest_step()
        if latest is not None:
            restored, extra = self.ckpt.restore(self.state, latest)
            params = self.state["params"]
            with torch.no_grad():
                for name, p in params.items():
                    p.copy_(restored["params"][name])
            restored["params"] = params
            self.state = restored
            self.step = latest
            self.data.load_state_dict(extra["data"])

    def _distribute(self, state: dict) -> dict:
        """The state's tensors as DTensors placed by the sharding rules; the
        model's parameters are replaced by the distributed ones."""
        mesh, cfg = self.mesh, self.cfg
        shard = param_shardings(state["params"], mesh, cfg)
        with torch.no_grad():
            for name, p in state["params"].items():
                owner, leaf = name.rsplit(".", 1)
                d = distribute(p.detach(), shard[name])
                setattr(self.model.get_submodule(owner), leaf, torch.nn.Parameter(d))
        out = {"params": dict(self.model.named_parameters()),
               "opt": distribute_tree(state["opt"], opt_shardings(state["opt"], mesh, cfg))}
        if "ef" in state:
            out["ef"] = distribute_tree(state["ef"], shard)
        return out

    def _batch(self) -> dict:
        """The step's global batch, on the device (distributed by
        `batch_shardings` under a mesh)."""
        batch = {k: torch.from_numpy(v).to(self.device) for k, v in next(self.data).items()}
        if self.cfg.family == "encdec":
            b, s = batch["tokens"].shape
            batch["frames"] = _stub_frames(self.cfg, b, s, self.tc.seed).to(self.device)
        if self.mesh is not None:
            batch = distribute_tree(batch, batch_shardings(batch, self.mesh, self.cfg))
        return batch

    def _step_ctx(self):
        if self.mesh is None:
            return contextlib.nullcontext()
        from torch.distributed.tensor.experimental import implicit_replication

        stack = contextlib.ExitStack()
        stack.enter_context(use_sharding_ctx(self.mesh, self.cfg))
        stack.enter_context(implicit_replication())
        return stack

    # ------------------------------------------------------------------
    def save(self, blocking=True):
        self.ckpt.save(
            self.step, self.state,
            extra={"data": self.data.state_dict()}, blocking=blocking,
        )

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self) -> list[dict]:
        while self.step < self.tc.total_steps:
            if self.guard.requested:
                self.save(blocking=True)
                return self.metrics_log
            self.data.step = self.step
            batch = self._batch()
            t0 = time.perf_counter()
            with self._step_ctx():
                self.state, metrics = self._step(self.state, batch)
            self._sync()
            dt = time.perf_counter() - t0
            self.step += 1
            self.monitor.record(self.step, [dt])
            if self.step % self.tc.log_every == 0 or self.step == 1:
                row = {
                    "step": self.step,
                    "loss": float(full_tensor(metrics["loss"])),
                    "step_time_s": dt,
                }
                self.metrics_log.append(row)
                print(f"[train] {row}")
            if self.step % self.tc.checkpoint_every == 0:
                self.save(blocking=False)
        self.ckpt.wait()
        self.save(blocking=True)
        return self.metrics_log


def _stub_frames(cfg, b: int, s: int, seed: int) -> torch.Tensor:
    """The stub frontend's frame embeddings, (b, max(s // enc_frame_ratio,
    1), d_model) bf16: a fresh numpy draw from `seed` (the same frames
    every step, as in the JAX package), rounded from f64 to bf16 once, as
    JAX converts them."""
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((b, max(s // cfg.enc_frame_ratio, 1), cfg.d_model))
    return torch.from_numpy(frames).to(torch.bfloat16)
