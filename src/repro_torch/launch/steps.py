"""Serving step builders (ported from `repro.launch.steps`): one greedy
prefill step and one greedy decode step, for a decoder-only `LM` or an
encoder-decoder `EncDec`. They are the enc-dec model's serving path: the
`serve.Engine` takes decoder-only models only.

    prefill = make_prefill_step(cfg)
    tok, cache = prefill(model, init_cache(cfg, B, max_len, enc_len=S_enc),
                         {"tokens": prompts, "frames": frames})
    decode = make_decode_step(cfg)
    tok, cache = decode(model, cache, tok[:, None])

An enc-dec prefill encodes the frames (mode "serve"), runs the decoder's
prefill with the encoder output (each layer stores its cross K/V in the
cache), and takes the argmax; decode steps reuse the cached cross K/V.
Each step runs without autograd on `device` (the card unless asked for the
CPU): the batch's tensors are moved there, and the model and the cache
must already be there.

The mesh half: `make_train_step` (one QAT step; under
``use_sharding_ctx(mesh, cfg)`` with DTensor parameters and batches it is
the sharded step), and the dry run's abstract state — `abstract_train_state`,
`abstract_serve_params`, `abstract_cache`, `input_specs` — each a tree of
meta-device tensors (shapes and dtypes, no allocation, even for
deepseek-v3-671b) with the matching tree of `dist.sharding.NamedSharding`s.
Every step applies the JAX steps' activation constraints
(`dist.sharding.shard_act`): the identity outside a sharding context.
"""
from __future__ import annotations

import functools

import torch

from repro_torch import resolve_device
from repro_torch.bridge import named_leaves
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.dist.sharding import (
    batch_shardings,
    cache_shardings,
    opt_shardings,
    param_shardings,
    shard_act,
)
from repro_torch.models import decode_step as model_decode
from repro_torch.models import encdec_init, encode, init_cache, init_lm, pack_params, stacked_shapes
from repro_torch.models import prefill as model_prefill
from repro_torch.optim import AdamWConfig, adamw_init


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig):
    """→ ``train_step(model, state, batch) -> (state, metrics)``: the
    trainer's step (`train.trainer.make_train_step`, one microbatch, no
    compression) behind the JAX step's constraints on the tokens and
    labels. The model's parameters (``state["params"]``) are updated in
    place."""
    from repro_torch.train.trainer import TrainConfig
    from repro_torch.train.trainer import make_train_step as trainer_step

    step = trainer_step(cfg, opt_cfg, TrainConfig())

    def train_step(model, state, batch):
        batch = dict(batch, tokens=shard_act(batch["tokens"], "tokens"),
                     labels=shard_act(batch["labels"], "tokens"))
        return step(model, state, batch)

    return train_step


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """The next tokens, argmax over the last dim, as int32. Logits sharded
    over the vocabulary (a DTensor under a mesh) are gathered along it
    first: DTensor's own argmax over a sharded dim reads its offsets from
    the data, which a fake trace cannot."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if isinstance(logits, DTensor):
        last = logits.ndim - 1
        logits = logits.redistribute(logits.device_mesh, [
            Replicate() if isinstance(p, Shard) and p.dim == last else p
            for p in logits.placements])
    return torch.argmax(logits, dim=-1).to(torch.int32)


def make_prefill_step(cfg: ModelConfig, *, device="cuda"):
    """→ ``prefill_step(model, cache, batch) -> (next tokens (B,) int32,
    new_cache)``; batch: "tokens" (B, S) int and, for an enc-dec model,
    "frames" (B, S_enc, d_model)."""
    is_encdec = cfg.family == "encdec"
    device = resolve_device(device)

    @torch.no_grad()
    def prefill_step(model, cache, batch):
        tokens = shard_act(batch["tokens"].to(device), "tokens")
        enc_out, dec = None, model
        if is_encdec:
            enc_out = encode(model, batch["frames"].to(device), cfg, mode="serve")
            dec = model.decoder
        logits, new_cache = model_prefill(dec, tokens, cache, cfg, enc_out=enc_out)
        return greedy(logits), new_cache

    return prefill_step


def make_decode_step(cfg: ModelConfig, *, device="cuda"):
    """→ ``decode_step(model, cache, tokens (B, 1)) -> (next tokens (B,)
    int32, new_cache)``."""
    is_encdec = cfg.family == "encdec"
    device = resolve_device(device)

    @torch.no_grad()
    def decode_step(model, cache, tokens):
        dec = model.decoder if is_encdec else model
        logits, new_cache = model_decode(dec, tokens.to(device), cache, cfg)
        return greedy(logits), new_cache

    return decode_step


# --------------------------------------------------------------------------
# abstract state (meta tensors: no allocation) with its shardings
# --------------------------------------------------------------------------
def init_params(cfg: ModelConfig, generator: torch.Generator, *, device=None):
    """The model of `cfg`: `encdec_init` for an encoder-decoder, else
    `init_lm` (on `device`; "meta" for shapes alone)."""
    init = encdec_init if cfg.family == "encdec" else init_lm
    return init(cfg, generator, device=device)


@functools.lru_cache(maxsize=None)
def _meta_model(cfg: ModelConfig, packed: bool):
    model = init_params(cfg, torch.Generator(), device="meta")
    return pack_params(model, cfg) if packed else model


def meta_model(cfg: ModelConfig, *, packed: bool = False):
    """The model of `cfg` on the meta device (shapes and dtypes, no data),
    dense or packed, built once per config (the serving cache length,
    which no parameter depends on, aside): the dry run asks for each
    arch's once per cell. Shared: callers must not change it."""
    return _meta_model(cfg.with_(max_cache_len=0), packed)


@functools.lru_cache(maxsize=None)
def _meta_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig):
    model = meta_model(cfg)
    params = dict(model.named_parameters())
    return params, adamw_init(params, opt_cfg, stacked_shapes(model, cfg))


def abstract_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig, mesh):
    """→ (state, shardings): ``{"params", "opt"}`` as meta tensors (the
    trainer's state; AdamW's int8 moments chosen on the JAX stacked layout)
    and their `NamedSharding`s on `mesh`."""
    params, opt = _meta_train_state(cfg.with_(max_cache_len=0), opt_cfg)
    opt = {k: dict(v) if isinstance(v, dict) else v for k, v in opt.items()}
    return ({"params": dict(params), "opt": opt},
            {"params": param_shardings(params, mesh, cfg), "opt": opt_shardings(opt, mesh, cfg)})


def abstract_serve_params(cfg: ModelConfig, mesh):
    """→ (leaves, shardings) of the packed serving model (`pack_params`):
    its parameters by name and each packed linear's `PackedWeight` at
    "<path>.pw" (`bridge.named_leaves`: the JAX pytree's leaves)."""
    leaves = named_leaves(meta_model(cfg, packed=True))
    return leaves, param_shardings(leaves, mesh, cfg)


def abstract_cache(cfg: ModelConfig, mesh, batch: int, max_len: int, enc_len: int = 0):
    """→ (cache, shardings): the bf16 serving cache of `batch` slots of
    `max_len` (one dict a layer)."""
    cache = init_cache(cfg, batch, max_len, dtype=torch.bfloat16, enc_len=enc_len,
                       device="meta")
    return cache, cache_shardings(cache, mesh, cfg)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """→ (batch, shardings): meta stand-ins for every model input of the
    (arch × shape) cell — tokens and labels (train), tokens (prefill; one
    token a sequence for decode), and an enc-dec model's bf16 frames."""
    b, s = shape.global_batch, shape.seq_len

    def meta(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    if shape.kind == "decode":
        batch = {"tokens": meta((b, 1), torch.int32)}
    else:
        batch = {"tokens": meta((b, s), torch.int32)}
        if shape.kind == "train":
            batch["labels"] = meta((b, s), torch.int32)
        if cfg.family == "encdec":
            batch["frames"] = meta((b, s // cfg.enc_frame_ratio, cfg.d_model), torch.bfloat16)
    return batch, batch_shardings(batch, mesh, cfg)
