"""Carry parameters between a JAX parameter pytree (as numpy arrays) and
the port's modules, both ways.

The input is the pytree of `repro.models.init_lm` (optionally packed by
`repro.models.pack_params`) with every leaf converted to numpy by the
caller, e.g. ``jax.tree.map(np.asarray, params)``; this module imports
neither JAX nor the JAX package. Packed weights are recognised by their
``packed5``/``packed4``/``scale``/``K`` attributes and carried byte for byte.
The JAX layout stacks each stage's repeated layers on a leading axis
(``params["stages"][si]["b{pos}"]``); they are unstacked here, in the
order the stage scan applies them, into one module per layer; `lm_to_jax`
and `to_jax_tree` stack them back (the tests compare parameters and
gradients after training steps that way).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.packing import PackedWeight
from repro_torch.models.attention import Attention
from repro_torch.models.blocks import Block
from repro_torch.models.common import Embedding, Linear, PackedLinear, QLinear, RMSNorm
from repro_torch.models.decoder import LM, compress_layout
from repro_torch.models.moe import DenseFFN


def to_torch(arr, device) -> torch.Tensor:
    """numpy (including ml_dtypes bfloat16) → torch on `device`, bit for bit."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def _linear(node, r, device):
    """A linear's param dict ({"pw"|"qw"|"w": ...}) at layer `r` of its
    stack (r=None: unstacked)."""
    def at(a):
        return to_torch(np.asarray(a) if r is None else np.asarray(a)[r], device)

    if "pw" in node:
        pw = node["pw"]
        return PackedLinear(PackedWeight(
            at(pw.packed5).contiguous(), at(pw.packed4).contiguous(),
            at(pw.scale).contiguous(), K=int(pw.K)))
    if "qw" in node:
        return QLinear(at(node["qw"]))
    return Linear(at(node["w"]))


def _norm(node, r, device) -> RMSNorm:
    return RMSNorm(to_torch(np.asarray(node["scale"])[r], device))


def _block(node, r, device) -> Block:
    mx, ffn = node["mixer"], node["ffn"]
    qk = ((_norm(mx["q_norm"], r, device), _norm(mx["k_norm"], r, device))
          if "q_norm" in mx else (None, None))
    return Block(
        _norm(node["mixer_norm"], r, device),
        Attention(*(_linear(mx[k], r, device) for k in ("wq", "wk", "wv", "wo")), *qk),
        _norm(node["ffn_norm"], r, device),
        DenseFFN(*(_linear(ffn[k], r, device) for k in ("w1", "w3", "w2"))),
    )


def _reps(stage_node) -> int:
    leaf = stage_node["mixer_norm"]["scale"]
    return int(np.asarray(leaf).shape[0])


def lm_from_jax(params: dict, cfg, *, device="cuda") -> LM:
    """Build the port's `LM` from a numpy-leaved JAX `init_lm` pytree."""
    device = resolve_device(device)
    layers = []
    for stage in params["stages"]:
        pattern = sorted(stage, key=lambda k: int(k[1:]))           # b0, b1, ...
        for r in range(_reps(stage[pattern[0]])):
            layers.extend(_block(stage[pos], r, device) for pos in pattern)
    if len(layers) != cfg.n_layers:
        raise ValueError(f"pytree holds {len(layers)} layers, config {cfg.n_layers}")
    head = _linear(params["head"], None, device) if "head" in params else None
    return LM(
        Embedding(to_torch(params["embed"]["table"], device)),
        layers,
        RMSNorm(to_torch(params["final_norm"]["scale"], device)),
        head,
    )


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch → numpy, bit for bit (bf16 as ml_dtypes bfloat16)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # only where bf16 leaves are exported (the tests)

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _set(tree: dict, path: list[str], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def to_jax_tree(named: dict, cfg) -> dict:
    """A dict keyed like ``LM.named_parameters()`` (parameters, or their
    gradients) → the numpy pytree of JAX's `init_lm`: each stage's
    repeated layers stacked on a leading axis."""
    per_layer: dict[int, dict] = {}
    out: dict = {}
    for name, t in named.items():
        parts = name.split(".")
        if parts[0] == "layers":
            per_layer.setdefault(int(parts[1]), {})[tuple(parts[2:])] = to_numpy(t)
        else:
            _set(out, parts, to_numpy(t))
    stages, layer = [], 0
    for pattern, reps in compress_layout(cfg.layer_specs()):
        stage: dict = {}
        for pos in range(len(pattern)):
            idx = [layer + r * len(pattern) + pos for r in range(reps)]
            for key in per_layer[idx[0]]:
                _set(stage, [f"b{pos}", *key], np.stack([per_layer[i][key] for i in idx]))
        stages.append(stage)
        layer += reps * len(pattern)
    if layer != cfg.n_layers or len(per_layer) != cfg.n_layers:
        raise ValueError(f"{len(per_layer)} layers given, config {cfg.n_layers}")
    out["stages"] = stages
    return out


def lm_to_jax(model: LM, cfg) -> dict:
    """The inverse of `lm_from_jax` for unpacked models: the port's `LM` →
    a numpy pytree in the JAX stacked-stage layout."""
    return to_jax_tree(dict(model.named_parameters()), cfg)
