"""Carry parameters between a JAX parameter pytree (as numpy arrays) and
the port's modules, both ways.

The input is the pytree of `repro.models.init_lm` or of
`repro.models.encdec_init` (``{"encoder": {"stages", "final_norm"},
"decoder": <init_lm tree>}``), optionally packed by
`repro.models.pack_params`, with every leaf converted to numpy by the
caller, e.g. ``jax.tree.map(np.asarray, params)``; this module imports
neither JAX nor the JAX package. Packed weights are recognised by their
``packed5``/``packed4``/``scale``/``K`` attributes and carried byte for byte.
The JAX layout stacks each stage's repeated layers on a leading axis
(``params["stages"][si]["b{pos}"]``); they are unstacked here, in the
order the stage scan applies them, into one module per layer; `lm_to_jax`,
`encdec_to_jax` and `to_jax_tree` stack them back (the tests compare
parameters and gradients after training steps that way), packed weights
as `PackedWeight`s of numpy arrays.
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
from repro_torch.models.encdec import EncDec, Encoder, encoder_specs
from repro_torch.models.mla import MLA
from repro_torch.models.moe import DenseFFN, MoEFFN
from repro_torch.models.ssm import SSM


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


def _swiglu(node, r, device) -> DenseFFN:
    return DenseFFN(*(_linear(node[k], r, device) for k in ("w1", "w3", "w2")))


def _ffn(node, r, device):
    """A dense FFN, or a MoE FFN (keys "router", "experts", optionally
    "router_bias" and "shared"; the experts' leaves are (reps, E, ...),
    taken at layer r)."""
    if "router" not in node:
        return _swiglu(node, r, device)
    bias = node.get("router_bias")
    return MoEFFN(
        _linear(node["router"], r, device), _swiglu(node["experts"], r, device),
        None if bias is None else to_torch(np.asarray(bias)[r], device),
        _swiglu(node["shared"], r, device) if "shared" in node else None)


def _mixer(mx, r, device):
    """The MLA mixer where the node carries its latent projections
    ("wq_a", ...), the SSM mixer where it carries "in_proj", else the GQA
    attention mixer (with its optional q/k norms)."""
    if "in_proj" in mx:
        return SSM(_linear(mx["in_proj"], r, device),
                   *(to_torch(np.asarray(mx[k])[r], device)
                     for k in ("conv_w", "conv_b", "A_log", "D", "dt_bias")),
                   _norm(mx["norm"], r, device), _linear(mx["out_proj"], r, device))
    if "wq_a" in mx:
        return MLA(*(_norm(mx[k], r, device) if k.endswith("norm") else _linear(mx[k], r, device)
                     for k in ("wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b", "wo")))
    qk = ((_norm(mx["q_norm"], r, device), _norm(mx["k_norm"], r, device))
          if "q_norm" in mx else (None, None))
    return Attention(*(_linear(mx[k], r, device) for k in ("wq", "wk", "wv", "wo")), *qk)


def _block(node, r, device) -> Block:
    ffn = (() if "ffn" not in node
           else (_norm(node["ffn_norm"], r, device), _ffn(node["ffn"], r, device)))
    cross = ({} if "cross" not in node
             else {"cross_norm": _norm(node["cross_norm"], r, device),
                   "cross": _mixer(node["cross"], r, device)})
    return Block(_norm(node["mixer_norm"], r, device), _mixer(node["mixer"], r, device), *ffn,
                 **cross)


def _reps(stage_node) -> int:
    leaf = stage_node["mixer_norm"]["scale"]
    return int(np.asarray(leaf).shape[0])


def _stage_layers(stages: list, device) -> list[Block]:
    """One module per layer of the stacked stages, in the scan's order."""
    layers = []
    for stage in stages:
        pattern = sorted(stage, key=lambda k: int(k[1:]))           # b0, b1, ...
        for r in range(_reps(stage[pattern[0]])):
            layers.extend(_block(stage[pos], r, device) for pos in pattern)
    return layers


def lm_from_jax(params: dict, cfg, *, device="cuda") -> LM:
    """Build the port's `LM` from a numpy-leaved JAX `init_lm` pytree."""
    device = resolve_device(device)
    layers = _stage_layers(params["stages"], device)
    if len(layers) != cfg.n_layers:
        raise ValueError(f"pytree holds {len(layers)} layers, config {cfg.n_layers}")
    head = _linear(params["head"], None, device) if "head" in params else None
    return LM(
        Embedding(to_torch(params["embed"]["table"], device)),
        layers,
        RMSNorm(to_torch(params["final_norm"]["scale"], device)),
        head,
    )


def encdec_from_jax(params: dict, cfg, *, device="cuda") -> EncDec:
    """Build the port's `EncDec` from a numpy-leaved JAX `encdec_init`
    pytree: the encoder's stages and final norm, and the decoder's
    `init_lm` tree."""
    device = resolve_device(device)
    enc = params["encoder"]
    layers = _stage_layers(enc["stages"], device)
    if len(layers) != cfg.enc_layers:
        raise ValueError(f"pytree holds {len(layers)} encoder layers, config {cfg.enc_layers}")
    return EncDec(Encoder(layers, RMSNorm(to_torch(enc["final_norm"]["scale"], device))),
                  lm_from_jax(params["decoder"], cfg, device=device))


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


def _leaf(t):
    if isinstance(t, PackedWeight):
        return PackedWeight(to_numpy(t.packed5), to_numpy(t.packed4), to_numpy(t.scale), K=t.K)
    return to_numpy(t)


def _stack(leaves: list):
    if isinstance(leaves[0], PackedWeight):
        return PackedWeight(*(np.stack([getattr(x, f) for x in leaves])
                              for f in ("packed5", "packed4", "scale")), K=leaves[0].K)
    return np.stack(leaves)


def to_jax_tree(named: dict, cfg, specs=None) -> dict:
    """A dict keyed like ``LM.named_parameters()`` (parameters, or their
    gradients; a packed linear's "<path>.pw" a `PackedWeight`) → the numpy
    pytree of JAX's `init_lm`: each stage's repeated layers (of `specs`,
    the config's by default) stacked on a leading axis."""
    specs = cfg.layer_specs() if specs is None else specs
    per_layer: dict[int, dict] = {}
    out: dict = {}
    for name, t in named.items():
        parts = name.split(".")
        if parts[0] == "layers":
            per_layer.setdefault(int(parts[1]), {})[tuple(parts[2:])] = _leaf(t)
        else:
            _set(out, parts, _leaf(t))
    stages, layer = [], 0
    for pattern, reps in compress_layout(specs):
        stage: dict = {}
        for pos in range(len(pattern)):
            idx = [layer + r * len(pattern) + pos for r in range(reps)]
            for key in per_layer[idx[0]]:
                _set(stage, [f"b{pos}", *key], _stack([per_layer[i][key] for i in idx]))
        stages.append(stage)
        layer += reps * len(pattern)
    if layer != len(specs) or len(per_layer) != len(specs):
        raise ValueError(f"{len(per_layer)} layers given, config {len(specs)}")
    out["stages"] = stages
    return out


def named_leaves(model: torch.nn.Module) -> dict:
    """The model's parameters by name, and each packed linear's weight as
    "<path>.pw": the leaves of its JAX pytree."""
    out = dict(model.named_parameters())
    for name, mod in model.named_modules():
        if isinstance(mod, PackedLinear):
            out[f"{name}.pw"] = mod.pw
    return out


def lm_to_jax(model: LM, cfg) -> dict:
    """The inverse of `lm_from_jax`: the port's `LM`, packed or not → a
    numpy pytree in the JAX stacked-stage layout."""
    return to_jax_tree(named_leaves(model), cfg)


def encdec_tree(named: dict, cfg) -> dict:
    """A dict keyed like ``EncDec.named_parameters()`` (or `named_leaves`,
    or gradients) → the numpy pytree of JAX's `encdec_init`."""
    parts: dict = {"encoder": {}, "decoder": {}}
    for name, t in named.items():
        top, rest = name.split(".", 1)
        parts[top][rest] = t
    return {"encoder": to_jax_tree(parts["encoder"], cfg, encoder_specs(cfg)),
            "decoder": to_jax_tree(parts["decoder"], cfg)}


def encdec_to_jax(model: EncDec, cfg) -> dict:
    """The inverse of `encdec_from_jax`, packed or not."""
    return encdec_tree(named_leaves(model), cfg)
