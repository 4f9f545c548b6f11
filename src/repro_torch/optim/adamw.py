"""AdamW with optional int8 moment quantization (ported from
`repro.optim.adamw`).

Plain functions over dicts keyed by ``model.named_parameters()`` names.
The int8 first moment is a shape-preserving `QTensor` (absmax per last-axis
row); the second moment is bf16 for leaves of at least ``SMALL`` elements.
Small leaves (norms, scales, biases) keep f32 moments. Which leaves are
"small" and which are decayed (ndim >= 2) is read from ``shapes`` when
given (`models.stacked_shapes`: the JAX stacked layout, where a stage's
per-layer leaves are one leaf), else from each tensor's own shape.

Unlike the JAX version, `adamw_update` updates the parameters IN PLACE
(under ``torch.no_grad``) and replaces the entries of the state dict; it
returns the same objects for symmetry with JAX's ``(params, opt, metrics)``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

SMALL = 4096


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    int8_state: bool = True
    # schedule
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


@dataclasses.dataclass
class QTensor:
    """Row-wise int8 tensor: q int8 (the source shape), scale f32
    (shape[:-1], absmax per last-axis row)."""
    q: torch.Tensor
    scale: torch.Tensor
    shape: tuple

    @property
    def dtype(self):
        return torch.float32


def quantize_blockwise(x: torch.Tensor) -> QTensor:
    """Shape-preserving int8 quantization, absmax per last-axis row."""
    xf = x.to(torch.float32)
    scale = torch.clamp_min(xf.abs().amax(-1), 1e-12) / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return QTensor(q, scale, tuple(x.shape))


def dequantize_blockwise(t: QTensor) -> torch.Tensor:
    return t.q.to(torch.float32) * t.scale[..., None]


def _numel(shape) -> int:
    return math.prod(shape)


def _maybe_q(x: torch.Tensor, enable: bool, shape=None):
    if enable and _numel(shape if shape is not None else x.shape) >= SMALL:
        return quantize_blockwise(x)
    return x.to(torch.float32)


def _maybe_dq(x):
    return dequantize_blockwise(x) if isinstance(x, QTensor) else x


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay to min_lr_ratio (f32, as JAX)."""
    step = step.to(torch.float32)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * frac


def adamw_init(params: dict, cfg: AdamWConfig, shapes: dict | None = None) -> dict:
    """m: int8 rows (first moment tolerates linear quantization), v: bf16
    (the second moment's dynamic range within a row breaks int8 absmax).
    ≈3 B/param total; f32 for small leaves or without ``int8_state``."""
    shapes = shapes or {}

    def m_like(n, p):
        zeros = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return _maybe_q(zeros, cfg.int8_state, shapes.get(n))

    def v_like(n, p):
        big = _numel(shapes.get(n, p.shape)) >= SMALL
        dt = torch.bfloat16 if cfg.int8_state and big else torch.float32
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    device = next(iter(params.values())).device if params else None
    return {
        "m": {n: m_like(n, p) for n, p in params.items()},
        "v": {n: v_like(n, p) for n, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree: dict) -> torch.Tensor:
    return torch.sqrt(sum((g.to(torch.float32) ** 2).sum() for g in tree.values()))


@torch.no_grad()
def adamw_update(params: dict, grads: dict, opt_state: dict, cfg: AdamWConfig,
                 shapes: dict | None = None):
    """→ (params, opt_state, metrics). Parameters are updated IN PLACE
    (``copy_`` under no_grad); ``opt_state``'s entries are replaced."""
    shapes = shapes or {}
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9), 1.0)
    lr = lr_at(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - cfg.b1 ** stepf
    b2c = 1 - cfg.b2 ** stepf
    m_all, v_all = opt_state["m"], opt_state["v"]
    for name, p in params.items():
        shape = shapes.get(name, tuple(p.shape))
        g = grads[name].to(torch.float32) * clip
        v_dtype = v_all[name].dtype
        m = _maybe_dq(m_all[name])
        v = v_all[name].to(torch.float32)
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        # decoupled weight decay on matrices only (ndim >= 2)
        if len(shape) >= 2:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
        m_all[name] = _maybe_q(m, cfg.int8_state, shape)
        v_all[name] = v.to(v_dtype)
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
