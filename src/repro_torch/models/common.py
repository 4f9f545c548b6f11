"""Shared model building blocks: linears (QAT-ternary / packed-serve /
dense), RMSNorm, RoPE, embeddings (ported from `repro.models.common`).

The JAX package keeps parameters as nested dicts keyed "qw" (dense weight of
a quantizable linear, (K_in, M_out)), "pw" (its packed form) and "w" (a
non-quantized linear). Here each is an `nn.Module`: `QLinear`, `PackedLinear`
and `Linear`. The functional `*_apply` functions keep the JAX names and take
the module as their parameter argument.

Parameters are built frozen (``requires_grad=False``): serving never needs
their gradients. The trainer turns them on (`train.Trainer`).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.packing import PackedWeight
from repro_torch.core.quantize import fake_act_quant, fake_ternary_cols
from repro_torch.kernels.ops import ternary_matmul


def torch_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


# --------------------------------------------------------------------------
# Linear
# --------------------------------------------------------------------------
class QLinear(nn.Module):
    """A quantizable linear before packing ("qw"): dense (K_in, M_out)."""

    def __init__(self, qw: torch.Tensor):
        super().__init__()
        self.qw = _frozen(qw)


class PackedLinear(nn.Module):
    """A packed ternary linear ("pw"): the mpGeMM kernels' operand."""

    def __init__(self, pw: PackedWeight):
        super().__init__()
        self.register_buffer("packed5", pw.packed5)
        self.register_buffer("packed4", pw.packed4)
        self.register_buffer("scale", pw.scale)
        self.K = pw.K

    @property
    def pw(self) -> PackedWeight:
        return PackedWeight(self.packed5, self.packed4, self.scale, self.K)


class Linear(nn.Module):
    """A non-quantized linear ("w"): dense (K_in, M_out)."""

    def __init__(self, w: torch.Tensor):
        super().__init__()
        self.w = _frozen(w)


def linear_init(k_in: int, m_out: int, cfg, *, generator: torch.Generator,
                device, quant: bool = True) -> nn.Module:
    w = torch.randn((k_in, m_out), generator=generator, device=device,
                    dtype=torch.float32) * (1.0 / (k_in ** 0.5))
    cls = QLinear if (quant and cfg.quant == "ternary") else Linear
    return cls(w.to(torch_dtype(cfg)))


def linear_apply(p: nn.Module, x: torch.Tensor, mode: str = "serve") -> torch.Tensor:
    """x: (..., K) → (..., M). mode: 'train' | 'eval' | 'serve'."""
    if isinstance(p, PackedLinear):  # packed serving path → the paper's kernel
        return ternary_matmul(p.pw, x)
    if isinstance(p, QLinear):
        wq = fake_ternary_cols(p.qw).to(x.dtype)
        if mode in ("train", "eval"):
            # QAT: ternary weight fake-quant + per-token int8 activation STE
            return fake_act_quant(x) @ wq
        # mode == 'serve' on unconverted params: dense ternarized compute
        return x @ wq
    return x @ p.w.to(x.dtype)


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------
class RMSNorm(nn.Module):
    def __init__(self, scale: torch.Tensor):
        super().__init__()
        self.scale = _frozen(scale)


def rmsnorm_init(d: int, device) -> RMSNorm:
    return RMSNorm(torch.ones((d,), dtype=torch.float32, device=device))


def rmsnorm_apply(p: RMSNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p.scale).to(x.dtype)


# --------------------------------------------------------------------------
# RoPE (half-split, not interleaved)
# --------------------------------------------------------------------------
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D) with D even; positions: (B, S) int."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = positions.to(torch.float32)[..., None] * freqs             # (B,S,D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Embedding
# --------------------------------------------------------------------------
class Embedding(nn.Module):
    def __init__(self, table: torch.Tensor):
        super().__init__()
        self.table = _frozen(table)


def embed_init(vocab: int, d: int, cfg, *, generator: torch.Generator, device) -> Embedding:
    t = torch.randn((vocab, d), generator=generator, device=device, dtype=torch.float32)
    return Embedding(t.to(torch_dtype(cfg)) * 0.02)


def embed_apply(p: Embedding, tokens: torch.Tensor, cfg) -> torch.Tensor:
    x = p.table[tokens.to(torch.long)]
    if cfg.emb_scale_by_dim:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    return x
