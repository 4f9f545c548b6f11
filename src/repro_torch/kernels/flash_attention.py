"""Flash attention: the CUDA forward kernel's wrapper, its plain PyTorch
version, its launch count, and the differentiable `flash_attention_trainable`.

Port of the TPU kernel `flash_attention` (src/repro/kernels/flash_attention.py).
The CUDA source is ``csrc/flash_attention.cu``. The public layout is the
JAX one, q (B, H, Sq, D) and k, v (B, KV, Sk, D), but any strides with a
unit stride along D are read in place: the model passes transposed views of
its (B, S, H, D) tensors and gets the output back in that layout, with no
copies and no padding.

As in the JAX package there is no backward kernel: the gradient of
`flash_attention_trainable` is re-derived through the plain version under
autograd (recompute-style), as `_fa_bwd` does.
"""
from __future__ import annotations

import torch

from . import _build

NEG_INF = -1e30
MAX_HEAD_DIM = 256
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def check_attention_args(q, k, v, window: int) -> None:
    """q (B, H, Sq, D), k and v (B, KV, Sk, D), one float dtype and device,
    H a multiple of KV, D <= 256, unit stride along D. Rows with no valid
    key (a window with Sq > Sk) are rejected: the model never makes them."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, H, Sq, D) and k, v (B, KV, Sk, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    kb, kv, sk, kd = k.shape
    if kb != b or kd != d or kv == 0 or h % kv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree "
                         "(batch, head dim, or H not a multiple of KV)")
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} is outside 1..{MAX_HEAD_DIM}")
    if sq == 0 or sk == 0:
        raise ValueError("empty query or key sequence")
    if window and sq > sk:
        raise ValueError(f"window={window} with Sq={sq} > Sk={sk} leaves rows with no valid key")
    if len({q.dtype, k.dtype, v.dtype}) != 1 or not q.is_floating_point():
        raise ValueError(f"q, k, v must share one float dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k, v must be on one device")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k, v need a unit stride along the head dim")


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0) -> torch.Tensor:
    """Plain version (the port's copy of `_ref_attention`): f32 scores, a
    full softmax over -1e30-masked scores, an f32 p @ v, one cast to q's
    dtype. Differentiable under autograd."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    qg = q.reshape(b, kv, h // kv, sq, d).to(torch.float32)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.to(torch.float32)) * (d ** -0.5)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window:
        mask = mask & (q_pos - k_pos < window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", p, v.to(torch.float32))
    return out.reshape(b, h, sq, d).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q (B, H, Sq, D), k, v (B, KV, Sk, D) → (B, H, Sq, D) in q's dtype,
    laid out like q.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    add one to ``flash_attention.launches``) or raise."""
    check_attention_args(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window, softcap=softcap)
    if q.device.type != "cuda" or q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"the CUDA kernel takes f32/bf16 CUDA tensors, got "
                         f"{q.dtype} on {q.device}")
    b, h, sq, d = q.shape
    if not (b <= 65535 and h <= 65535):
        raise ValueError(f"batch {b} or heads {h} exceed the kernel's grid")
    out = torch.empty_like(q)   # q's strides: (B, S, H, D) memory for a transposed view
    _build.launch_flash(q, k, v, out, causal=causal, window=window,
                        scale=float(d) ** -0.5, softcap=float(softcap))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


class _FlashAttention(torch.autograd.Function):
    """Forward: the kernel (the plain version on the CPU). Backward: the VJP
    of the plain version, recomputed under autograd."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap)
        return flash_attention(q, k, v, **ctx.opts)

    @staticmethod
    def backward(ctx, dout):
        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
            out = flash_attention_plain(q, k, v, **ctx.opts)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), dout)
        return dq, dk, dv, None, None, None


def flash_attention_trainable(q, k, v, causal: bool = True, window: int = 0,
                              softcap: float = 0.0) -> torch.Tensor:
    """`flash_attention` with gradients (JAX's `flash_attention_trainable`)."""
    return _FlashAttention.apply(q, k, v, causal, window, softcap)
