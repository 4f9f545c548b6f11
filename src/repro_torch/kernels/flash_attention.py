"""Flash attention: the CUDA forward kernel's wrapper, its plain PyTorch
version, its launch count, and the differentiable `flash_attention_trainable`.

Port of the TPU kernel `flash_attention` (src/repro/kernels/flash_attention.py).
The CUDA source is ``csrc/flash_attention.cu``. The public layout is the
JAX one, q (B, H, Sq, D) and k, v (B, KV, Sk, D), but any strides with a
unit stride along D are read in place: the model passes transposed views of
its (B, S, H, D) tensors and gets the output back in that layout, with no
copies and no padding.

`flash_plan` is the kernel's launch plan, chosen on the host from the
shapes, strides and dtype: which of the two kernels runs (bf16 with D <= 128
on the tensor cores, else the CUDA cores), the query rows per block, the
keys per tile, the padded D, the pipeline stages, whether the 16-byte
asynchronous copies are allowed, the grid and the dynamic shared bytes. The
C entry recomputes the shared bytes and refuses a plan that disagrees.

As in the JAX package there is no backward kernel: the gradient of
`flash_attention_trainable` is re-derived through the plain version under
autograd (recompute-style), as `_fa_bwd` does. The forward is also the
operator ``repro_torch::flash_attention`` (`_library`), the route of fake
tensors, so that a trace sees each launch as one operation.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch.distributed.tensor import DTensor

from . import _build, _library

NEG_INF = -1e30
MAX_HEAD_DIM = 256
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)

# The plan's constants (the kernels' are in csrc/flash_attention.cu)
MMA_MAX_D = 128             # the tensor-core kernel takes bf16 up to this D
MMA_BQ, MMA_BK = 64, 32     # its query rows per block (4 warps), keys per tile
MMA_STAGES = 2              # its K/V tiles in flight (double buffering)
FMA_BQ, FMA_BK = 64, 64     # the CUDA-core kernel: rows per block, keys per tile


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    """One launch of the flash kernel. Block (x, y) of the grid owns query
    rows `rows(y)` of batch x // H, head x % H ("mma": x = b * H + h, y the
    query tile reversed) or block (x, y, z) rows `rows(x)` of head y, batch
    z ("fma"); each walks the key tiles `key_tiles` gives."""
    kernel: str             # "mma" (tensor cores) or "fma" (CUDA cores)
    bq: int                 # query rows per block
    bk: int                 # keys per tile
    dp: int                 # D padded in shared memory
    stages: int             # K/V tile buffers
    aligned: bool           # 16-byte cp.async copies (else element loads)
    grid: tuple             # (x, y, z) blocks
    smem: int               # dynamic shared bytes
    sq: int
    sk: int
    causal: bool
    window: int

    def query_tile(self, y: int) -> int:
        """The query tile block row y of the grid owns ("mma": reversed)."""
        return self.grid[1] - 1 - y if self.kernel == "mma" else y

    def rows(self, qt: int) -> tuple[int, int]:
        return qt * self.bq, min(self.sq, (qt + 1) * self.bq)

    def key_tiles(self, qt: int) -> range:
        """Key tiles that hold a valid key for at least one row of query
        tile qt, as the kernels compute them: the causal mask ends the range
        at the last row's tile, the window starts it at the first row's."""
        q0, q_last = qt * self.bq, min(self.sq, (qt + 1) * self.bq) - 1
        end = -(-self.sk // self.bk)
        if self.causal:
            end = min(end, q_last // self.bk + 1)
        begin = max(0, (q0 - self.window + 1) // self.bk) if self.window else 0
        return range(begin, end)


def pad_d(d: int) -> int:
    """The tensor-core kernel's D in shared memory: the next of 16, 32, 64
    and 128 (a multiple of the mma depth 16; a power of two keeps the
    swizzle conflict-free)."""
    return next(x for x in (16, 32, 64, 128) if d <= x)


def mma_smem_bytes(dp: int) -> int:
    """Q [MMA_BQ][dp] and `MMA_STAGES` x (K, V) [MMA_BK][dp] tiles, bf16."""
    return 2 * dp * (MMA_BQ + 2 * MMA_STAGES * MMA_BK)


def fma_dp(d: int) -> int:
    """The CUDA-core kernel's padded D of its V tile: 16 threads x the next
    of 2, 4, 8 and 16 columns each."""
    return next(x for x in (32, 64, 128, 256) if d <= x)


def fma_smem_bytes(d: int) -> int:
    """The CUDA-core kernel's f32 Q and K [64][d + 1], V [64][fma_dp(d)]
    and p [64][65] tiles."""
    return 4 * ((FMA_BQ + FMA_BK) * (d + 1) + FMA_BK * fma_dp(d) + FMA_BQ * (FMA_BK + 1))


def copies_aligned(d: int, strides, ptrs) -> bool:
    """May the kernel stage tiles with 16-byte cp.async copies? Every base
    pointer (q, k, v, out) 16-byte aligned, and D and every (batch, head,
    position) stride a multiple of 8 bf16 elements, so each 8-element run
    along D starts on 16 bytes. True for the model's transposed (B, S, H,
    D) views at D 64 and 128; false at D 20."""
    return (d % 8 == 0 and all(s % 8 == 0 for st in strides for s in st)
            and all(p % 16 == 0 for p in ptrs))


@functools.lru_cache(maxsize=1024)
def flash_plan(b: int, h: int, sq: int, sk: int, d: int, strides: tuple,
               dtype: torch.dtype, ptr_mod16: tuple = (0, 0, 0, 0), *,
               causal: bool = True, window: int = 0) -> FlashPlan:
    """The launch of one call (cached: training asks for one shape). q and
    out are (b, h, sq, d), k and v (b, KV, sk, d); strides: the (batch,
    head, position) element strides of q, k, v and out; ptr_mod16: their
    base pointers modulo 16 bytes.

    - bf16 with D <= 128: the tensor-core kernel, 4 warps and 64 query rows
      a block, 32-key tiles, double-buffered;
    - else (f32, or D > 128): the CUDA-core kernel, 64 rows, 64-key tiles,
      256 threads."""
    if dtype == torch.bfloat16 and d <= MMA_MAX_D:
        dp = pad_d(d)
        return FlashPlan("mma", MMA_BQ, MMA_BK, dp, MMA_STAGES,
                         copies_aligned(d, strides, ptr_mod16), (b * h, -(-sq // MMA_BQ), 1),
                         mma_smem_bytes(dp), sq, sk, causal, window)
    return FlashPlan("fma", FMA_BQ, FMA_BK, fma_dp(d), 1, False, (-(-sq // FMA_BQ), h, b),
                     fma_smem_bytes(d), sq, sk, causal, window)


def plan_for(q, k, v, out, *, causal: bool, window: int) -> FlashPlan:
    """`flash_plan` for these tensors."""
    b, h, sq, d = q.shape
    ts = (q, k, v, out)
    return flash_plan(b, h, sq, k.shape[2], d,
                      tuple(tuple(t.stride()[:3]) for t in ts), q.dtype,
                      tuple(t.data_ptr() % 16 for t in ts), causal=bool(causal),
                      window=int(window))


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
    p = attention_probs(q, k, causal=causal, window=window, softcap=softcap)
    out = torch.einsum("bkgqs,bksd->bkgqd", p, v.to(torch.float32))
    return out.reshape(b, h, sq, d).to(q.dtype)


def attention_probs(q, k, *, causal: bool, window: int, softcap: float) -> torch.Tensor:
    """The plain version's f32 probabilities (B, KV, H/KV, Sq, Sk): the
    scores, softcap, mask and softmax, before the product with v."""
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
    return torch.softmax(s, dim=-1)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q (B, H, Sq, D), k, v (B, KV, Sk, D) → (B, H, Sq, D) in q's dtype,
    laid out like q.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    add one to ``flash_attention.launches``) or raise; fake tensors
    (a trace) go through the operator ``repro_torch::flash_attention``."""
    check_attention_args(q, k, v, window)
    if any(isinstance(t, DTensor) for t in (q, k, v)):
        raise TypeError("the flash kernel takes local tensors; a DTensor reached it "
                        "(run it on local shards through local_map)")
    traced = _library.traced(q)
    if q.device.type == "cpu" and not traced:
        return flash_attention_plain(q, k, v, causal=causal, window=window, softcap=softcap)
    if not (q.device.type == "cuda" or traced) or q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"the CUDA kernel takes f32/bf16 CUDA tensors, got "
                         f"{q.dtype} on {q.device}")
    b, h, sq, d = q.shape
    if not (b <= 65535 and h <= 65535):
        raise ValueError(f"batch {b} or heads {h} exceed the kernel's grid")
    if traced:
        return _FLASH_OP(q, k, v, bool(causal), int(window), float(softcap))
    return _launch(q, k, v, causal, window, softcap)


def _launch(q, k, v, causal, window, softcap) -> torch.Tensor:
    """The launch half of `flash_attention` (operands checked), reached
    directly or by the operator's CUDA implementation."""
    out = torch.empty_like(q)   # q's strides: (B, S, H, D) memory for a transposed view
    plan = plan_for(q, k, v, out, causal=causal, window=window)
    _build.launch_flash(q, k, v, out, plan, causal=causal, window=window,
                        scale=float(q.shape[-1]) ** -0.5, softcap=float(softcap))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def _plain_like_q(q, k, v, causal, window, softcap) -> torch.Tensor:
    """The operator's CPU implementation: the plain version, laid out like
    q as the kernel writes it."""
    out = torch.empty_like(q)
    return out.copy_(flash_attention_plain(q, k, v, causal=causal, window=window,
                                           softcap=softcap))


_FLASH_OP = _library.define(
    "flash_attention",
    "(Tensor q, Tensor k, Tensor v, bool causal, int window, float softcap) -> Tensor",
    cpu=_plain_like_q, cuda=_launch,
    fake=lambda q, k, v, causal, window, softcap: torch.empty_like(q))


class _FlashAttention(torch.autograd.Function):
    """Forward: the kernel (the plain version on the CPU). Backward: the VJP
    of the plain version. Its probabilities are recomputed under autograd;
    the product with v is differentiated by hand (dp = dout·vᵀ, dv = pᵀ·dout,
    in f32), so the backward never recomputes the output itself, which no
    gradient reads."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap)
        return flash_attention(q, k, v, **ctx.opts)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        b, h, sq, d = q.shape
        with torch.enable_grad():
            qg, kg = q.detach().requires_grad_(), k.detach().requires_grad_()
            p = attention_probs(qg, kg, **ctx.opts)
        g = dout.reshape(b, k.shape[1], h // k.shape[1], sq, d).to(torch.float32)
        vf = v.to(torch.float32)
        dp = torch.einsum("bkgqd,bksd->bkgqs", g, vf)
        dv = torch.einsum("bkgqs,bkgqd->bksd", p.detach(), g).to(v.dtype)
        dq, dk = torch.autograd.grad(p, (qg, kg), dp)
        return dq, dk, dv, None, None, None


def flash_attention_trainable(q, k, v, causal: bool = True, window: int = 0,
                              softcap: float = 0.0) -> torch.Tensor:
    """`flash_attention` with gradients (JAX's `flash_attention_trainable`)."""
    return _FlashAttention.apply(q, k, v, causal, window, softcap)
