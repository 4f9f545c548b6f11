"""Mamba2 SSD (state-space duality) block, ported from `repro.models.ssm`:
a chunked scan for training and prefill, the O(1)-state recurrence for
decode.

The chunked scan follows the Mamba2 paper's "minimal SSD" formulation: a
sequential loop over chunks carries the state (the JAX package's
`lax.scan`), and within a chunk an attention-like (B, Q, Q, H) term mixes
the positions. `in_proj` and `out_proj` are quantizable BitLinears, served
by the packed mpGeMM kernels; the conv, the scan and the gated norm stay in
plain PyTorch, in the activations' dtype and f32 as in the JAX package.

The cache is ``conv`` (B, d_conv - 1, conv channels) in the cache dtype,
``state`` (B, H, P, N) f32 and ``idx`` (B,) int32. It holds recurrent
state, not per-position entries, so it can be neither rolled back nor
paged: the engine refuses speculation, chunked prefill and paging on SSM
layers, and admits prompts at their exact length (a left pad would enter
the state).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist.sharding import shard_act

from .common import _frozen, gated_rmsnorm_apply, linear_apply, linear_init, rmsnorm_init


class SSM(nn.Module):
    """The JAX parameter keys as attributes: the two BitLinears, the
    depthwise conv, the per-head decay, skip and dt bias (f32), and the
    gated norm."""

    def __init__(self, in_proj, conv_w, conv_b, A_log, D, dt_bias, norm, out_proj):
        super().__init__()
        self.in_proj, self.out_proj, self.norm = in_proj, out_proj, norm
        self.conv_w, self.conv_b = _frozen(conv_w), _frozen(conv_b)
        self.A_log, self.D, self.dt_bias = _frozen(A_log), _frozen(D), _frozen(dt_bias)


def _conv_channels(sc) -> int:
    return sc.d_inner + 2 * sc.n_groups * sc.d_state


def ssm_init(cfg, spec, *, generator, device) -> SSM:
    """dt is log-uniform in [dt_min, dt_max] per head and `dt_bias` its
    inverse softplus; A = -(1..H)."""
    sc = cfg.ssm
    d, di, n, h, g = cfg.d_model, sc.d_inner, sc.d_state, sc.n_heads, sc.n_groups
    kw = dict(generator=generator, device=device)
    in_proj = linear_init(d, 2 * di + 2 * g * n + h, cfg, **kw)
    conv_w = torch.randn((sc.d_conv, _conv_channels(sc)), dtype=torch.float32, **kw) * 0.1
    u = torch.rand((h,), dtype=torch.float32, **kw)
    dt = torch.exp(u * (math.log(sc.dt_max) - math.log(sc.dt_min)) + math.log(sc.dt_min))
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    out_proj = linear_init(di, d, cfg, **kw)
    f32 = dict(dtype=torch.float32, device=device)
    return SSM(in_proj, conv_w, torch.zeros((_conv_channels(sc),), **f32),
               torch.log(torch.arange(1, h + 1, **f32)), torch.ones((h,), **f32), dt_bias,
               rmsnorm_init(di, device), out_proj)


def ssm_cache_init(cfg, spec, batch: int, max_len: int, dtype, device,
                   page_size: int = 0, n_pages: int = 0) -> dict:
    """The recurrent state; the length and paging arguments are taken for
    the common cache-init signature (`block_cache_init` refuses paging on
    SSM layers before this is called)."""
    sc = cfg.ssm
    return {
        "conv": torch.zeros((batch, sc.d_conv - 1, _conv_channels(sc)), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, sc.n_heads, sc.head_dim, sc.d_state),
                             dtype=torch.float32, device=device),
        "idx": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, hist: torch.Tensor | None):
    """Depthwise causal conv1d with SiLU. x: (B, S, ch); w: (K, ch) f32;
    hist: (B, K-1, ch) or None (zeros). → (out in x's dtype, the last K-1
    inputs as the new history)."""
    kk, s = w.shape[0], x.shape[1]
    if hist is None:
        hist = torch.zeros((x.shape[0], kk - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([hist, x], dim=1)
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for k in range(kk):            # d_conv taps, in JAX's order
        acc = acc + xp[:, k:k + s].to(torch.float32) * w[k]
    out = F.silu(acc + b)
    # JAX writes two cases (s >= K-1: xp[:, s:]; else hist[:, s:] ++ x);
    # both are the last K-1 rows of hist ++ x
    return out.to(x.dtype), xp[:, s:]


def _split_zxbcdt(zxbcdt: torch.Tensor, sc):
    di, g, n = sc.d_inner, sc.n_groups, sc.d_state
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * g * n],
            zxbcdt[..., 2 * di + 2 * g * n:])


def _ssd_chunked(x, dt, a, b_mat, c_mat, chunk: int, h_init):
    """x: (B, S, H, P); dt: (B, S, H) f32, after the softplus; a: (H,) < 0;
    b_mat, c_mat: (B, S, H, N) (group-broadcast); h_init (B, H, P, N) f32.
    → (y (B, S, H, P) in x's dtype, h_final (B, H, P, N) f32).

    The tail is padded with zeros after the softplus: a padded step has
    dt = 0, so it neither decays the state nor adds to it."""
    s = x.shape[1]
    q = min(chunk, s)
    pad = (-s) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, 0, 0, pad))
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))[None, :, :, None]
    f32 = torch.float32
    h_prev, ys = h_init, []
    for c0 in range(0, s + pad, q):
        x_q, dt_q = x[:, c0:c0 + q], dt[:, c0:c0 + q]
        b_q, c_q = b_mat[:, c0:c0 + q].to(f32), c_mat[:, c0:c0 + q].to(f32)
        xf = x_q.to(f32)
        dacs = torch.cumsum(dt_q * a, dim=1)                          # (B,Q,H) <= 0
        # inter: the carried state's contribution
        y_inter = torch.einsum("bqhn,bhpn,bqh->bqhp", c_q, h_prev, torch.exp(dacs))
        # intra: the masked attention-like term. Above the diagonal the
        # exponent is positive and can overflow; it is masked to -inf before
        # the exp (same kept entries, and no inf * 0 in the backward) and the
        # product by torch.where, as in JAX (a 0/1 factor would give NaN)
        diff = dacs[:, :, None, :] - dacs[:, None, :, :]              # (B,Qi,Qj,H)
        decay = torch.exp(torch.where(mask, diff, -torch.inf))
        att = torch.einsum("bihn,bjhn->bijh", c_q, b_q) * decay * dt_q[:, None, :, :]
        att = torch.where(mask, att, 0.0)
        y_intra = torch.einsum("bijh,bjhp->bihp", att, xf)
        # state update
        da_tot = dacs[:, -1, :]                                       # (B,H)
        decay_end = torch.exp(da_tot[:, None, :] - dacs)              # (B,Q,H)
        h_prev = h_prev * torch.exp(da_tot)[:, :, None, None] + torch.einsum(
            "bqhn,bqhp,bqh->bhpn", b_q, xf, decay_end * dt_q)
        ys.append((y_inter + y_intra).to(x.dtype))
    return torch.cat(ys, dim=1)[:, :s], h_prev


def ssm_apply(p: SSM, u: torch.Tensor, *, cfg, spec, mode: str = "serve",
              cache: dict | None = None):
    """u: (B, S, d) → (out (B, S, d), new_cache or None). With a cache and
    S == 1 the recurrent decode step; otherwise the chunked scan, from the
    cached state when there is a cache (a prefill)."""
    sc = cfg.ssm
    bsz, s, _ = u.shape
    di, n, h, p_, g = sc.d_inner, sc.d_state, sc.n_heads, sc.head_dim, sc.n_groups
    z, xbc, dt_raw = _split_zxbcdt(linear_apply(p.in_proj, u, mode), sc)
    a = -torch.exp(p.A_log)                                           # (H,) < 0

    hist = cache["conv"].to(xbc.dtype) if cache is not None else None
    xbc, new_hist = _causal_conv(xbc, p.conv_w, p.conv_b, hist)
    x = xbc[..., :di].reshape(bsz, s, h, p_)
    b_mat = xbc[..., di:di + g * n].reshape(bsz, s, g, n)
    c_mat = xbc[..., di + g * n:].reshape(bsz, s, g, n)
    # jnp.repeat along the group axis: each group's B/C serves h/g
    # consecutive heads (repeat_interleave, not Tensor.repeat)
    b_h = torch.repeat_interleave(b_mat, h // g, dim=2)               # (B,S,H,N)
    c_h = torch.repeat_interleave(c_mat, h // g, dim=2)
    v = dt_raw.to(torch.float32) + p.dt_bias
    dt = torch.logaddexp(v, torch.zeros_like(v))     # jax.nn.softplus (no threshold)

    f32 = torch.float32
    if cache is not None and s == 1:
        # recurrent decode
        da = torch.exp(dt[:, 0] * a)                                  # (B,H)
        upd = torch.einsum("bhn,bhp,bh->bhpn", b_h[:, 0].to(f32), x[:, 0].to(f32), dt[:, 0])
        h_fin = cache["state"] * da[:, :, None, None] + upd
        y = torch.einsum("bhn,bhpn->bhp", c_h[:, 0].to(f32), h_fin)[:, None]   # (B,1,H,P)
    else:
        h_init = (cache["state"] if cache is not None
                  else torch.zeros((bsz, h, p_, n), dtype=f32, device=u.device))
        y, h_fin = _ssd_chunked(x, dt, a, b_h, c_h, sc.chunk, h_init)

    y = y.to(u.dtype) + x * p.D[:, None].to(u.dtype)
    y = gated_rmsnorm_apply(p.norm, y.reshape(bsz, s, di), z, cfg.norm_eps)
    out = linear_apply(p.out_proj, y, mode)

    new_cache = None
    if cache is not None:
        new_cache = {"conv": new_hist.to(cache["conv"].dtype),
                     "state": shard_act(h_fin, "ssm_state"), "idx": cache["idx"] + s}
    return out, new_cache
