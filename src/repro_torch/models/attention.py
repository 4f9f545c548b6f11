"""Grouped-query attention with RoPE over a dense per-slot KV cache (ported
from `repro.models.attention`).

Positions are explicit everywhere: masks derive from absolute positions
(`q_pos`, `kv_pos`), with `kv_pos < 0` marking invalid cache slots, so
left-padded prompts (negative pad positions) and per-slot write positions
need no other bookkeeping. `sdpa` is plain tensor code with the JAX
package's rounding points (f32 scores, -1e30 masking, probabilities cast to
the value dtype), not `F.scaled_dot_product_attention`.

The no-cache (train/eval) forward runs `sdpa` or, with
``cfg.attn_impl == "flash"``, the flash-attention kernel on transposed views
of the (B, S, H, D) tensors (the kernel reads strides: no copies).

A multi-token `verify` step (speculative verification, chunked prefill)
appends S tokens at per-slot positions and attends the whole cache; with a
draft `tree` the S tokens are a flattened `DraftTree` whose nodes sit in one
cache slot each and attend only their ancestors (`tree_step_gate`).

Not ported yet: the paged cache.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.flash_attention import flash_attention_trainable

from .common import linear_apply, linear_init, rmsnorm_apply, rmsnorm_init, rope

NEG_INF = -1e30


# --------------------------------------------------------------------------
# Scaled dot-product attention over explicit positions
# --------------------------------------------------------------------------
def _mask(q_pos, kv_pos, causal: bool, window: int) -> torch.Tensor:
    """(B, Sq, Skv) bool."""
    m = (kv_pos[:, None, :] >= 0).expand(-1, q_pos.shape[1], -1)
    if causal:
        m = m & (kv_pos[:, None, :] <= q_pos[:, :, None])
    if window:
        m = m & (q_pos[:, :, None] - kv_pos[:, None, :] < window)
    return m


def _scores(q, k, scale: float, softcap: float) -> torch.Tensor:
    s = torch.einsum("bqkgd,bskd->bkgqs", q.to(torch.float32), k.to(torch.float32)) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    return s


def sdpa(q, k, v, q_pos, kv_pos, *, causal: bool = True, window: int = 0,
         softcap: float = 0.0, chunk: int = 512, dense_max: int = 2048,
         extra_mask: torch.Tensor | None = None) -> torch.Tensor:
    """q (B, Sq, H, D); k, v (B, Skv, KV, D); q_pos (B, Sq); kv_pos (B, Skv),
    negative = invalid slot; extra_mask (B, Sq, Skv) bool is ANDed into the
    position mask → (B, Sq, H, Dv)."""
    b, sq, h, d = q.shape
    dv = v.shape[-1]
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, sq, kv, g, d)
    scale = d ** -0.5

    if k.shape[1] <= dense_max or k.shape[1] % chunk:
        s = _scores(qg, k, scale, softcap)                       # (B,KV,G,Sq,Skv)
        m = _mask(q_pos, kv_pos, causal, window)
        if extra_mask is not None:
            m = m & extra_mask
        s = torch.where(m[:, None, None], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        # p is rounded to v's dtype, the product accumulated in f32 and
        # rounded once to v's dtype, as XLA computes a low-precision einsum
        out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).to(torch.float32),
                           v.to(torch.float32)).to(v.dtype)
        return out.reshape(b, sq, h, dv)

    # ---- online softmax over KV chunks -----------------------------------
    m_run = torch.full((b, kv, g, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l_run = torch.zeros((b, kv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kv, g, sq, dv), dtype=torch.float32, device=q.device)
    for c0 in range(0, k.shape[1], chunk):
        kc, vc = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        s = _scores(qg, kc, scale, softcap)                      # (B,KV,G,Sq,c)
        msk = _mask(q_pos, kv_pos[:, c0:c0 + chunk], causal, window)
        if extra_mask is not None:
            msk = msk & extra_mask[:, :, c0:c0 + chunk]
        s = torch.where(msk[:, None, None], s, NEG_INF)
        m_new = torch.maximum(m_run, s.amax(-1))
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(s - m_new[..., None])
        l_run = l_run * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p, vc.to(torch.float32))
        m_run = m_new
    out = acc / torch.clamp_min(l_run, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv).to(q.dtype)


def tree_step_gate(tree, start: torch.Tensor, s: int, length: int) -> torch.Tensor:
    """(B, S, L) bool gate ANDed into a tree-verify step's attention mask.

    The step's S tokens are a flattened draft tree (`spec.tree.DraftTree`)
    in cache slots start..start+S-1, node i at slot start+i, while their
    positions are start+depth(i), shared between siblings. Inside that slot
    window a node attends only its ancestors (itself included); outside it
    the gate is True and the position mask stands alone."""
    anc = torch.as_tensor(tree.ancestors, device=start.device)               # (S, S)
    o = (torch.arange(length, device=start.device)[None, :]
         - start[:, None].long())                                             # (B, L)
    in_step = (o >= 0) & (o < s)
    lookup = anc[:, o.clamp(0, s - 1)]                                        # (S, B, L)
    return torch.where(in_step[:, None, :], lookup.permute(1, 0, 2), True)


# --------------------------------------------------------------------------
# GQA layer
# --------------------------------------------------------------------------
class Attention(nn.Module):
    def __init__(self, wq, wk, wv, wo, q_norm=None, k_norm=None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo
        self.q_norm, self.k_norm = q_norm, k_norm


def attn_init(cfg, spec, *, generator, device) -> Attention:
    h, kv, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    kw = dict(generator=generator, device=device)
    norms = (rmsnorm_init(hd, device), rmsnorm_init(hd, device)) if cfg.qk_norm else (None, None)
    return Attention(
        linear_init(d, h * hd, cfg, **kw), linear_init(d, kv * hd, cfg, **kw),
        linear_init(d, kv * hd, cfg, **kw), linear_init(h * hd, d, cfg, **kw),
        *norms,
    )


def attn_cache_init(cfg, spec, batch: int, max_len: int, dtype, device) -> dict:
    """Ring buffer of `window` slots for windowed layers, full buffer
    otherwise; `idx` is each slot's next write position."""
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    buf = min(spec.window, max_len) if spec.window else max_len
    return {
        "k": torch.zeros((batch, buf, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, buf, kv, hd), dtype=dtype, device=device),
        "slot_pos": torch.full((batch, buf), -1, dtype=torch.int32, device=device),
        "idx": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def _project_qkv(p: Attention, x, cfg, spec, mode, positions):
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = linear_apply(p.wq, x, mode).reshape(b, s, h, hd)
    k = linear_apply(p.wk, x, mode).reshape(b, s, kv, hd)
    v = linear_apply(p.wv, x, mode).reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = rmsnorm_apply(p.q_norm, q, cfg.norm_eps)
        k = rmsnorm_apply(p.k_norm, k, cfg.norm_eps)
    if spec.rope_theta:
        q = rope(q, positions, spec.rope_theta)
        k = rope(k, positions, spec.rope_theta)
    return q, k, v


def attn_apply(p: Attention, x: torch.Tensor, *, cfg, spec, mode: str = "serve",
               cache: dict | None = None, verify: bool = False, tree=None):
    """Causal self-attention → (y, new_cache). cache=None: no-cache
    (train/eval) forward.
    Otherwise prefill (S>1: writes the cache from position cache["idx"] and
    attends within the incoming sequence) or decode (S==1: appends and
    attends the whole cache).

    verify=True is the multi-token decode step: the S tokens are appended at
    positions idx..idx+S-1 and attend the whole cache (prior context and
    themselves, position-causal). A column whose position passes the buffer
    end (a chunked prefill's padded tail, a decode row's pad columns) is
    dropped, never wrapped onto the slot's early K/V. With `tree` (a
    `DraftTree`, verify only) node i is written to slot idx+i (modulo the
    buffer) with position idx+depth(i) and attends its ancestors only.

    The cache is updated IN PLACE (its k/v/slot_pos tensors are written);
    the returned dict shares them and carries the advanced idx."""
    if verify and spec.window:
        raise ValueError(
            "multi-token verification needs a rollbackable cache; windowed "
            "(ring-buffer) layers would lose in-window history on rollback")
    if cache is not None and "tab" in cache:
        raise NotImplementedError("the paged KV cache is not ported yet")
    b, s, _ = x.shape
    start = (cache["idx"] if cache is not None
             else torch.zeros((b,), dtype=torch.int32, device=x.device))
    if tree is not None:
        offsets = torch.as_tensor(tree.depths, dtype=torch.int32, device=x.device)
    else:
        offsets = torch.arange(s, dtype=torch.int32, device=x.device)
    positions = start[:, None] + offsets[None, :]
    q, k, v = _project_qkv(p, x, cfg, spec, mode, positions)
    attn = dict(causal=True, window=spec.window, softcap=cfg.attn_logit_softcap,
                chunk=cfg.attn_chunk, dense_max=cfg.attn_dense_max)

    if cache is None:
        if cfg.attn_impl == "flash":
            out = flash_attention_trainable(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), True,
                spec.window, cfg.attn_logit_softcap,
            ).transpose(1, 2)
        else:
            out = sdpa(q, k, v, positions, positions, **attn)
        new_cache = None
    else:
        ck, cv, sp = cache["k"], cache["v"], cache["slot_pos"]
        buf = ck.shape[1]
        bidx = torch.arange(b, device=x.device)[:, None]
        if s >= buf:
            # prefill longer than the buffer: keep the trailing `buf` tokens
            src = s - buf + torch.arange(buf, device=x.device)
            dst = torch.remainder(start[:, None].long() + src[None, :], buf)
            ck[bidx, dst] = k[:, src].to(ck.dtype)
            cv[bidx, dst] = v[:, src].to(cv.dtype)
            sp[bidx, dst] = positions[:, src]
        else:
            # torch.remainder follows the sign of the divisor, as jnp's %,
            # so negative pad positions wrap into [0, buf) (and stay masked
            # by their negative slot_pos). A tree's nodes take one slot each
            # (siblings share a position, not a slot).
            if tree is not None:
                slots = torch.remainder(
                    start[:, None].long() + torch.arange(s, device=x.device), buf)
            else:
                slots = torch.remainder(positions.long(), buf)
            kw, vw, pw = k.to(ck.dtype), v.to(cv.dtype), positions
            if verify and tree is None:
                # the JAX scatter's mode="drop": columns past the buffer end
                # are dropped. Their wrapped slots are distinct from the
                # row's in-range ones (S < buf), so writing those slots'
                # current contents back is exactly a drop, with no host sync.
                keep = positions < buf
                kw = torch.where(keep[..., None, None], kw, ck[bidx, slots])
                vw = torch.where(keep[..., None, None], vw, cv[bidx, slots])
                pw = torch.where(keep, pw, sp[bidx, slots])
            ck[bidx, slots] = kw
            cv[bidx, slots] = vw
            sp[bidx, slots] = pw
        new_cache = {"k": ck, "v": cv, "slot_pos": sp, "idx": start + s}
        if s == 1 or verify:
            # decode / verify: attend the whole cache (it already holds the
            # incoming tokens), in the cache's dtype; causality comes from
            # the position mask, plus the ancestor gate over a tree's slots
            gate = tree_step_gate(tree, start, s, buf) if tree is not None else None
            out = sdpa(q, ck, cv, positions, sp, extra_mask=gate, **attn)
        else:
            # prefill: attend within the incoming (fresh) sequence itself
            out = sdpa(q, k, v, positions, positions, **attn)
    b_, s_, h, hd = out.shape
    return linear_apply(p.wo, out.reshape(b_, s_, h * hd), mode), new_cache
