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
`causal=False` makes either bidirectional (the enc-dec encoder).

The enc-dec decoder's cross-attention (`cross_attn_*`) attends the encoder
output's keys and values with `sdpa`, every position 0 and no causal mask;
a prefill computes them into the layer's cache (``xk``, ``xv``) and decode
steps reuse them.

A multi-token `verify` step (speculative verification, chunked prefill)
appends S tokens at per-slot positions and attends the whole cache; with a
draft `tree` the S tokens are a flattened `DraftTree` whose nodes sit in one
cache slot each and attend only their ancestors (`tree_step_gate`).

A paged cache (a dict carrying a block table ``tab``, see `models.paged`)
writes through the table into a physical page pool shared by every slot
and attends the gathered logical view with the same position-masked
`sdpa`.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.dist.sharding import fit_sharding, shard_act, write_rows
from repro_torch.kernels.flash_attention import flash_attention_trainable
from repro_torch.launch.mesh import axis_size, batch_axes, mesh_axes

from .common import linear_apply, linear_init, rmsnorm_apply, rmsnorm_init, rope
from .paged import page_phys, page_view, pool_pages

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
    qg = fit_sharding(q, 2, kv).reshape(b, sq, kv, g, d)
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
    from repro_torch.spec.tree import device_array

    anc = device_array(tree, "ancestors", start.device)                       # (S, S)
    o = (torch.arange(length, device=start.device)[None, :]
         - start[:, None].long())                                             # (B, L)
    in_step = (o >= 0) & (o < s)
    lookup = anc[:, o.clamp(0, s - 1)]                                        # (S, B, L)
    return torch.where(in_step[:, None, :], lookup.permute(1, 0, 2), True)


def split_heads(t: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """(..., n*d) → (..., n, d), a dim sharded unevenly over the n heads
    gathered first (`dist.sharding.fit_sharding`)."""
    t = fit_sharding(t, -1, n)
    return t.reshape(*t.shape[:-1], n, d)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(..., n, d) → (..., n*d), `split_heads`' inverse, an unevenly
    sharded heads dim gathered first."""
    n, d = t.shape[-2:]
    t = fit_sharding(t, -2, n)
    return t.reshape(*t.shape[:-2], n * d)


def _flash(q, k, v, causal: bool, window: int, softcap: float) -> torch.Tensor:
    """The flash kernel on (B, S, H, D) tensors, through transposed views.
    On DTensors (a no-cache forward under a mesh) each rank runs the kernel
    on its local block (`local_map`): batch over the batch axes and heads
    over ``model`` where they divide evenly (query and KV heads both, so a
    local query head keeps its KV head), every other dim whole; inputs
    placed otherwise are redistributed there first."""
    def run(q, k, v):
        return flash_attention_trainable(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                         causal, window, softcap).transpose(1, 2)

    if not isinstance(q, DTensor):
        return run(q, k, v)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    b, _, h, _ = q.shape
    nb, nm = axis_size(mesh, batch_axes(mesh)), axis_size(mesh, "model")
    heads = h % nm == 0 and k.shape[2] % nm == 0
    placements = tuple(
        Shard(0) if name in batch_axes(mesh) and b % nb == 0
        else Shard(2) if name == "model" and heads else Replicate()
        for name in mesh_axes(mesh))
    # DTensor views a local tensor by the global tensor's strides, so what
    # crosses local_map stays contiguous: the output, and the gradients of
    # q, k, v (the kernel's transposed layout otherwise)
    def local(q, k, v):
        return run(*(_ContiguousGrad.apply(t) for t in (q, k, v))).contiguous()

    return local_map(local, out_placements=(placements,), in_placements=(placements,) * 3,
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient is made contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


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


def attn_cache_init(cfg, spec, batch: int, max_len: int, dtype, device,
                    page_size: int = 0, n_pages: int = 0) -> dict:
    """Ring buffer of `window` slots for windowed layers, full buffer
    otherwise; `idx` is each slot's next write position.

    page_size > 0 switches to the paged layout (see models.paged): one
    physical (n_pages + 1, page_size, ...) pool shared across slots (page 0
    the read-safe null page, page n_pages the write sink) plus a per-slot
    block table. Windowed layers keep in-window history a page drop would
    lose — they are genuinely non-pageable and refused here."""
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    if page_size:
        if spec.window:
            raise ValueError(
                "windowed (ring-buffer) attention layers are not pageable: "
                "the ring overwrites in place, so page-granular ownership "
                "cannot represent their in-window history")
        return {
            "k": torch.zeros((n_pages + 1, page_size, kv, hd), dtype=dtype, device=device),
            "v": torch.zeros((n_pages + 1, page_size, kv, hd), dtype=dtype, device=device),
            "slot_pos": torch.full((n_pages + 1, page_size), -1, dtype=torch.int32,
                                   device=device),
            "tab": torch.zeros((batch, max_len // page_size), dtype=torch.int32, device=device),
            "idx": torch.zeros((batch,), dtype=torch.int32, device=device),
        }
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
    q = split_heads(linear_apply(p.wq, x, mode), h, hd)
    k = split_heads(linear_apply(p.wk, x, mode), kv, hd)
    v = split_heads(linear_apply(p.wv, x, mode), kv, hd)
    if cfg.qk_norm:
        q = rmsnorm_apply(p.q_norm, q, cfg.norm_eps)
        k = rmsnorm_apply(p.k_norm, k, cfg.norm_eps)
    if spec.rope_theta:
        q = rope(q, positions, spec.rope_theta)
        k = rope(k, positions, spec.rope_theta)
    return q, k, v


def attn_apply(p: Attention, x: torch.Tensor, *, cfg, spec, mode: str = "serve",
               cache: dict | None = None, causal: bool = True, verify: bool = False,
               tree=None):
    """Self-attention → (y, new_cache), causal unless `causal=False` (the
    enc-dec encoder's bidirectional layers). cache=None: no-cache
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

    A paged cache (with a block table ``tab``) writes logical slots through
    the table — `positions`, or idx+i for a tree's nodes — where unmapped
    and out-of-range targets land in the sink page, and a decode or verify
    step attends the gathered logical view.

    The cache is updated IN PLACE (its k/v/slot_pos tensors are written);
    the returned dict shares them and carries the advanced idx."""
    if verify and spec.window:
        raise ValueError(
            "multi-token verification needs a rollbackable cache; windowed "
            "(ring-buffer) layers would lose in-window history on rollback")
    b, s, _ = x.shape
    start = (cache["idx"] if cache is not None
             else torch.zeros((b,), dtype=torch.int32, device=x.device))
    if tree is not None:
        from repro_torch.spec.tree import device_array

        offsets = device_array(tree, "depths", x.device, torch.int32)
    else:
        offsets = torch.arange(s, dtype=torch.int32, device=x.device)
    positions = start[:, None] + offsets[None, :]
    q, k, v = _project_qkv(p, x, cfg, spec, mode, positions)
    attn = dict(causal=causal, window=spec.window, softcap=cfg.attn_logit_softcap,
                chunk=cfg.attn_chunk, dense_max=cfg.attn_dense_max)

    if cache is None:
        if cfg.attn_impl == "flash":
            out = _flash(q, k, v, causal, spec.window, cfg.attn_logit_softcap)
        else:
            out = sdpa(q, k, v, positions, positions, **attn)
        new_cache = None
    elif "tab" in cache:
        # ---- paged cache: physical page pool + per-slot block table ------
        # writes map logical indices through the table (one mapping serves
        # all three pools), reads attend the gathered logical view with the
        # same position-masked sdpa as the dense path
        tab, ck, cv, sp = cache["tab"], cache["k"], cache["v"], cache["slot_pos"]
        if tree is not None:
            # one slot per tree node (siblings share positions, not slots)
            slots = start[:, None] + torch.arange(s, dtype=torch.int32, device=x.device)
        else:
            slots = positions
        pg, off = page_phys(tab, slots, ck.shape[1], pool_pages(ck), for_write=True)
        ck[pg, off] = k.to(ck.dtype)
        cv[pg, off] = v.to(cv.dtype)
        sp[pg, off] = positions
        new_cache = {"k": ck, "v": cv, "slot_pos": sp, "tab": tab, "idx": start + s}
        if s == 1 or verify:
            vk, vv, vp = page_view(ck, tab), page_view(cv, tab), page_view(sp, tab)
            gate = tree_step_gate(tree, start, s, vk.shape[1]) if tree is not None else None
            out = sdpa(q, vk, vv, positions, vp, extra_mask=gate, **attn)
        else:
            # prefill: attend within the incoming sequence itself
            out = sdpa(q, k, v, positions, positions, **attn)
    else:
        ck, cv, sp = cache["k"], cache["v"], cache["slot_pos"]
        buf = ck.shape[1]
        bidx = torch.arange(b, device=x.device)[:, None]
        if s >= buf:
            # prefill longer than the buffer: keep the trailing `buf` tokens
            src = s - buf + torch.arange(buf, device=x.device)
            dst = torch.remainder(start[:, None].long() + src[None, :], buf)
            write_rows(ck, dst, bidx=bidx, values=k[:, src].to(ck.dtype))
            write_rows(cv, dst, bidx=bidx, values=v[:, src].to(cv.dtype))
            write_rows(sp, dst, bidx=bidx, values=positions[:, src])
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
            write_rows(ck, slots, kw, bidx=bidx)
            write_rows(cv, slots, vw, bidx=bidx)
            write_rows(sp, slots, pw, bidx=bidx)
        new_cache = {"k": shard_act(ck, "kv_cache"), "v": shard_act(cv, "kv_cache"),
                     "slot_pos": sp, "idx": start + s}
        if s == 1 or verify:
            # decode / verify: attend the whole cache (it already holds the
            # incoming tokens), in the cache's dtype; causality comes from
            # the position mask, plus the ancestor gate over a tree's slots
            gate = tree_step_gate(tree, start, s, buf) if tree is not None else None
            out = sdpa(q, ck, cv, positions, sp, extra_mask=gate, **attn)
        else:
            # prefill: attend within the incoming (fresh) sequence itself
            out = sdpa(q, k, v, positions, positions, **attn)
    return linear_apply(p.wo, merge_heads(out), mode), new_cache


# --------------------------------------------------------------------------
# Cross-attention (enc-dec decoder layers)
# --------------------------------------------------------------------------
def cross_attn_init(cfg, *, generator, device) -> Attention:
    h, kv, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    kw = dict(generator=generator, device=device)
    return Attention(
        linear_init(d, h * hd, cfg, **kw), linear_init(d, kv * hd, cfg, **kw),
        linear_init(d, kv * hd, cfg, **kw), linear_init(h * hd, d, cfg, **kw),
    )


def cross_attn_kv(p: Attention, enc_out: torch.Tensor, cfg, mode: str):
    """The encoder output's keys and values, (B, S_enc, KV, D) each: a
    prefill computes them once into the cache, decode steps reuse them."""
    b, se, _ = enc_out.shape
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    k = split_heads(linear_apply(p.wk, enc_out, mode), kv, hd)
    v = split_heads(linear_apply(p.wv, enc_out, mode), kv, hd)
    return k, v


def cross_attn_apply(p: Attention, x: torch.Tensor, k, v, cfg, mode: str) -> torch.Tensor:
    """Every query attends every encoder position: all positions 0 and
    causal=False, so the mask is all true."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    q = split_heads(linear_apply(p.wq, x, mode), h, hd)
    q_pos = torch.zeros((b, s), dtype=torch.int32, device=x.device)
    kv_pos = torch.zeros((b, k.shape[1]), dtype=torch.int32, device=x.device)
    out = sdpa(q, k, v, q_pos, kv_pos, causal=False, window=0,
               chunk=cfg.attn_chunk, dense_max=cfg.attn_dense_max)
    return linear_apply(p.wo, merge_heads(out), mode)
