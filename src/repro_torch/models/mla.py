"""Multi-head Latent Attention (DeepSeek-V2/V3), ported from
`repro.models.mla`.

Train and prefill use the naive expansion (latents → per-head K/V). Decode
and verify use the *absorbed* formulation: the cache stores only the
compressed latent (`kv_lora_rank`) and the decoupled RoPE key
(`qk_rope_dim`) per token, 576 values at deepseek-v3's widths, and W_UK /
W_UV are folded into the query and output sides. A chunked-prefill read
(`prefill_resume`) expands the cached latents through the quantized
`wkv_b` instead, so that its logits equal whole-prompt prefill's.

All five projections (wq_a, wq_b, wkv_a, wkv_b, wo) are quantizable
BitLinears served by the packed mpGeMM kernels. The cache has no
``slot_pos``: slot index doubles as position (index-as-position), so a
cache read masks by index. As in the port's attention, the cache is
updated in place; a write whose position passes the buffer end is
dropped, a negative (left-padding) position wraps onto the buffer's end
as JAX's scatter does, and its junk is masked until a real token
overwrites it.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.quantize import fake_ternary_cols
from repro_torch.dist.sharding import shard_act, write_rows

from .attention import NEG_INF, sdpa, tree_step_gate
from .common import (
    Linear,
    PackedLinear,
    QLinear,
    linear_apply,
    linear_init,
    rmsnorm_apply,
    rmsnorm_init,
    rope,
)
from .paged import page_scatter, page_view


def _dims(cfg):
    m = cfg.mla
    return m.q_lora_rank, m.kv_lora_rank, m.qk_nope_dim, m.qk_rope_dim, m.v_dim


class MLA(nn.Module):
    """The JAX parameter keys as attributes: the five BitLinears and the two
    latent norms."""

    def __init__(self, wq_a, q_norm, wq_b, wkv_a, kv_norm, wkv_b, wo):
        super().__init__()
        self.wq_a, self.q_norm, self.wq_b = wq_a, q_norm, wq_b
        self.wkv_a, self.kv_norm, self.wkv_b, self.wo = wkv_a, kv_norm, wkv_b, wo


def mla_init(cfg, spec, *, generator, device) -> MLA:
    ql, kvl, nope, rp, vd = _dims(cfg)
    h, d = cfg.n_heads, cfg.d_model
    kw = dict(generator=generator, device=device)
    wq_a = linear_init(d, ql, cfg, **kw)
    wq_b = linear_init(ql, h * (nope + rp), cfg, **kw)
    wkv_a = linear_init(d, kvl + rp, cfg, **kw)
    wkv_b = linear_init(kvl, h * (nope + vd), cfg, **kw)
    wo = linear_init(h * vd, d, cfg, **kw)
    return MLA(wq_a, rmsnorm_init(ql, device), wq_b, wkv_a, rmsnorm_init(kvl, device), wkv_b, wo)


def mla_cache_init(cfg, spec, batch: int, max_len: int, dtype, device,
                   page_size: int = 0, n_pages: int = 0) -> dict:
    """The latent cache: ``ckv`` (B, L, kv_lora_rank), ``krope`` (B, L,
    qk_rope_dim) and ``idx``. page_size > 0 builds the paged layout
    (models.paged): (n_pages + 1, page_size, ·) pools (page 0 the null page,
    page n_pages the write sink) and a block table. No slot_pos leaf: reads
    gather the logical view, where index-as-position holds, and stale
    latents of a recycled page sit at positions above every live query."""
    _, kvl, _, rp, _ = _dims(cfg)
    idx = torch.zeros((batch,), dtype=torch.int32, device=device)
    if page_size:
        return {
            "ckv": torch.zeros((n_pages + 1, page_size, kvl), dtype=dtype, device=device),
            "krope": torch.zeros((n_pages + 1, page_size, rp), dtype=dtype, device=device),
            "tab": torch.zeros((batch, max_len // page_size), dtype=torch.int32, device=device),
            "idx": idx,
        }
    return {
        "ckv": torch.zeros((batch, max_len, kvl), dtype=dtype, device=device),
        "krope": torch.zeros((batch, max_len, rp), dtype=dtype, device=device),
        "idx": idx,
    }


def spec_theta(cfg) -> float:
    return 10_000.0


def _latents(p: MLA, x, cfg, mode, positions):
    """→ (q_nope, q_rope, ckv_normed, k_rope) with RoPE applied."""
    ql, kvl, nope, rp, vd = _dims(cfg)
    b, s, _ = x.shape
    h = cfg.n_heads
    q = linear_apply(p.wq_b, rmsnorm_apply(p.q_norm, linear_apply(p.wq_a, x, mode),
                                           cfg.norm_eps), mode)
    q = q.reshape(b, s, h, nope + rp)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    kv_a = linear_apply(p.wkv_a, x, mode)
    ckv = rmsnorm_apply(p.kv_norm, kv_a[..., :kvl], cfg.norm_eps)
    k_rope = kv_a[..., kvl:][:, :, None, :]                          # (B,S,1,rp)
    q_rope = rope(q_rope, positions, spec_theta(cfg))
    k_rope = rope(k_rope, positions, spec_theta(cfg))[:, :, 0, :]
    return q_nope, q_rope, ckv, k_rope


def _wkv_b_dense(p: MLA, cfg, dtype) -> torch.Tensor:
    """Dense (kvl, H, nope+vd) view of wkv_b, unpacked transiently for the
    absorbed decode einsums (weight ≪ KV traffic at decode)."""
    ql, kvl, nope, rp, vd = _dims(cfg)
    h = cfg.n_heads
    lin = p.wkv_b
    if isinstance(lin, PackedLinear):
        pw = lin.pw
        w_scale = pw.scale if pw.scale.shape[-1] == pw.M else pw.scale.expand(pw.M)
        w = (pw.unpack().to(torch.float32) * w_scale[:, None]).T     # (kvl, M)
    elif isinstance(lin, QLinear):
        # the QAT fake-ternary numerics of the naive (prefill) path
        w = fake_ternary_cols(lin.qw).to(torch.float32)              # (kvl, M)
    else:
        assert isinstance(lin, Linear)
        w = lin.w.to(torch.float32)                                  # (kvl, M)
    return w.reshape(kvl, h, nope + vd).to(dtype)


def _expand_kv(p: MLA, ckv, cfg, mode):
    ql, kvl, nope, rp, vd = _dims(cfg)
    b, s, _ = ckv.shape
    kv = linear_apply(p.wkv_b, ckv, mode).reshape(b, s, cfg.n_heads, nope + vd)
    return kv[..., :nope], kv[..., nope:]                            # k_nope, v


def _write_dense(leaf: torch.Tensor, slots: torch.Tensor, values: torch.Tensor) -> None:
    """leaf[b, slots[b, i]] = values[b, i] in place, JAX's scatter with
    mode="drop": slots past the buffer end are dropped, negative ones wrap.
    A dropped column's wrapped slot is distinct from the row's kept ones
    (S <= L), so writing that slot's current content back is the drop, with
    no host sync."""
    length = leaf.shape[1]
    wrapped = torch.remainder(slots.long(), length)
    write_rows(leaf, wrapped, values.to(leaf.dtype), slots < length)


def mla_apply(p: MLA, x: torch.Tensor, *, cfg, spec, mode: str = "serve",
              cache: dict | None = None, verify: bool = False, tree=None,
              prefill_resume: bool = False):
    """→ (y, new_cache). cache=None: the no-cache (train/eval) forward.

    verify=True runs the absorbed-latent decode path for S > 1 incoming
    tokens (speculative verification) with a per-query causal position
    mask; without it, S > 1 with a cache is prefill (within the sequence).

    prefill_resume=True (verify, S > 1) is the chunked-prefill read: it
    expands the *cached* latents through the same quantized `wkv_b`
    BitLinear the naive prefill uses (activation scales are per token, so
    every cached row expands to the same K/V whatever else is in the
    buffer) and attends with the position-masked sdpa, so a chunk's logits
    equal whole-prompt prefill's, which the absorbed f32 einsums are not.
    It costs an expansion over the whole cache per chunk.

    tree (a `spec.tree.DraftTree`, verify only): node i is written to slot
    start+i but carries position start+depth(i), and inside the step's slot
    window the ancestor gate (`tree_step_gate`) replaces the
    index-as-position mask; the engine compacts the winning path back to
    slot == position before the next step.

    The cache is updated IN PLACE; the returned dict shares its tensors
    and carries the advanced idx."""
    ql, kvl, nope, rp, vd = _dims(cfg)
    b, s, _ = x.shape
    h = cfg.n_heads
    dev = x.device
    start = (cache["idx"] if cache is not None
             else torch.zeros((b,), dtype=torch.int32, device=dev))
    if tree is not None:
        from repro_torch.spec.tree import device_array

        offsets = device_array(tree, "depths", dev, torch.int32)
    else:
        offsets = torch.arange(s, dtype=torch.int32, device=dev)
    positions = start[:, None] + offsets[None, :]
    q_nope, q_rope, ckv, k_rope = _latents(p, x, cfg, mode, positions)

    new_cache = ckv_cached = krope_cached = None   # logical (B, L, ·) read views
    if cache is not None:
        if tree is not None:                        # one slot per tree node
            slots = start[:, None] + torch.arange(s, dtype=torch.int32, device=dev)
        else:
            slots = positions
        new_cache = dict(cache, idx=start + s)
        if "tab" in cache:
            # paged: writes map logical indices through the block table
            # (unmapped and out-of-range targets land in the sink), reads
            # gather the logical view, where index-as-position holds
            tab = cache["tab"]
            page_scatter(cache["ckv"], tab, slots, ckv)
            page_scatter(cache["krope"], tab, slots, k_rope)
            ckv_cached, krope_cached = page_view(cache["ckv"], tab), page_view(cache["krope"], tab)
        else:
            _write_dense(cache["ckv"], slots, ckv)
            _write_dense(cache["krope"], slots, k_rope)
            new_cache["ckv"] = shard_act(cache["ckv"], "kv_cache")
            new_cache["krope"] = shard_act(cache["krope"], "kv_cache")
            ckv_cached, krope_cached = new_cache["ckv"], new_cache["krope"]

    if cache is not None and verify and prefill_resume and s > 1:
        # ---- chunked-prefill resume: naive expansion over the cache ------
        k_nope, v = _expand_kv(p, ckv_cached, cfg, mode)
        length = ckv_cached.shape[1]
        k = torch.cat([k_nope, krope_cached[:, :, None, :].expand(b, length, h, rp)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        # index-as-position: slot i holds position i (the contiguous chunk
        # writes make every index <= a live query position real)
        kv_pos = torch.arange(length, dtype=torch.int32, device=dev)[None, :].expand(b, length)
        out = sdpa(q, k.to(q.dtype), v.to(q.dtype), positions, kv_pos, causal=True, window=0,
                   chunk=cfg.attn_chunk, dense_max=cfg.attn_dense_max)
    elif cache is not None and (s == 1 or verify):
        # ---- absorbed decode over the latent cache -----------------------
        wkv_b = _wkv_b_dense(p, cfg, torch.float32)                  # (kvl,H,nope+vd)
        w_uk, w_uv = wkv_b[..., :nope], wkv_b[..., nope:]
        ckv_all = ckv_cached.to(torch.float32)                       # (B,L,kvl)
        krope_all = krope_cached.to(torch.float32)                   # (B,L,rp)
        q_eff = torch.einsum("bqhd,khd->bqhk", q_nope.to(torch.float32), w_uk)
        scale = (nope + rp) ** -0.5
        scores = (torch.einsum("bqhk,bsk->bhqs", q_eff, ckv_all)
                  + torch.einsum("bqhd,bsd->bhqs", q_rope.to(torch.float32), krope_all)) * scale
        length = ckv_all.shape[1]
        kv_pos = torch.arange(length, dtype=torch.int32, device=dev)[None, :]
        valid = kv_pos[:, None, :] <= positions[:, :, None]         # (B,Sq,L)
        if tree is not None:
            # inside the step's slot window index-as-position means nothing
            # (an ancestor's slot can pass the query's depth-based position):
            # the ancestor gate replaces the mask there
            o = kv_pos - start[:, None]                              # (B, L)
            in_step = (o >= 0) & (o < s)
            valid = torch.where(in_step[:, None, :], tree_step_gate(tree, start, s, length), valid)
        scores = torch.where(valid[:, None, :, :], scores, NEG_INF)  # (B,H,Sq,L)
        probs = torch.softmax(scores, dim=-1)
        lat = torch.einsum("bhqs,bsk->bqhk", probs, ckv_all)
        out = torch.einsum("bqhk,khv->bqhv", lat, w_uv)             # (B,Sq,H,vd)
    else:
        # ---- naive expansion (train / prefill) ---------------------------
        k_nope, v = _expand_kv(p, ckv, cfg, mode)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, rp)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        out = sdpa(q, k.to(q.dtype), v.to(q.dtype), positions, positions, causal=True, window=0,
                   chunk=cfg.attn_chunk, dense_max=cfg.attn_dense_max)
    y = linear_apply(p.wo, out.reshape(b, s, h * vd).to(x.dtype), mode)
    return y, new_cache
