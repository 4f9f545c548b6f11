"""Feed-forward layers (ported from `repro.models.moe`): the dense SwiGLU
FFN and the Mixture-of-Experts FFN — top-k routing, capacity-based
dispatch, shared experts and DeepSeek-style aux-loss-free bias routing.

Dispatch is scatter-based, as in the JAX package: each token's position in
its expert comes from a cumsum over the token axis, the kept tokens are
written into an (E, C, d) buffer (the dropped ones into a sink row cut off
after the scatter, so the layer never waits on the host), the three
stacked expert BitLinears run on the whole buffer (`linear_batched_apply`:
one grouped mpGeMM launch per packed segment on the serving path), and the
rows are gathered back and combined with the renormalized gates. Capacity overflow drops tokens to the
residual stream (GShard semantics). Positions are block-local over
`n_blocks` token blocks: by default one, or under a sharding context with
``cfg.moe_block_dispatch`` one a batch shard (`dist.sharding.dispatch_blocks`),
so the scatter and gather never cross the data axis.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.dist.sharding import (
    dispatch_blocks,
    fit_sharding,
    flatten_tokens,
    shard_act,
    unstrided,
)
from repro_torch.launch.mesh import axis_size, batch_axes, mesh_axes

from .common import Linear, linear_apply, linear_batched_apply, linear_init


class DenseFFN(nn.Module):
    """A SwiGLU FFN's three linears; stacked linears make a MoE layer's
    experts."""

    def __init__(self, w1: nn.Module, w3: nn.Module, w2: nn.Module):
        super().__init__()
        self.w1, self.w3, self.w2 = w1, w3, w2


def dense_ffn_init(cfg, d_ff: int | None = None, *, generator, device) -> DenseFFN:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    kw = dict(generator=generator, device=device)
    return DenseFFN(linear_init(d, f, cfg, **kw), linear_init(d, f, cfg, **kw),
                    linear_init(f, d, cfg, **kw))


def dense_ffn_apply(p: DenseFFN, x: torch.Tensor, mode: str = "serve") -> torch.Tensor:
    h = F.silu(linear_apply(p.w1, x, mode)) * linear_apply(p.w3, x, mode)
    return linear_apply(p.w2, h, mode)


class MoEFFN(nn.Module):
    """The JAX parameter keys as attributes: ``router.w`` (d, E) f32,
    ``router_bias`` (E,) f32 (aux-free routing only), ``experts.w1|w3|w2``
    (stacked (E, ...)) and ``shared.w1|w3|w2`` (shared experts only)."""

    def __init__(self, router: Linear, experts: DenseFFN,
                 router_bias: torch.Tensor | None = None, shared: DenseFFN | None = None):
        super().__init__()
        self.router, self.experts, self.shared = router, experts, shared
        self.router_bias = (None if router_bias is None
                            else nn.Parameter(router_bias, requires_grad=False))


def moe_init(cfg, *, generator, device) -> MoEFFN:
    mc = cfg.moe
    d, e = cfg.d_model, mc.n_experts
    kw = dict(generator=generator, device=device)
    # the router stays f32 whatever cfg.dtype (small, accuracy-critical)
    router = Linear(torch.randn((d, e), generator=generator, device=device,
                                dtype=torch.float32) * 0.02)
    f = mc.d_ff_expert
    experts = DenseFFN(linear_init(d, f, cfg, experts=e, **kw),
                       linear_init(d, f, cfg, experts=e, **kw),
                       linear_init(f, d, cfg, experts=e, **kw))
    bias = torch.zeros((e,), dtype=torch.float32, device=device) if mc.router_aux_free else None
    shared = None
    if mc.n_shared:
        shared = dense_ffn_init(cfg, (mc.d_ff_shared or mc.d_ff_expert) * mc.n_shared, **kw)
    return MoEFFN(router, experts, bias, shared)


def top_k_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """The k largest scores' indices per row, ties toward lower ids (the
    first k of a stable descending sort), as `jax.lax.top_k` picks them."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :k]


def capacity(tokens: int, cfg) -> int:
    """Rows per expert for a block of `tokens` tokens: the capacity factor's
    share, but never below min(tokens * k, 16), so that decode-sized
    batches are dropless (the JAX expression, float floor division
    included)."""
    mc = cfg.moe
    k, e = mc.top_k, mc.n_experts
    return max(-(-tokens * k * mc.capacity_factor // e).__int__(), min(tokens * k, 16), 1)


def _route_dispatch(xt, sel_scores, gate_probs, *, e: int, k: int, nb: int, cap: int):
    """Top-k routing and the block-local scatter of `xt`'s T tokens, in `nb`
    blocks of T/nb → (buf (nb, E, C, d), eidx, cidx, kept (nb, T/nb·k),
    top_p (T, k) renormalized gates, top_idx (T, k))."""
    t, d = xt.shape
    top_idx = top_k_indices(sel_scores, k)                          # (T, k)
    top_p = torch.gather(gate_probs, -1, top_idx)                   # (T, k)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)

    # ---- block-local capacity + position-in-expert ------------------------
    tb = t // nb
    flat = F.one_hot(top_idx, e).reshape(nb, tb * k, e)             # token-major, k inner
    pos = torch.cumsum(flat, dim=1) - 1
    pos = (pos * flat).sum(-1).reshape(t, k)                        # (T, k)
    keep = pos < cap

    # ---- block-local scatter into the (nb, E, C, d) buffer ----------------
    # The kept (block, expert, position) triples are unique, so their rows
    # are written deterministically; the dropped ones all go to a sink row
    # C past the buffer, cut off after the scatter (torch has no dropping
    # scatter; the JAX package adds zeroed rows at a clipped position). No
    # host sync: nothing depends on how many tokens are kept.
    eidx = top_idx.reshape(nb, tb * k)
    cidx = torch.clamp(pos.reshape(nb, tb * k), 0, cap - 1)
    kept = keep.reshape(nb, tb * k)
    bidx = torch.arange(nb, device=xt.device)[:, None].expand(nb, tb * k)
    src = xt.repeat_interleave(k, dim=0).reshape(nb, tb * k, d)
    buf = xt.new_zeros((nb, e, cap + 1, d)).index_put(
        (bidx, eidx, torch.where(kept, cidx, cap)), src)[:, :, :cap]
    return buf, eidx, cidx, kept, top_p, top_idx


def _combine(eo_b, eidx, cidx, kept, top_p):
    """Block-local gather of each token's k expert rows from eo_b (nb, E, C,
    d), weighted by its gates and summed → (T, d)."""
    nb, d = eo_b.shape[0], eo_b.shape[-1]
    t, k = top_p.shape
    bidx = torch.arange(nb, device=eo_b.device)[:, None].expand_as(eidx)
    back = eo_b[bidx, eidx, cidx] * kept[..., None].to(eo_b.dtype)  # (nb, tb*k, d)
    back = back.reshape(t, k, d) * top_p[..., None].to(eo_b.dtype)
    return back.sum(1)


def _token_placements(mesh, nb: int) -> tuple:
    """The token axis's placements for the mesh path: sharded over the
    batch axes, one dispatch block a shard (nb > 1), or whole (nb = 1:
    global positions need every token)."""
    from torch.distributed.tensor import Replicate, Shard

    batch = batch_axes(mesh)
    if nb == 1:
        return tuple(Replicate() for _ in mesh_axes(mesh))
    if nb != axis_size(mesh, batch):
        raise ValueError(f"{nb} dispatch blocks on a mesh with {axis_size(mesh, batch)} "
                         "batch shards: block-local dispatch needs one block a shard")
    return tuple(Shard(0) if n in batch else Replicate() for n in mesh_axes(mesh))


def _dispatch_mesh(xt, sel_scores, gate_probs, *, e: int, k: int, nb: int, cap: int):
    """`_route_dispatch` on DTensors: each rank routes and scatters its own
    block of tokens (`local_map`; DTensor has no sharding rule for the
    sort, cumsum and index_put), the router's product and softmax staying
    DTensor ops so its weight's gradient is reduced. → (buf, eidx, cidx,
    kept, top_p, counts (E,) f32 tokens per expert over all T·k picks)."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = xt.device_mesh
    tok = _token_placements(mesh, nb)
    counts = tuple(Partial() if pl != Replicate() else pl for pl in tok)

    def local(x, sel, gp):
        buf, eidx, cidx, kept, top_p, top_idx = _route_dispatch(
            x, sel, gp, e=e, k=k, nb=1 if nb > 1 else nb, cap=cap)
        return (buf, eidx, cidx, kept, top_p,
                F.one_hot(top_idx, e).to(torch.float32).sum((0, 1)))

    return local_map(local, out_placements=(tok,) * 5 + (counts,), in_placements=(tok,) * 3,
                     device_mesh=mesh, redistribute_inputs=True)(xt, sel_scores, gate_probs)


def _combine_mesh(eo_b, eidx, cidx, kept, top_p, nb: int):
    """`_combine` on each rank's own block (`local_map`)."""
    from torch.distributed.tensor.experimental import local_map

    mesh = eo_b.device_mesh
    tok = _token_placements(mesh, nb)
    return local_map(_combine, out_placements=(tok,), in_placements=(tok,) * 5,
                     device_mesh=mesh, redistribute_inputs=True)(eo_b, eidx, cidx, kept, top_p)


def moe_apply(p: MoEFFN, x: torch.Tensor, cfg, mode: str = "serve",
              n_blocks: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) → (out, aux_loss f32 scalar). Dispatch positions are
    block-local over `n_blocks` token blocks (default: the batch shard
    count under a sharding context with ``cfg.moe_block_dispatch``, else
    1, `dist.sharding.dispatch_blocks`); aux is the load-balance plus
    router z-loss in 'train' mode without aux-free routing, else 0.

    On DTensors (under a mesh) each rank dispatches and combines its own
    token block and the expert buffer is laid out expert-parallel
    (``moe_buf``: experts over ``model``), the activation constraints of
    the JAX package's layer."""
    mc = cfg.moe
    b, s, d = x.shape
    t = b * s
    xt = flatten_tokens(x)
    e, k = mc.n_experts, mc.top_k
    nb = n_blocks if n_blocks is not None else dispatch_blocks(t)
    mesh = isinstance(xt, DTensor)

    logits = xt.to(torch.float32) @ p.router.w                      # (T, E)
    gate_probs = torch.softmax(logits, dim=-1)
    sel_scores = logits + p.router_bias if mc.router_aux_free else logits
    cap = capacity(t // nb, cfg)
    if mesh:
        buf, eidx, cidx, kept, top_p, counts = _dispatch_mesh(
            xt, sel_scores, gate_probs, e=e, k=k, nb=nb, cap=cap)
    else:
        buf, eidx, cidx, kept, top_p, top_idx = _route_dispatch(
            xt, sel_scores, gate_probs, e=e, k=k, nb=nb, cap=cap)
    buf = shard_act(buf, "moe_buf_blocked")
    # EP layout: experts on 'model', blocks on ('pod', 'data')
    buf = shard_act(buf.transpose(0, 1).reshape(e, nb * cap, d), "moe_buf")

    # ---- expert computation (batched BitLinear mpGeMMs) ------------------
    h = (F.silu(linear_batched_apply(p.experts.w1, buf, mode))
         * linear_batched_apply(p.experts.w3, buf, mode))
    eo = shard_act(linear_batched_apply(p.experts.w2, h, mode), "moe_buf")  # (E, nb*C, d)

    # ---- block-local gather back + combine --------------------------------
    eo_b = shard_act(eo.reshape(e, nb, cap, d).transpose(0, 1), "moe_buf_blocked")
    out = (_combine_mesh(eo_b, eidx, cidx, kept, top_p, nb) if mesh
           else _combine(eo_b, eidx, cidx, kept, top_p))

    if p.shared is not None:
        out = out + dense_ffn_apply(p.shared, xt, mode)

    # ---- aux losses (train only; 0 with aux-free routing) -----------------
    if mode == "train" and not mc.router_aux_free:
        me = gate_probs.mean(0)                                     # (E,)
        if not mesh:
            counts = F.one_hot(top_idx, e).to(torch.float32).sum((0, 1))
        frac = counts / (t * k)
        aux = mc.aux_loss_weight * e * (frac * me).sum()
        zloss = mc.router_z_weight * torch.logsumexp(logits, dim=-1).square().mean()
        aux = aux + zloss
    else:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return fit_sharding(unstrided(out), 0, b).reshape(b, s, d).to(x.dtype), aux
