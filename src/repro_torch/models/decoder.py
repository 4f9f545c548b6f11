"""Decoder-only LM, its training loss and its serving entry points (ported
from `repro.models.decoder`).

The JAX package scans stacked "stages" of repeated layers; here the layers
are an `nn.ModuleList` walked by a Python loop, and the KV cache is a list
with one dict per layer. With ``cfg.remat`` each layer of a no-cache forward
under autograd is recomputed in backward (`torch.utils.checkpoint`, the
JAX "full" policy). The cross-entropy is computed in sequence chunks of
``cfg.loss_chunk`` (never the full (B, S, V) logits at once). Entry points
keep the JAX names: `lm_hidden`, `lm_logits`, `lm_loss`, `init_cache`,
`prefill`, `decode_step`, `verify_step`, `prefill_bucket`,
`prefill_into_slot`, `scatter_slot_cache`, `reset_slot_idx`,
`compact_tree_cache`, `rollback_cache`.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device

from .blocks import block_apply, block_cache_init, block_init
from .common import Linear, embed_apply, embed_init, linear_init, rmsnorm_apply, rmsnorm_init


class LM(nn.Module):
    def __init__(self, embed, layers, final_norm, head=None):
        super().__init__()
        self.embed = embed
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        self.head = head


def init_lm(cfg, generator: torch.Generator) -> LM:
    """Random weights drawn from `generator`, on its device (dense "qw"
    linears: pack them with `pack_params` before serving)."""
    device = resolve_device(generator.device)
    kw = dict(generator=generator, device=device)
    head = (None if cfg.tie_embeddings
            else linear_init(cfg.d_model, cfg.vocab, cfg, quant=False, **kw))
    return LM(
        embed_init(cfg.vocab, cfg.d_model, cfg, **kw),
        [block_init(cfg, spec, **kw) for spec in cfg.layer_specs()],
        rmsnorm_init(cfg.d_model, device),
        head,
    )


def compress_layout(specs, max_period: int = 8) -> list[tuple[tuple, int]]:
    """Greedy factorization of the layer list into (pattern, repeats) runs:
    the JAX package's stage layout (a copy of its `compress_layout`)."""
    stages: list[tuple[tuple, int]] = []
    i, n = 0, len(specs)
    while i < n:
        best_p, best_r = 1, 1
        for p in range(1, min(max_period, n - i) + 1):
            r = 1
            while (
                i + (r + 1) * p <= n
                and tuple(specs[i + r * p: i + (r + 1) * p]) == tuple(specs[i: i + p])
            ):
                r += 1
            if r * p > best_p * best_r or (r * p == best_p * best_r and p < best_p):
                best_p, best_r = p, r
        stages.append((tuple(specs[i: i + best_p]), best_r))
        i += best_p * best_r
    return stages


def stacked_shapes(model: LM, cfg) -> dict[str, tuple]:
    """Each parameter's shape in the JAX package's stacked-stage layout: a
    per-layer parameter gains its stage's repeat count as a leading axis.
    The optimizer's and the gradient compression's per-leaf rules (weight
    decay on ndim >= 2, int8 state for >= 4096 elements) read these, so
    they pick the same leaves as in JAX (a 32-layer stage's norm scales
    are one (32, d) leaf there)."""
    reps, layer = {}, 0
    for pattern, r in compress_layout(cfg.layer_specs()):
        for i in range(r * len(pattern)):
            reps[layer + i] = r
        layer += r * len(pattern)
    out = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        out[name] = (reps[int(parts[1])], *p.shape) if parts[0] == "layers" else tuple(p.shape)
    return out


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, *,
               device="cuda") -> list[dict]:
    """One dense cache dict per layer. The default dtype is bf16 whatever
    the model's dtype, as in the JAX package (decode attention then runs in
    bf16, and the `wo` BitLinear sees bf16 activations)."""
    device = resolve_device(device)
    return [block_cache_init(cfg, spec, batch, max_len, dtype, device)
            for spec in cfg.layer_specs()]


def _remat(cfg, cache) -> bool:
    if not (cfg.remat and cache is None and torch.is_grad_enabled()):
        return False
    if cfg.remat_policy != "full":
        raise NotImplementedError(
            f"remat_policy={cfg.remat_policy!r} is not ported yet; only 'full'")
    return True


def _block_out(layer, x, *, cfg, spec, mode):
    return block_apply(layer, x, cfg=cfg, spec=spec, mode=mode)[0]


def lm_hidden(model: LM, tokens: torch.Tensor, cfg, *, mode: str = "train",
              cache: list | None = None, verify: bool = False, tree=None,
              prefill_resume: bool = False):
    """tokens: int (B, S) → (hidden (B, S, d), new_cache). verify=True: the
    S tokens are a multi-token decode step appended to the cache (see
    `verify_step`); tree marks them as a flattened draft tree (verify only)."""
    if tree is not None and not verify:
        raise ValueError("tree attention is only defined for verify steps")
    if prefill_resume and (tree is not None or not verify):
        raise ValueError(
            "prefill_resume is the chunked-prefill verify read path; it is "
            "undefined for trees or non-verify forwards")
    x = embed_apply(model.embed, tokens, cfg)
    remat = _remat(cfg, cache)
    new_cache = []
    for i, (layer, spec) in enumerate(zip(model.layers, cfg.layer_specs())):
        if remat:
            fn = functools.partial(_block_out, layer, cfg=cfg, spec=spec, mode=mode)
            x, nc = checkpoint(fn, x, use_reentrant=False), None
        else:
            x, nc = block_apply(layer, x, cfg=cfg, spec=spec, mode=mode,
                                cache=cache[i] if cache is not None else None,
                                verify=verify, tree=tree, prefill_resume=prefill_resume)
        new_cache.append(nc)
    x = rmsnorm_apply(model.final_norm, x, cfg.norm_eps)
    return x, (new_cache if cache is not None else None)


def _head_matmul(model: LM, h: torch.Tensor, cfg) -> torch.Tensor:
    """f32 logits against the tied table (or the untied head). A plain f32
    matmul: callers on CUDA keep TF32 off (torch's default)."""
    w = (model.head.w if isinstance(model.head, Linear) else model.embed.table.T)
    return h.to(torch.float32) @ w.to(torch.float32)


def lm_logits(model: LM, h: torch.Tensor, cfg) -> torch.Tensor:
    """Full f32 logits — use only for small S (serving reads the last position)."""
    return _head_matmul(model, h, cfg)


def _ce_chunk(model: LM, hc, yc, mc, cfg):
    """Summed masked CE and token count of one (B, c) chunk."""
    logits = _head_matmul(model, hc, cfg)                            # (B,c,V) f32
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, yc[..., None])[..., 0]
    return ((logz - ll) * mc).sum(), mc.sum()


def lm_loss(model: LM, tokens: torch.Tensor, labels: torch.Tensor, cfg, *,
            mode: str = "train", loss_mask: torch.Tensor | None = None):
    """Chunked softmax cross-entropy. → (loss, {"ce", "aux", "tokens"}).
    ``aux`` (the MoE router loss in JAX) is 0: no ported layer has one."""
    h, _ = lm_hidden(model, tokens, cfg, mode=mode)
    b, s, _ = h.shape
    chunk = min(cfg.loss_chunk, s)
    pad = (-s) % chunk
    labels = labels.to(torch.long)
    mask = (loss_mask.to(torch.float32) if loss_mask is not None
            else torch.ones((b, s), dtype=torch.float32, device=h.device))
    if pad:
        h = torch.nn.functional.pad(h, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    remat = cfg.remat and torch.is_grad_enabled()
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s + pad, chunk):
        args = (model, h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk], mask[:, c0:c0 + chunk], cfg)
        t, n = checkpoint(_ce_chunk, *args, use_reentrant=False) if remat else _ce_chunk(*args)
        tot, cnt = tot + t, cnt + n
    ce = tot / torch.clamp_min(cnt, 1.0)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return ce + aux, {"ce": ce, "aux": aux, "tokens": cnt}


def prefill(model: LM, tokens: torch.Tensor, cache: list, cfg):
    """Run the prompt through the model, filling the cache.
    → (last-position logits (B, V), new_cache)."""
    h, new_cache = lm_hidden(model, tokens, cfg, mode="serve", cache=cache)
    return _head_matmul(model, h[:, -1:, :], cfg)[:, 0], new_cache


def decode_step(model: LM, tokens: torch.Tensor, cache: list, cfg):
    """One decode step. tokens: (B, 1) int → (logits (B, V), new_cache)."""
    h, new_cache = lm_hidden(model, tokens, cfg, mode="serve", cache=cache)
    return _head_matmul(model, h[:, -1:, :], cfg)[:, 0], new_cache


def verify_step(model: LM, tokens: torch.Tensor, cache: list, cfg, *, tree=None,
                prefill_resume: bool = False, logit_cols: torch.Tensor | None = None):
    """Batched multi-token decode: the speculative-verification step and the
    chunked-prefill step.

    tokens: (B, S) int; column 0 is each slot's last sampled token, columns
    1..S-1 the drafted continuation (or the next prompt chunk). Every token
    is appended at its slot's position (cache idx onward) and attends the
    whole cache, so logits[:, j] is what sequential decode would give after
    tokens[:, :j+1]: one pass with N = B*S tokens per mpGeMM launch instead
    of S passes with N = B.

    With tree (a `DraftTree`, S == tree.n_nodes) the tokens are a flattened
    draft tree: node j attends the cached prefix and its ancestors only, at
    position idx + depth(j), written to slot idx + j; the engine compacts
    the accepted path (`compact_tree_cache`) before rolling back.

    → (logits (B, S, V) f32, new_cache with idx advanced by S). With
    logit_cols ((B,) int) one hidden state per slot is gathered *before* the
    head matmul, → (logits (B, V), new_cache): the chunk step never builds
    (B, S, V) logits."""
    h, new_cache = lm_hidden(model, tokens, cfg, mode="serve", cache=cache, verify=True,
                             tree=tree, prefill_resume=prefill_resume)
    if logit_cols is not None:
        cols = logit_cols.to(torch.long)[:, None, None].expand(-1, 1, h.shape[-1])
        return _head_matmul(model, torch.gather(h, 1, cols), cfg)[:, 0], new_cache
    return _head_matmul(model, h, cfg), new_cache


def prefill_bucket(n: int, max_len: int | None = None) -> int:
    """Pad prompt lengths to 16-multiples (left padding gives pad tokens
    negative positions, masked everywhere), clamped to `max_len` so
    positions never alias modulo the cache length."""
    b = max(16, (n + 15) // 16 * 16)
    if max_len is not None:
        b = min(b, max_len)
    return max(b, n)


def prefill_into_slot(model: LM, cache: list, slot: int, prompt, cfg, *,
                      max_len: int):
    """Admit one prompt into batched slot `slot`: a B=1 bucketed,
    left-padded prefill into a fresh cache (pad positions negative, set via
    `rollback_cache`), then copied into the slot of the batched cache.
    → (logits (1, V), cache, padded_len)."""
    device = cache[0]["k"].device
    n = len(prompt)
    bucket = prefill_bucket(n, max_len)
    single = init_cache(cfg, 1, max_len, device=device)
    if bucket != n:
        single = rollback_cache(single, torch.tensor([n - bucket], dtype=torch.int32, device=device))
    tok = np.zeros((1, bucket), np.int32)
    tok[0, bucket - n:] = prompt
    logits, single = prefill(model, torch.from_numpy(tok).to(device), single, cfg)
    return logits, scatter_slot_cache(cache, single, slot), bucket


def scatter_slot_cache(full_cache: list, single_cache: list, slot: int) -> list:
    """Copy a B=1 cache into batched slot `slot`, in place."""
    for full, one in zip(full_cache, single_cache):
        for key, leaf in full.items():
            leaf[slot:slot + 1] = one[key].to(leaf.dtype)
    return full_cache


def reset_slot_idx(cache: list, slot: int, value: int = 0) -> list:
    """Set ONE slot's write position to `value` in place, leaving every
    other slot's untouched: chunked admission claims a slot without a fresh
    cache (the prompt arrives chunk by chunk). Stale K/V needs no clearing:
    chunk writes re-cover positions contiguously from 0, and entries above
    the write frontier record positions past every live query."""
    for layer in cache:
        layer["idx"][slot] = value
    return cache


def compact_tree_cache(cache: list, pos: torch.Tensor, sel: torch.Tensor,
                       take: torch.Tensor) -> list:
    """Compact a tree verify step's cache window onto the accepted path, in
    place.

    A tree verify writes node j to slot pos+j with position pos+depth(j).
    The accepted path's depth-d node must end up at slot pos+d (slot ==
    position, as every later step assumes) before the idx rollback.

    pos (B,) int: the step's base idx. sel (B, N) int: slot pos+d receives
    node sel[b, d]'s entry (the accepted path's depth-d node for d < take,
    identity elsewhere). take (B,) int: window slots d < take stay live; the
    rest get slot_pos = -1, so a stale sibling's small position can never
    pass a later query's mask. With sel = identity, take = N leaves a row's
    window as it was and take = 0 invalidates all of it (the engine passes 0
    for a slot outside the step: its row was verified too, so its window
    holds nodes at positions below their slots).

    Source indices past the buffer are clamped (their columns' writes are
    dropped: only a window crossing the buffer end has them), and columns
    whose destination passes the buffer end are dropped, never wrapped.
    Only k, v and slot_pos are touched; idx is rollback's job."""
    pos, sel, take = pos.to(torch.long), sel.to(torch.long), take.to(torch.long)
    n = sel.shape[1]
    cols = torch.arange(n, device=pos.device)[None, :]
    src = pos[:, None] + sel                                          # (B, N)
    dst = pos[:, None] + cols                                         # (B, N)
    live = cols < take[:, None]
    bidx = torch.arange(sel.shape[0], device=pos.device)[:, None]
    for layer in cache:
        length = layer["slot_pos"].shape[1]
        keep = dst < length
        # dst past the end wraps onto slots below pos, distinct from the
        # row's in-range ones (N <= length): writing their current contents
        # back is the drop
        dst_w = torch.remainder(dst, length)
        src_c = src.clamp(max=length - 1)
        for key in ("k", "v", "slot_pos"):
            leaf = layer[key]
            gathered = leaf[bidx, src_c]
            if key == "slot_pos":
                gathered = torch.where(live, gathered, -1).to(leaf.dtype)
            k_b = keep.reshape(keep.shape + (1,) * (leaf.dim() - 2))
            leaf[bidx, dst_w] = torch.where(k_b, gathered, leaf[bidx, dst_w])
    return cache


def rollback_cache(cache: list, new_idx: torch.Tensor) -> list:
    """Set every per-slot cache write position to `new_idx` ((B,) int).
    Entries past the new idx keep stale K/V, but their recorded positions
    exceed every later query position until overwritten."""
    return [dict(layer, idx=new_idx.to(torch.int32).expand_as(layer["idx"]).clone())
            for layer in cache]
