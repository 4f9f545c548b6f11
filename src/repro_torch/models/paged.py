"""Paged KV cache primitives: a physical page pool + per-slot block tables
(ported from `repro.models.paged`).

Layout (one dict per attention or MLA layer, as the port's dense cache):

  * pool leaves — ``k``/``v``: ``(n_pages + 1, page_size, kv, hd)``,
    ``slot_pos``: ``(n_pages + 1, page_size)`` (GQA), or ``ckv``/``krope``:
    ``(n_pages + 1, page_size, ·)`` (MLA). One physical pool is shared
    by every slot; ``n_pages`` *includes* the reserved null page 0, and the
    extra last page (index ``n_pages``) is the write sink described below.
  * ``tab``: ``(batch, max_len // page_size)`` int32 block table — entry
    ``p`` of slot ``b``'s row is the physical page holding that slot's
    logical positions ``[p*page_size, (p+1)*page_size)``; 0 = unmapped. One
    tensor is shared by every layer's dict and updated in place
    (`set_block_tables`).
  * ``idx``: ``(batch,)`` per-slot write position, identical to the dense
    cache's — rollback stays idx-only (``models.rollback_cache``).

Null-page discipline: physical page 0 is never allocated. On the READ side
an unmapped table entry gathers page 0, whose ``slot_pos`` is all ``-1``
(the position mask never attends it) and whose MLA content sits at
logical positions beyond every live query (index-as-position, contiguous
writes). On the WRITE side an unmapped or
out-of-range target must not land on page 0, which every slot shares. JAX
remaps such targets to ``n_pages``, one past its pool, and its scatter's
``mode="drop"`` discards them; torch has no dropping scatter, so each pool
here carries one extra sink page at index ``n_pages`` that no block table
ever names. Those writes land in the sink and are never read: a drop with
no host sync. The scrub's padding sentinel (``>= n_pages``) lands there
too; `gather_page` and `restore_page` never touch it.

Stale-entry safety mirrors the dense rollback argument, with one paging
addition: a recycled page keeps its previous owner's content, so the host
pager scrubs ``slot_pos = -1`` on every fresh GQA allocation
(`scrub_pages`). MLA pools need no scrub: index-as-position plus writes
from the page start keep stale latents at logical positions above every
live query until they are overwritten.
"""
from __future__ import annotations

import torch

#: per-page cache leaves (everything except tab/idx)
POOL_KEYS = ("k", "v", "slot_pos", "ckv", "krope")


def pool_pages(pool: torch.Tensor) -> int:
    """``n_pages`` of a pool leaf: its page count without the sink."""
    return pool.shape[0] - 1


def page_phys(tab, slots, page_size: int, n_pages: int, *, for_write: bool):
    """Map logical per-slot cache indices ``slots`` (B, S) to physical
    ``(page, offset)`` pairs under block table ``tab`` (B, cap).

    for_write=True sends unmapped / out-of-range targets to the sink page
    ``n_pages``; for_write=False sends them to the null page 0 (read-safe:
    its slot_pos is -1)."""
    cap = tab.shape[1]
    page_l = torch.div(slots, page_size, rounding_mode="floor")
    off = torch.remainder(slots, page_size)
    in_bounds = (slots >= 0) & (page_l < cap)
    pg = torch.gather(tab, 1, page_l.clamp(0, cap - 1).long())
    pg = torch.where(in_bounds & (pg > 0), pg, n_pages if for_write else 0)
    return pg, off


def page_scatter(pool, tab, slots, values):
    """Write ``values`` (B, S, ...) into the pool (n_pages + 1, ps, ...) at
    the physical locations of logical indices ``slots`` (B, S) under
    ``tab``, in place. Unmapped / out-of-range targets go to the sink page
    (dropped, see the module docstring). → pool."""
    pg, off = page_phys(tab, slots, pool.shape[1], pool_pages(pool), for_write=True)
    pool[pg, off] = values.to(pool.dtype)
    return pool


def page_view(pool, tab):
    """Gather the per-slot logical view (B, cap*ps, ...) from the pool —
    the paged read path: the position-masked attention (sdpa, tree gates)
    runs on this view unchanged."""
    g = pool[tab]                                     # (B, cap, ps, ...)
    return g.reshape((g.shape[0], g.shape[1] * g.shape[2]) + tuple(g.shape[3:]))


def _paged_layers(cache: list) -> list:
    return [layer for layer in cache if "tab" in layer]


def set_block_tables(cache: list, tab: torch.Tensor) -> list:
    """Copy a fresh (batch, cap) block table into the cache's ``tab`` in
    place (the host pager's flush point): `models.init_cache` gives every
    layer's dict the same tensor, so one copy serves them all."""
    _paged_layers(cache)[0]["tab"].copy_(tab)
    return cache


def scrub_pages(cache: list, pages: torch.Tensor) -> list:
    """Invalidate ``slot_pos`` on freshly allocated physical pages in place
    (``pages``: (K,) int, sentinels >= n_pages land in the sink).

    This is the paging leg of the stale-entry safety argument: a recycled
    page still holds its previous owner's recorded positions, which could
    otherwise unmask garbage K/V for a new owner whose queries pass them.
    MLA pools carry no slot_pos and need no scrub (index-as-position)."""
    for layer in _paged_layers(cache):
        if "slot_pos" not in layer:
            continue
        sp = layer["slot_pos"]
        # a fill takes its value as a scalar (an index write of -1 copies
        # it to the device first: a host sync)
        sp.index_fill_(0, pages.clamp(max=pool_pages(sp)).long(), -1)
    return cache


def compact_paged_block(layer: dict, src, dst, live) -> dict:
    """Tree-verify window compaction for one paged layer dict, in place:
    gather the accepted path's entries from their node slots and write them
    onto contiguous slots, both through the block table.

    src/dst: (B, N) logical indices (models.compact_tree_cache computes
    them); live: (B, N) bool — slots >= take get slot_pos = -1. Unmapped
    sources read the null page (slot_pos -1, never attended); unmapped
    destinations land in the sink."""
    tab = layer["tab"]
    for key in POOL_KEYS:
        if key not in layer:
            continue
        leaf = layer[key]
        n_pages, ps = pool_pages(leaf), leaf.shape[1]
        pg_s, off_s = page_phys(tab, src, ps, n_pages, for_write=False)
        pg_d, off_d = page_phys(tab, dst, ps, n_pages, for_write=True)
        gathered = leaf[pg_s, off_s]                  # (B, N, ...), a copy
        if key == "slot_pos":
            gathered = torch.where(live, gathered, -1).to(leaf.dtype)
        leaf[pg_d, off_d] = gathered
    return layer


def gather_page(cache: list, page: int) -> dict:
    """Copy one physical page's content (every pool leaf of every layer) to
    the host in one device-to-host copy — the offload tier's page-out.
    → {leaf: CPU tensor (n_layers, page_size, ...)}."""
    layers = _paged_layers(cache)
    keys = [k for k in POOL_KEYS if k in layers[0]]
    parts = [torch.stack([layer[k][page] for layer in layers]) for k in keys]
    flat = torch.cat([p.reshape(-1).view(torch.uint8) for p in parts]).cpu()
    out, o = {}, 0
    for key, part in zip(keys, parts):
        n = part.numel() * part.element_size()
        out[key] = flat[o:o + n].view(part.dtype).reshape(part.shape)
        o += n
    return out


def restore_page(cache: list, page: int, data: dict) -> list:
    """Write a previously gathered page back into physical page ``page``
    in place — the offload tier's page-in (the pager re-points the radix
    node here). ``page`` is a host int the pager allocated < n_pages."""
    layers = _paged_layers(cache)
    for key, host in data.items():
        dev = host.to(layers[0][key].device)          # one host-to-device copy
        for i, layer in enumerate(layers):
            layer[key][page] = dev[i].to(layer[key].dtype)
    return cache
