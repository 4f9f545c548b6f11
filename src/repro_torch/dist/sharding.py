"""Sharding rules for the production mesh (pod × data × model), ported from
`repro.dist.sharding` onto `torch.distributed` DTensors.

A spec is a tuple with one entry per tensor dim: None (replicated), one
mesh axis name, or a tuple of names (sharded over their product, the first
name major) — the entries of a JAX `PartitionSpec`. `to_placements` turns
it into DTensor placements on a `DeviceMesh`; `NamedSharding` pairs a mesh
and a spec, as JAX's does, and gives a leaf's local shape (a `ShapeMesh`
works there too: the dry run needs no process group).

Everything is *name-based*: a rule looks at the trailing names of a leaf's
path and the trailing dims of its shape. The port keeps one module per
layer where JAX stacks a stage's layers on leading axes; since only
trailing dims are read, a layer's spec is the stacked leaf's spec without
its stage axes. Path names are the dotted keys of the port's dicts split on
"." (``layers.3.mixer.wq.qw``), a packed linear's weight entering as the
`PackedWeight` at "<owner>.pw" (`bridge.named_leaves`), so the rules read
JAX's names: ``qw``/``w``, ``pw`` + ``packed5``/``packed4``/``scale``,
``experts``, ``router``, ``table``. Every axis assignment is guarded by
divisibility (`_take`): a dim that does not divide evenly over the proposed
axes is replicated, never sharded unevenly.

Layouts the rules understand:

  dense quantizable linear ``qw``  (..., K, M)
      column-parallel (wq/wk/wv/w1/w3/…): K → (pod, data) FSDP, M → model
      row-parallel    (wo/w2/out_proj):   K → model,        M → (pod, data)
  packed serving weight ``pw.packed{5,4}``  (..., M, K//g)
      column-parallel: M → model, K-groups → (pod, data)
      row-parallel:    K-groups inherit K's ``model`` axis, M replicated
  expert-stacked linears  (..., E, K, M): E → model (EP), K → (pod, data)
  embedding ``table``  (V, D): V → model, D → (pod, data)
  everything else (norm scales, biases, router) replicated.

Optimizer moments inherit the parameter's spec; the int8 `QTensor` moments
are shape-preserving, so ``q`` inherits directly and ``scale`` drops the
last dim's axis. Serving caches shard batch over (pod, data), falling back
to sequence-parallel over ``data`` when B = 1, heads/SSM-heads over
``model``.

``use_sharding_ctx(mesh, cfg)`` installs the (mesh, cfg) pair that
``shard_act`` / ``dispatch_blocks`` read; outside the context, or on a
plain tensor, ``shard_act`` is the identity and ``dispatch_blocks`` is 1,
so a single-device run runs exactly as without this module.
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
import math
from typing import Any, Callable, Sequence

import torch

from repro_torch.launch.mesh import axis_size, batch_axes, mesh_axes

_ROW_PARALLEL = frozenset({"wo", "w2", "out_proj"})
_PACKED_KEYS = frozenset({"packed5", "packed4"})

Spec = tuple


def _norm(axes: Sequence[str]):
    """() → None, 1-tuple → bare name, else tuple (canonical spec entries)."""
    axes = tuple(axes)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def _take(mesh, size: int, axes) -> Any:
    """Axes entry if `size` divides evenly over them (and they exist)."""
    if isinstance(axes, str):
        axes = (axes,)
    names = mesh_axes(mesh)
    axes = tuple(a for a in axes if a in names)
    n = axis_size(mesh, axes)
    if not axes or n <= 1 or size % n:
        return None
    return _norm(axes)


# --------------------------------------------------------------------------
# parameter rules
# --------------------------------------------------------------------------
def param_spec(names: Sequence[str], shape, mesh, cfg) -> Spec:
    names, shape = list(names), tuple(shape)
    nd = len(shape)
    spec: list = [None] * nd
    if not names or nd == 0:
        return tuple(spec)
    term = names[-1]
    batch = batch_axes(mesh)

    if term == "table" and nd >= 2:  # embedding (V, D)
        spec[-2] = _take(mesh, shape[-2], "model")
        spec[-1] = _take(mesh, shape[-1], batch)
    elif term in ("qw", "w") and nd >= 2:
        owner = names[-2] if len(names) >= 2 else ""
        if owner == "router":
            pass  # small, accuracy-critical: replicated
        elif "experts" in names and nd >= 3:
            spec[-3] = _take(mesh, shape[-3], "model")      # EP over experts
            spec[-2] = _take(mesh, shape[-2], batch)        # FSDP over K
        elif owner in _ROW_PARALLEL:
            spec[-2] = _take(mesh, shape[-2], "model")
            spec[-1] = _take(mesh, shape[-1], batch)
        else:
            spec[-2] = _take(mesh, shape[-2], batch)
            spec[-1] = _take(mesh, shape[-1], "model")
    elif term in _PACKED_KEYS and nd >= 2:
        owner = names[-3] if len(names) >= 3 else ""        # [.., owner, pw, packedX]
        if "experts" in names and nd >= 3:
            spec[-3] = _take(mesh, shape[-3], "model")
            spec[-1] = _take(mesh, shape[-1], batch)
        elif owner in _ROW_PARALLEL:
            spec[-1] = _take(mesh, shape[-1], "model")
        else:
            spec[-2] = _take(mesh, shape[-2], "model")
            spec[-1] = _take(mesh, shape[-1], batch)
    elif term == "scale" and "pw" in names:
        owner = names[-3] if len(names) >= 3 else ""
        if "experts" in names and nd >= 2:
            spec[-2] = _take(mesh, shape[-2], "model")
        elif owner not in _ROW_PARALLEL:
            spec[-1] = _take(mesh, shape[-1], "model")
    # everything else (norms, biases, conv, dt, router_bias): replicated
    return tuple(spec)


def opt_spec(names: Sequence[str], shape, mesh, cfg) -> Spec:
    """Optimizer-state rule: moments inherit the parameter's spec.

    QTensor int8 moments are shape-preserving, so the ``q`` leaf inherits the
    parameter spec verbatim; the per-row ``scale`` (shape[:-1]) drops the
    last dim's axis."""
    names, shape = list(names), tuple(shape)
    if not names:
        return (None,) * len(shape)
    term = names[-1]
    if term == "q":
        return param_spec(names[:-1], shape, mesh, cfg)
    if term == "scale" and len(names) >= 2 and names[-2] in {"qw", "w", "table"} | _PACKED_KEYS:
        # QTensor scale: the param spec of a dummy (always divisible)
        # trailing dim, dropped
        dummy = axis_size(mesh, tuple(mesh_axes(mesh))) * 128
        return param_spec(names[:-1], shape + (dummy,), mesh, cfg)[:-1]
    return param_spec(names, shape, mesh, cfg)


# --------------------------------------------------------------------------
# serving-cache + batch rules
# --------------------------------------------------------------------------
def cache_spec(names: Sequence[str], shape, mesh, cfg) -> Spec:
    names, shape = list(names), tuple(shape)
    nd = len(shape)
    spec: list = [None] * nd
    if not names or nd == 0:
        return tuple(spec)
    term = names[-1]
    batch = batch_axes(mesh)

    if term in ("k", "v") and nd >= 4:           # (..., B, S, H, D)
        b = _take(mesh, shape[-4], batch)
        spec[-4] = b
        if b is None:                            # B=1 long context → SP over S
            spec[-3] = _take(mesh, shape[-3], "data")
        spec[-2] = _take(mesh, shape[-2], "model")
    elif term in ("ckv", "krope") and nd >= 3:   # (..., B, S, r) MLA latents
        b = _take(mesh, shape[-3], batch)
        spec[-3] = b
        if b is None:
            spec[-2] = _take(mesh, shape[-2], "data")
    elif term == "state" and nd >= 4:            # (..., B, H, P, N) SSM state
        spec[-4] = _take(mesh, shape[-4], batch)
        spec[-3] = _take(mesh, shape[-3], "model")
    elif term == "conv" and nd >= 3:             # (..., B, hist, d_inner)
        spec[-3] = _take(mesh, shape[-3], batch)
    elif term in ("idx", "slot_pos") and nd >= 1:
        spec[-1] = _take(mesh, shape[-1], batch)
    return tuple(spec)


def batch_spec(names: Sequence[str], shape, mesh, cfg) -> Spec:
    shape = tuple(shape)
    spec: list = [None] * len(shape)
    if shape:
        spec[0] = _take(mesh, shape[0], batch_axes(mesh))
    return tuple(spec)


def act_spec(name: str, shape, mesh, cfg) -> Spec | None:
    """Constraint spec for a named activation; None → leave unconstrained."""
    nd = len(shape)
    spec: list = [None] * nd
    batch = batch_axes(mesh)
    if name == "tokens" and nd >= 1:             # (B, S)
        spec[0] = _take(mesh, shape[0], batch)
    elif name == "btd" and nd >= 2:              # (B, S, d) residual stream
        b = _take(mesh, shape[0], batch)
        spec[0] = b
        if b is None and nd >= 3 and shape[1] > 1:
            spec[1] = _take(mesh, shape[1], "data")
    elif name == "btv" and nd >= 3:              # (B, c, V) logits
        spec[0] = _take(mesh, shape[0], batch)
        spec[-1] = _take(mesh, shape[-1], "model")
    elif name == "kv_cache" and nd >= 3:         # (B, S, H, D) | (B, S, r)
        b = _take(mesh, shape[0], batch)
        spec[0] = b
        if b is None:
            spec[1] = _take(mesh, shape[1], "data")
        if nd >= 4:
            spec[-2] = _take(mesh, shape[-2], "model")
    elif name == "ssm_state" and nd >= 4:        # (B, H, P, N)
        spec[0] = _take(mesh, shape[0], batch)
        spec[1] = _take(mesh, shape[1], "model")
    elif name == "moe_buf" and nd >= 2:          # (E, nb·C, d) expert-parallel
        spec[0] = _take(mesh, shape[0], "model")
        spec[1] = _take(mesh, shape[1], batch)
    elif name == "moe_buf_blocked" and nd >= 1:  # (nb, E, C, d) block-local
        spec[0] = _take(mesh, shape[0], batch)
    else:
        return None
    return tuple(spec)


# --------------------------------------------------------------------------
# specs → DTensor placements, local shapes
# --------------------------------------------------------------------------
def spec_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def to_placements(spec: Spec, mesh) -> tuple:
    """One DTensor placement per mesh dim: ``Shard(d)`` on each mesh dim
    named in entry d (a tuple entry shards d over several mesh dims, the
    first name major, as JAX's), ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_axes(mesh))
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        idx = [names.index(a) for a in spec_axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} names mesh dims out of the mesh's "
                             f"order {names}; DTensor shards major to minor in mesh order")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh dim {names[i]!r} shards two dims in {spec}")
            out[i] = Shard(d)
    return tuple(out)


def local_shape(spec: Spec, shape, mesh) -> tuple[int, ...]:
    """The shard shape of a `shape` leaf on every device (`_take` makes
    every sharded dim divide evenly)."""
    out = []
    for d, n in enumerate(shape):
        k = axis_size(mesh, spec_axes(spec[d]) if d < len(spec) else ())
        if n % k:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide over {spec[d]!r}")
        out.append(n // k)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec, as JAX's `NamedSharding`."""
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return to_placements(self.spec, self.mesh)

    def shard_shape(self, shape) -> tuple[int, ...]:
        return local_shape(self.spec, shape, self.mesh)


# --------------------------------------------------------------------------
# tree-level builders
# --------------------------------------------------------------------------
def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, NamedSharding))


def map_with_names(fn: Callable, tree, names: tuple = ()):
    """`fn(names, leaf)` on every tensor leaf of a tree of dicts, lists and
    dataclasses (`QTensor`, `PackedWeight`); a dict key adds its dotted
    parts to the names, a list index "[i]", a dataclass field its name.
    Other values (a dataclass's shape or K) stay as they are."""
    if isinstance(tree, dict):
        return {k: map_with_names(fn, v, names + tuple(str(k).split(".")))
                for k, v in tree.items()}
    if _is_leaf(tree):
        return fn(names, tree)
    if isinstance(tree, (list, tuple)):
        if all(isinstance(v, int) for v in tree):
            return tree
        return type(tree)(map_with_names(fn, v, names + (f"[{i}]",)) for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_with_names(fn, getattr(tree, f.name), names + (f.name,))
            for f in dataclasses.fields(tree) if f.init})
    return tree


def leaves_with_names(tree) -> list[tuple[tuple, Any]]:
    out: list = []
    map_with_names(lambda n, leaf: out.append((n, leaf)), tree)
    return out


def _shardings(rule, tree, mesh, cfg):
    return map_with_names(
        lambda n, leaf: NamedSharding(mesh, rule(n, leaf.shape, mesh, cfg)), tree)


def param_shardings(tree, mesh, cfg):
    return _shardings(param_spec, tree, mesh, cfg)


def opt_shardings(tree, mesh, cfg):
    return _shardings(opt_spec, tree, mesh, cfg)


def cache_shardings(tree, mesh, cfg):
    return _shardings(cache_spec, tree, mesh, cfg)


def batch_shardings(tree, mesh, cfg):
    return _shardings(batch_spec, tree, mesh, cfg)


def place(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """A DTensor of `t` (the same full tensor on every rank) with
    `placements` on `mesh`; each rank keeps its own shard, with no
    communication (a DTensor is redistributed)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(t, DTensor):
        return t.redistribute(mesh, placements)
    if "src_data_rank" in inspect.signature(distribute_tensor).parameters:
        return distribute_tensor(t, mesh, placements, src_data_rank=None)
    return distribute_tensor(t, mesh, placements)   # older torch: scatters rank 0's copy


def distribute(t: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """`t` placed by `sharding` (`place`)."""
    return place(t, sharding.mesh, sharding.placements)


def distribute_tree(tree, shardings):
    """Every tensor leaf of `tree` distributed by the matching leaf of
    `shardings` (a tree of the same structure)."""
    flat = {n: s for n, s in leaves_with_names(shardings)}
    return map_with_names(lambda n, leaf: distribute(leaf, flat[n]), tree)


def full_tensor(t):
    """The global tensor of a DTensor (gathered), or `t` itself."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


# --------------------------------------------------------------------------
# activation constraints + MoE dispatch blocking
# --------------------------------------------------------------------------
_CTX: list[tuple[Any, Any]] = []


@contextlib.contextmanager
def use_sharding_ctx(mesh, cfg):
    """Install (mesh, cfg) so `shard_act`/`dispatch_blocks` resolve.
    Re-entrant; the helpers are no-ops outside any context."""
    _CTX.append((mesh, cfg))
    try:
        yield
    finally:
        _CTX.pop()


def current_ctx():
    return _CTX[-1] if _CTX else None


def shard_act(x: torch.Tensor, name: str) -> torch.Tensor:
    """Redistribute a DTensor activation to `act_spec`'s placements (JAX's
    `with_sharding_constraint` by name); the identity outside a sharding
    context, on a plain tensor, or for a name without a rule."""
    ctx = current_ctx()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    mesh, cfg = ctx
    spec = act_spec(name, x.shape, mesh, cfg)
    if spec is None:
        return x
    return x.redistribute(x.device_mesh, to_placements(spec, mesh))


def dispatch_blocks(t: int) -> int:
    """Number of block-local MoE dispatch blocks for `t` tokens: the batch
    shard count when the config opts in (cfg.moe_block_dispatch) and it
    divides `t`, else 1 (global positions)."""
    ctx = current_ctx()
    if ctx is None:
        return 1
    mesh, cfg = ctx
    if not getattr(cfg, "moe_block_dispatch", False):
        return 1
    nb = axis_size(mesh, batch_axes(mesh))
    return nb if nb > 1 and t % nb == 0 else 1


def unstrided(t: torch.Tensor) -> torch.Tensor:
    """`t` with a DTensor's strided shards gathered (a plain tensor as it
    is). Flattening dims whose inner one is sharded (tokens: batch and
    sequence, or experts and their rows) leaves the flat dim sharded with
    a stride, and DTensor gets the local shape of unflattening it back
    wrong: gather it first."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.placement_types import _StridedShard

    if not isinstance(t, DTensor):
        return t
    placements = [Replicate() if isinstance(p, _StridedShard) else p for p in t.placements]
    return t if placements == list(t.placements) else t.redistribute(t.device_mesh, placements)


def fit_sharding(t: torch.Tensor, dim: int, parts: int) -> torch.Tensor:
    """`t` (a DTensor; a plain tensor as it is) with the sharding of its dim
    `dim` kept, mesh dim by mesh dim, while the shards' product divides
    `parts`, the leading factor the dim is about to be split into (or was
    merged from), and gathered over the rest: DTensor cannot split or
    merge an unevenly sharded dim (JAX's partitioner gathers it
    implicitly), and gets the local shape wrong where the dim's shards
    outnumber its leading factor."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(t, DTensor):
        return t
    dim, sizes, kept = dim % t.ndim, t.device_mesh.shape, 1
    placements = []
    for i, pl in enumerate(t.placements):
        if isinstance(pl, Shard) and pl.dim == dim:
            if parts % (kept * sizes[i]):
                pl = Replicate()
            else:
                kept *= sizes[i]
        placements.append(pl)
    if placements == list(t.placements):
        return t
    return t.redistribute(t.device_mesh, placements)


def unflatten_tokens(y: torch.Tensor, lead) -> torch.Tensor:
    """(N, ...) → (*lead, ...), N the product of `lead`. On a DTensor the
    token dim's strided or surplus shards are gathered first (`unstrided`,
    `fit_sharding`: shards kept while they divide lead[0])."""
    from torch.distributed.tensor import DTensor

    if lead and isinstance(y, DTensor):
        y = fit_sharding(unstrided(y), 0, lead[0])
    return y.reshape(*lead, *y.shape[1:])


class _FlattenTokens(torch.autograd.Function):
    """(B, S, ...) → (B·S, ...) whose gradient is unflattened back with its
    token shards fitted to B first (`unstrided`, `fit_sharding`)."""

    @staticmethod
    def forward(ctx, x):
        ctx.lead = tuple(x.shape[:2])
        return x.reshape(-1, *x.shape[2:])

    @staticmethod
    def backward(ctx, g):
        return fit_sharding(unstrided(g), 0, ctx.lead[0]).reshape(*ctx.lead, *g.shape[1:])


def flatten_tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, S, ...) → (B·S, ...). On a DTensor the gradient coming back may
    shard the token dim over more ranks than B has rows (the batch axes and
    "model"), which DTensor unflattens into a wrong local shape: it is
    fitted to B first. A plain tensor is reshaped as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x.reshape(-1, *x.shape[2:])
    return _FlattenTokens.apply(x)


def write_rows(leaf: torch.Tensor, slots: torch.Tensor, values: torch.Tensor,
               keep: torch.Tensor | None = None, bidx: torch.Tensor | None = None) -> None:
    """``leaf[b, slots[b, i]] = values[b, i]`` in place, slots in [0, L)
    (a serving cache's write); with `keep`, (B, S) bool, a dropped entry
    writes the slot's current content back (JAX's scatter with
    mode="drop", no host sync). `bidx`: ``arange(B)[:, None]`` where the
    caller has it.

    On a DTensor leaf (a sharded cache: batch over the batch axes, heads
    over "model", or the sequence over "data" when B = 1) each device
    writes its own block, as a partitioned scatter does: `slots` and
    `values` are redistributed to the leaf's batch and head placements,
    and where the sequence is sharded each device keeps the slots in its
    own range, shifted by its offset (the others are the other devices'
    writes). Every dropped entry there lands on local slot 0 and writes
    the content slot 0 ends with (a kept entry's value where one lands
    there, else its current one), so the duplicate indices agree, as an
    index_put with duplicates needs. DTensor has no in-place rule for a
    scatter into a sharded buffer."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(leaf, DTensor):
        if bidx is None:
            bidx = torch.arange(slots.shape[0], device=slots.device)[:, None]
        if keep is not None:
            values = torch.where(_wide(keep, values), values, leaf[bidx, slots])
        leaf[bidx, slots] = values
        return
    mesh, placements = leaf.device_mesh, leaf.placements
    # the step's S positions are never sharded like the cache's L slots
    rows = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p for p in placements)
    two = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in placements)
    local = leaf.to_local()
    sl = slots.redistribute(mesh, two).to_local() if isinstance(slots, DTensor) else slots
    vl = values.redistribute(mesh, rows).to_local() if isinstance(values, DTensor) else values
    kl = keep.redistribute(mesh, two).to_local() if isinstance(keep, DTensor) else keep
    seq_axes = [i for i, p in enumerate(placements) if isinstance(p, Shard) and p.dim == 1]
    if seq_axes:
        offset = 0
        for i in seq_axes:
            offset = offset * mesh.size(i) + mesh.get_local_rank(i)
        offset *= local.shape[1]
        sl = sl - offset
        inside = (sl >= 0) & (sl < local.shape[1])
        kl = inside if kl is None else kl & inside
        sl = torch.where(kl, sl, 0)
        bidx = torch.arange(sl.shape[0], device=sl.device)[:, None]
        hit = kl & (sl == 0)
        lands = vl[bidx, hit.to(torch.int8).argmax(1, keepdim=True)]     # (B, 1, ...)
        slot0 = torch.where(_wide(hit.any(1, keepdim=True), vl), lands, local[:, :1])
        write_rows(local, sl, torch.where(_wide(kl, vl), vl, slot0), bidx=bidx)
        return
    write_rows(local, sl, vl, kl)


def _wide(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """`mask` with trailing unit dims up to `like`'s rank."""
    return mask.reshape(*mask.shape, *(1,) * (like.ndim - mask.ndim))


def local_bytes(tree, shardings) -> int:
    """Bytes of `tree`'s leaves on one device under `shardings` (JAX's
    `_per_device_bytes`): each leaf's local shard shape times its itemsize."""
    flat = {n: s for n, s in leaves_with_names(shardings)}
    total = 0
    for n, leaf in leaves_with_names(tree):
        total += math.prod(flat[n].shard_shape(leaf.shape)) * leaf.dtype.itemsize
    return total
