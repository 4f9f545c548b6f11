"""DraftTree — the static draft-tree layout tree-speculative decoding runs on
(a copy of `repro.spec.tree`, numpy only).

`SpecConfig(tree=(b1, b2, ...))` describes a token tree of depth `k` (the
draft length): the root is the last sampled token, depth-d nodes carry the
d-th drafted candidate, and the branching factor at depth d is ``tree[d-1]``
for the first ``len(tree)`` depths and 1 (a chain continuation per leaf)
afterwards. One engine verify pass flattens the whole tree into a single
``(B, n_nodes)`` token batch, so the Vec-LUT mpGeMM kernels see M = n_nodes
parallel tokens per slot instead of the chain mode's M = k+1.

Flattening order (the contract every consumer shares — drafters emit node
tokens in it, the verify step scatters cache entries by it, and acceptance
indexes logits with it): **breadth-first by depth, siblings in candidate-rank
order, parents in their own flattened order**. Node 0 is the root; depth-1
nodes are 1..b1 (rank 0 first); depth-2 nodes follow parent-major
(parent 1's b2 children, then parent 2's, ...), and so on. A node's rank
among its siblings (`ranks`) is the drafter's candidate index: rank 0 is the
drafter's best (argmax/most-frequent) candidate, so the all-rank-0 path is
exactly the chain-mode proposal.

The structure is static per SpecConfig — everything here is host-side numpy
that the verify step, acceptance and cache compaction read as constants.
"""
from __future__ import annotations

import dataclasses

import numpy as np

#: hard cap on flattened tree width — verify cost is linear in n_nodes and a
#: typo like tree=(8, 8, 8) would silently run a 585-node step
MAX_NODES = 256


@dataclasses.dataclass(frozen=True)
class DraftTree:
    """Static draft-tree layout.

    k          tree depth == draft tokens along any root-to-leaf path.
    branching  per-depth branching factors (padded with 1s to depth k).
    n_nodes    flattened node count incl. the root (the verify step's S).
    parents    (n_nodes,) node index of each node's parent (root: itself).
    depths     (n_nodes,) node depth (root 0; cache position = idx + depth).
    ranks      (n_nodes,) candidate rank among siblings (root 0).
    ancestors  (n_nodes, n_nodes) bool; ancestors[i, j] ⇔ j is on the
               root-to-i path, i itself included — the intra-step attention
               mask of the verify pass.
    leaf_paths (n_leaves, k+1) node indices of every root-to-leaf path,
               column d = the path's depth-d node — acceptance scans these.
    """

    k: int
    branching: tuple
    n_nodes: int
    parents: np.ndarray
    depths: np.ndarray
    ranks: np.ndarray
    ancestors: np.ndarray
    leaf_paths: np.ndarray

    @property
    def n_draft(self) -> int:
        """Drafted (non-root) nodes — the per-slot proposal count."""
        return self.n_nodes - 1


def build_tree(k: int, branching: tuple) -> DraftTree:
    """Build the flattened draft tree for depth `k` and the given per-depth
    branching factors (see module docstring for the flattening order)."""
    if not branching:
        raise ValueError("tree branching must name at least one depth factor")
    if len(branching) > k:
        raise ValueError(
            f"tree names {len(branching)} branching depths but k={k}; "
            "the tree can be at most k deep"
        )
    if any(int(b) < 1 for b in branching):
        raise ValueError(f"tree branching factors must be >= 1, got {branching}")
    full = tuple(int(b) for b in branching) + (1,) * (k - len(branching))

    parents = [0]
    depths = [0]
    ranks = [0]
    frontier = [0]                      # node ids at the previous depth
    for d, b in enumerate(full, start=1):
        nxt = []
        for p in frontier:
            for r in range(b):
                nxt.append(len(parents))
                parents.append(p)
                depths.append(d)
                ranks.append(r)
        frontier = nxt
        if len(parents) > MAX_NODES:
            raise ValueError(
                f"tree {branching} at k={k} flattens to > {MAX_NODES} nodes"
            )
    n = len(parents)
    parents_a = np.asarray(parents, np.int32)
    depths_a = np.asarray(depths, np.int32)

    anc = np.zeros((n, n), bool)
    for i in range(n):
        j = i
        while True:
            anc[i, j] = True
            if j == 0:
                break
            j = int(parents_a[j])

    paths = np.zeros((len(frontier), k + 1), np.int32)
    for li, leaf in enumerate(frontier):
        j = leaf
        for d in range(k, -1, -1):
            paths[li, d] = j
            j = int(parents_a[j])

    return DraftTree(
        k=k,
        branching=full,
        n_nodes=n,
        parents=parents_a,
        depths=depths_a,
        ranks=np.asarray(ranks, np.int32),
        ancestors=anc,
        leaf_paths=paths,
    )
