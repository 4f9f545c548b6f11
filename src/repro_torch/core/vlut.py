"""Vector LUT mpGeMM — the paper's Algorithm 1 in plain PyTorch (ported from
`repro.core.vlut`).

Computes  O = W x A  with ternary W (M, K) packed as uint8 trit-codes and
activation A (K, N) in the paper's *token-contiguous* layout (N last/minor).

Pipeline (paper §3.2):
  1. LUT precompute:  T[k, i, :] = sum_j GetSign(i, j) * A[k*g + j, :]
     == S(3^g, g) @ A_group(g, N)   — one unified table for all N tokens.
  2. Table lookup & accumulate:  O[m, :] += T[k, W[m, k], :]
     — a single 1→N row gather per index (vector LUT), never a per-token
     (1→1, scalar LUT) lookup.

Variants (each maps to a paper technique):
  * streamed vs whole-table execution       (§3.4 Cache-Aware Streamed Lookup)
  * hierarchical INT16→INT32 accumulation   (§3.4)
  * token-contiguous vs feature-contiguous LUT layout (§3.3)
  * topological (3^g-op) vs naive (2*3^{g-1}*g-op) precompute (§4)
  * K/N tiling (N_tile, K_tile)

This is the reference algorithm, not a kernel: the JAX scans become Python
loops and its vmaps batch dimensions. Integer products of exact small
integers run as f32 matmuls (exact: every partial sum stays far below
2^24, even with TF32's 10-bit inputs, which hold int8 values exactly).
Ragged K tiles and blocks are taken as they are where JAX pads them with
the all-zero-trit code, which contributes 0: the integers are the same.
Nothing here copies from the host while it runs, so a CUDA graph can
capture it.
"""
from __future__ import annotations

import numpy as np
import torch

from .packing import PackedWeight, sign_matrix, unpack_ternary
from .quantize import act_quant_tokens


def max_block_int16(g: int) -> int:
    """Paper §3.4: INT16 intra-block accumulation is overflow-free for
    B <= floor(max(INT16) / (max(INT8) * g)) — the strict bound (64 for
    g=4, 51 for g=5)."""
    return int(32767 // (127 * g))


def sign_matrix_on(g: int, device) -> torch.Tensor:
    """The (3^g, g) int8 sign-enumeration matrix S (`packing.sign_matrix`),
    built on `device`: row e holds the trits of code e."""
    codes = torch.arange(3 ** g, dtype=torch.uint8, device=device)[:, None]
    return unpack_ternary(codes, g)


# --------------------------------------------------------------------------
# LUT precompute
# --------------------------------------------------------------------------
def precompute_lut(a_q: torch.Tensor, g: int) -> torch.Tensor:
    """Unified vector LUT. a_q: (K, N) int8 → T: (K//g, 3^g, N) int16, as
    one product with the sign-enumeration matrix S."""
    k, n = a_q.shape
    if k % g:
        raise ValueError(f"K={k} not divisible by g={g}")
    s = sign_matrix_on(g, a_q.device).to(torch.float32)            # (3^g, g)
    a_grp = a_q.reshape(k // g, g, n).to(torch.float32)             # (Kg, g, N)
    return (s @ a_grp).to(torch.int16)                              # (Kg, 3^g, N)


def _topological_plan(g: int) -> tuple[np.ndarray, np.ndarray]:
    """For entry i, its parent i - 3^j and the row j added, j being the
    position of i's lowest nonzero trit."""
    n_entries = 3 ** g
    parents = np.zeros(n_entries, np.int64)
    addrow = np.zeros(n_entries, np.int64)
    for i in range(1, n_entries):
        j, ii = 0, i
        while ii % 3 == 0:
            ii //= 3
            j += 1
        parents[i] = i - 3 ** j
        addrow[i] = j
    return parents, addrow


def precompute_lut_topological(a_q: torch.Tensor, g: int) -> torch.Tensor:
    """Paper §4 'Topological precomputing' — builds the 3^g entries with
    3^g - 1 vector add/subs by reusing already-computed entries:
    T[i] = T[i - 3^j] + a_j, seeded by T[0] = -sum_j a_j."""
    k, n = a_q.shape
    kg = k // g
    a_grp = a_q.reshape(kg, g, n).to(torch.int16)
    parents, addrow = _topological_plan(g)
    table = torch.empty((kg, 3 ** g, n), dtype=torch.int16, device=a_q.device)
    table[:, 0] = -a_grp.sum(1, dtype=torch.int16)
    for i in range(1, 3 ** g):
        table[:, i] = table[:, int(parents[i])] + a_grp[:, int(addrow[i])]
    return table


def precompute_lut_naive(a_q: torch.Tensor, g: int) -> torch.Tensor:
    """Paper Alg. 1 lines 7–19 verbatim (per-entry sign add/sub loop): the
    2*3^{g-1}*g-op baseline for the topological-precompute ablation."""
    k, n = a_q.shape
    s = sign_matrix(g)                                               # host const
    a_grp = a_q.reshape(k // g, g, n).to(torch.int16)
    entries = []
    for i in range(3 ** g):
        acc = torch.zeros((k // g, n), dtype=torch.int16, device=a_q.device)
        for j in range(g):
            if s[i, j] == 1:
                acc = acc + a_grp[:, j]
            elif s[i, j] == -1:
                acc = acc - a_grp[:, j]
        entries.append(acc)
    return torch.stack(entries, dim=1)                               # (Kg, 3^g, N)


# --------------------------------------------------------------------------
# Lookup & accumulate
# --------------------------------------------------------------------------
def _gather_rows(t: torch.Tensor, w_idx: torch.Tensor) -> torch.Tensor:
    """The 1→N lookup, batched over K-groups: t (B, 3^g, N), w_idx (M, B)
    → (B, M, N), row [b, m] = t[b, w_idx[m, b]]."""
    b = t.shape[0]
    ks = torch.arange(b, device=t.device)[:, None]
    return t[ks, w_idx.T.to(torch.long)]


def lookup_accumulate(t: torch.Tensor, w_idx: torch.Tensor, hierarchical: bool = True,
                      g: int | None = None) -> torch.Tensor:
    """O[m, n] = sum_k T[k, W[m, k], n]   (paper Eq. 2) → int32 (M, N).

    hierarchical=True performs the paper's INT16 intra-block / INT32
    inter-block accumulation over blocks of `max_block_int16(g)` K-groups;
    False accumulates each row straight into INT32."""
    kg, n_entries, n = t.shape
    m = w_idx.shape[0]
    g = g if g is not None else {81: 4, 243: 5}[n_entries]
    out = torch.zeros((m, n), dtype=torch.int32, device=t.device)
    if hierarchical and kg > 1:
        block = max_block_int16(g)
        for b0 in range(0, kg, block):
            rows = _gather_rows(t[b0:b0 + block], w_idx[:, b0:b0 + block])  # (B, M, N) int16
            out += rows.sum(0, dtype=torch.int16).to(torch.int32)          # INT16 intra-block
        return out
    for k in range(kg):
        out += t[k][w_idx[:, k].to(torch.long)].to(torch.int32)
    return out


_PRECOMPUTE = {
    "matmul": precompute_lut,
    "topological": precompute_lut_topological,
    "naive": precompute_lut_naive,
}


def _segment_gemm_int(packed: torch.Tensor, a_q: torch.Tensor, g: int, *, streamed: bool,
                      k_tile_groups: int, hierarchical: bool, precompute: str) -> torch.Tensor:
    """Integer vlut GEMM for one homogeneous-g segment. a_q: (K, N) int8.

    streamed=True: loop over K-tiles, precomputing each LUT tile on demand
    and consuming it immediately (§3.4 — the full table never exists in
    memory). streamed=False: materialize the entire T first (the practice
    the paper ablates against in Fig. 12)."""
    kfn = _PRECOMPUTE[precompute]
    kg = a_q.shape[0] // g
    if not streamed:
        return lookup_accumulate(kfn(a_q, g), packed, hierarchical=hierarchical, g=g)
    kt = max(1, min(k_tile_groups, kg))
    out = torch.zeros((packed.shape[0], a_q.shape[1]), dtype=torch.int32, device=a_q.device)
    for k0 in range(0, kg, kt):
        t_tile = kfn(a_q[k0 * g:(k0 + kt) * g], g)                   # (kt, 3^g, N) in "cache"
        out += lookup_accumulate(t_tile, packed[:, k0:k0 + kt], hierarchical=hierarchical, g=g)
    return out


# --------------------------------------------------------------------------
# Public mpGeMM entry point
# --------------------------------------------------------------------------
def vlut_gemm(pw: PackedWeight, a: torch.Tensor, *, streamed: bool = True,
              k_tile_groups: int = 16, n_tile: int = 0, hierarchical: bool = True,
              precompute: str = "matmul", token_contiguous: bool = True) -> torch.Tensor:
    """Full Vec-LUT mpGeMM:  O(M, N) f32 = dequant( W_packed × quant(A) ).

    a: (K, N) float — token-contiguous activation (N minor).
    `token_contiguous=False` runs the layout-ablation variant
    (feature-contiguous quantization and indexing). `n_tile=0` disables N
    tiling; otherwise tokens are processed in N_tile chunks when N_tile
    divides N."""
    if a.shape[0] != pw.K:
        raise ValueError(f"A rows {a.shape[0]} != packed K {pw.K}")
    if precompute not in _PRECOMPUTE:
        raise ValueError(f"unknown precompute {precompute!r}; have {tuple(_PRECOMPUTE)}")
    n = a.shape[1]
    if not token_contiguous:
        # feature-contiguous memory: quantize and index a (N, K) copy
        a_q, a_scale = act_quant_tokens(a.T.contiguous().T)          # a_q strides (1, K)
    else:
        a_q, a_scale = act_quant_tokens(a)

    def run(a_q_chunk: torch.Tensor) -> torch.Tensor:
        kw = dict(streamed=streamed, k_tile_groups=k_tile_groups,
                  hierarchical=hierarchical, precompute=precompute)
        out = torch.zeros((pw.M, a_q_chunk.shape[1]), dtype=torch.int32, device=a.device)
        if pw.packed5.shape[-1]:
            out += _segment_gemm_int(pw.packed5, a_q_chunk[:pw.k5], 5, **kw)
        if pw.packed4.shape[-1]:
            out += _segment_gemm_int(pw.packed4, a_q_chunk[pw.k5:], 4, **kw)
        return out

    if n_tile and n_tile < n and n % n_tile == 0:
        out_i32 = torch.cat([run(a_q[:, c:c + n_tile]) for c in range(0, n, n_tile)], dim=1)
    else:
        out_i32 = run(a_q)
    w_scale = pw.scale.expand(pw.M)
    return out_i32.to(torch.float32) * w_scale[:, None] * a_scale[None, :]
