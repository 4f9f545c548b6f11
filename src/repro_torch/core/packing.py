"""Ternary weight packing for Vec-LUT (paper §3.3, Fig. 6).

A ternary weight group of ``g`` elements (each in {-1, 0, 1}) is packed into
one byte holding the base-3 ("trit") code

    idx = sum_j (w[j] + 1) * 3**j,   0 <= idx < 3**g,

so the packed byte is directly the row index into the vector LUT. g=5 gives
1.60 bits/weight, g=4 gives 2.00; a mixed weight packs a g=5 segment
followed by a g=4 segment. Byte-for-byte the layout of `repro.core.packing`.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

GROUP_SIZES = (4, 5)
#: trit radix
_R = 3


@functools.lru_cache(maxsize=None)
def sign_matrix(g: int, dtype=np.int8) -> np.ndarray:
    """The (3**g, g) enumeration matrix S with S[i, j] = j-th trit of i, minus 1.

    Row i of ``S`` is the ternary weight pattern whose packed index is i;
    the vector LUT sub-table is exactly ``S @ A_group``.
    """
    idx = np.arange(_R**g, dtype=np.int32)
    js = _R ** np.arange(g, dtype=np.int32)
    trits = (idx[:, None] // js[None, :]) % _R - 1
    return trits.astype(dtype)


def pack_group_sizes(K: int) -> tuple[int, int]:
    """Return (n5, n4): number of g=5 and g=4 groups with 5*n5 + 4*n4 == K.

    Maximizes the number of 5-groups (lowest bpw). Raises if K cannot be
    expressed (only K in {1,2,3,6,7,11} fail).
    """
    for n5 in range(K // 5, -1, -1):
        rem = K - 5 * n5
        if rem % 4 == 0:
            return n5, rem // 4
    raise ValueError(f"K={K} cannot be packed with groups of 4 and 5")


def _places(g: int, device) -> torch.Tensor:
    return _R ** torch.arange(g, dtype=torch.int32, device=device)


def pack_ternary(w: torch.Tensor, g: int) -> torch.Tensor:
    """Pack ternary int8 weights (..., K) with g | K into uint8 codes (..., K//g)."""
    K = w.shape[-1]
    if K % g:
        raise ValueError(f"K={K} not divisible by group size g={g}")
    wg = w.reshape(*w.shape[:-1], K // g, g).to(torch.int32) + 1
    return (wg * _places(g, w.device)[(None,) * (wg.dim() - 1)]).sum(-1).to(torch.uint8)


def unpack_ternary(packed: torch.Tensor, g: int) -> torch.Tensor:
    """Inverse of :func:`pack_ternary` → int8 ternary values (..., KG*g)."""
    idx = packed.to(torch.int32)
    trits = torch.div(idx[..., None], _places(g, packed.device)[(None,) * idx.dim()],
                      rounding_mode="floor") % _R - 1
    return trits.reshape(*packed.shape[:-1], packed.shape[-1] * g).to(torch.int8)


@dataclasses.dataclass
class PackedWeight:
    """Ternary weight (M, K) stored as 1–2 packed uint8 segments + scales.

    Segment 0 packs K5 = 5*n5 input features with g=5; segment 1 packs the
    remaining 4*n4 features with g=4. Either may be empty. ``scale`` is the
    per-output-channel (M,) dequantization scale (float32), or (1,) for a
    per-tensor scale.
    """

    packed5: torch.Tensor  # (M, K5//5) uint8  (possibly zero-width)
    packed4: torch.Tensor  # (M, K4//4) uint8  (possibly zero-width)
    scale: torch.Tensor    # (M,) or (1,) float32
    K: int                 # total input features

    @property
    def M(self) -> int:
        return self.packed5.shape[-2]

    @property
    def k5(self) -> int:
        return self.packed5.shape[-1] * 5

    @property
    def k4(self) -> int:
        return self.packed4.shape[-1] * 4

    @property
    def bits_per_weight(self) -> float:
        nbytes = self.packed5.shape[-1] + self.packed4.shape[-1]
        return 8.0 * nbytes / self.K

    def unpack(self) -> torch.Tensor:
        """Dense ternary int8 (M, K)."""
        parts = []
        if self.packed5.shape[-1]:
            parts.append(unpack_ternary(self.packed5, 5))
        if self.packed4.shape[-1]:
            parts.append(unpack_ternary(self.packed4, 4))
        return torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]


def pack_weight(w_ternary: torch.Tensor, scale: torch.Tensor,
                mode: str = "auto") -> PackedWeight:
    """Pack a ternary int8 weight (..., M, K) into a :class:`PackedWeight`.

    mode: 'i2' (g=4 only), 'i1' (g=5 only; requires 5|K), 'auto'/'i1f'
    (maximal 5-groups, remainder in 4-groups).
    """
    K = w_ternary.shape[-1]
    if mode == "i2":
        n5, n4 = 0, K // 4
        if K % 4:
            raise ValueError(f"I2 packing needs 4|K, got K={K}")
    elif mode == "i1":
        if K % 5:
            raise ValueError(f"I1 packing needs 5|K, got K={K}")
        n5, n4 = K // 5, 0
    else:
        n5, n4 = pack_group_sizes(K)
    k5 = 5 * n5
    lead = w_ternary.shape[:-1]
    dev = w_ternary.device
    p5 = (pack_ternary(w_ternary[..., :k5], 5) if n5
          else torch.zeros((*lead, 0), dtype=torch.uint8, device=dev))
    p4 = (pack_ternary(w_ternary[..., k5:], 4) if n4
          else torch.zeros((*lead, 0), dtype=torch.uint8, device=dev))
    scale = torch.as_tensor(scale, dtype=torch.float32, device=dev)
    if scale.ndim == len(lead) - 1:  # per-tensor -> broadcastable (..., 1)
        scale = scale[..., None]
    return PackedWeight(p5.contiguous(), p4.contiguous(), scale, K=K)
