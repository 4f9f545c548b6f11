"""Analytic FLOPs and HBM bytes of one packed mpGeMM dispatch (ported from
`repro.roofline.analysis.mpgemm_cost`, the same formula), for the
achieved-rate gauges of `repro_torch.obs`."""
from __future__ import annotations


def mpgemm_cost(m: int, k: int, n: int, g: int, *,
                fused: bool = True) -> tuple[float, float]:
    """Analytic (FLOPs, HBM bytes) of one packed mpGeMM dispatch: the
    (m, k) ternary weight (k/g packed uint8 codes per row) against n
    parallel tokens. The fused single-pass kernel touches HBM exactly for
    the packed codes, the float activation, and the float output; the
    unfused pipeline additionally materializes the int8 activation and the
    int32 output between stages (each written once, read once)."""
    kg = k // g
    flops = 2.0 * m * k * n
    bytes_ = m * kg + 4.0 * k * n + 4.0 * m * n          # packed + A + out
    if not fused:
        bytes_ += 2.0 * k * n + 2.0 * 4.0 * m * n        # int8 A, int32 out
    return flops, bytes_
