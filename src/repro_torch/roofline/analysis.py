"""Analytic cost model (ported from `repro.roofline.analysis`): the FLOPs
and HBM bytes of one packed mpGeMM dispatch (`mpgemm_cost`, for the
achieved-rate gauges of `repro_torch.obs` and the step statistics), the
parameter counts and model FLOPs of an architecture (`count_params`,
`model_flops`), the bytes of each collective kind in a traced step
(`collective_bytes`) and the dry run's three-term roofline (`Roofline`).

The roofline's peaks are one NVIDIA H100 SXM's, from NVIDIA's data sheet
(dense, at the 700 W limit): 989 TFLOP/s bf16 on the tensor cores, 3.35
TB/s of HBM, 450 GB/s of NVLink each way. The JAX package's figures are a
TPU's and its per-device FLOPs, bytes and collectives come from compiled
HLO; the port has no compiler, so the dry run reads them from a trace of
its own step (`hlo_stats.trace_step`, `hlo_stats.step_stats`), and
`collective_bytes` reads that trace's op list where the JAX function reads
HLO text.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

PEAK_FLOPS = 989e12          # bf16, dense
HBM_BW = 3.35e12             # bytes/s
LINK_BW = 450e9              # bytes/s, NVLink each way


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


def collective_bytes(ops) -> dict[str, dict[str, float]]:
    """Result bytes and count of each collective kind (JAX's names, every
    kind present) in a recorded op list (`hlo_stats.Trace.ops`): the
    counterpart of `repro.roofline.analysis.collective_bytes(hlo_text)`,
    whose HLO collectives are the trace's functional collectives
    (`hlo_stats.collective_kind`); waits are not collectives."""
    from .hlo_stats import COLLECTIVE_KINDS, collective_kind, nbytes

    out = {k: {"bytes": 0, "count": 0} for k in COLLECTIVE_KINDS}
    for op in ops:
        kind = collective_kind(op)
        if kind is not None:
            out[kind]["bytes"] += nbytes(op["out"])
            out[kind]["count"] += 1
    return out


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float | None
    coll_detail: dict | None = field(default_factory=dict)
    model_flops_total: float = 0.0
    min_bytes_per_device: float = 0.0  # irreducible state traffic (params+cache)

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float | None:
        if self.coll_bytes_per_device is None:
            return None
        return self.coll_bytes_per_device / LINK_BW

    def _terms(self) -> dict:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return {k: v for k, v in terms.items() if v is not None}

    @property
    def dominant(self) -> str:
        terms = self._terms()
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self._terms().values())

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_device * self.chips
        return self.model_flops_total / total if total else 0.0

    @property
    def memory_efficiency(self) -> float:
        """irreducible state bytes / the bytes moved: the score of
        memory-bound (decode) cells, where MFU is ~0 by construction."""
        return (self.min_bytes_per_device / self.bytes_per_device
                if self.bytes_per_device else 0.0)

    @property
    def roofline_fraction(self) -> float:
        """useful-compute time / achievable step time (the score)."""
        if self.bound_s == 0:
            return 0.0
        useful_s = self.model_flops_total / (self.chips * PEAK_FLOPS)
        return useful_s / self.bound_s

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "model_flops": self.model_flops_total,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "memory_efficiency": self.memory_efficiency,
            "coll_detail": self.coll_detail,
        }


def model_flops(cfg, shape, n_params_total: int, n_params_active: int) -> float:
    """6·N·D for train, 2·N·D for a single forward (prefill/decode step)."""
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_params_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_params_active * tokens
    # decode: one token per sequence
    return 2.0 * n_params_active * shape.global_batch


def count_params(cfg) -> tuple[int, int]:
    """(total, active) parameter counts of the model `init_lm` (or
    `encdec_init`) builds, on the meta device (no allocation): an expert
    stack's elements count top_k / n_experts active."""
    from repro_torch.launch.steps import meta_model

    total = active = 0
    for name, p in meta_model(cfg).named_parameters():
        n = math.prod(p.shape)
        total += n
        if "experts" in name.split(".") and cfg.moe is not None:
            active += int(n * cfg.moe.top_k / cfg.moe.n_experts)
        else:
            active += n
    return total, active
