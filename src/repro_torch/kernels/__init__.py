"""repro_torch.kernels — the Vec-LUT mpGeMM kernels (fused, and the
unfused pipeline's integer twins, each also grouped over stacked experts)
and the flash-attention forward (CUDA, built at first use by `_build`),
their plain PyTorch versions, the mpGeMM dispatch and the measured choice
of their launch plans (`autotune`). Three wrappers stay in their submodules, which keep the
names: `kernels.flash_attention.flash_attention`,
`kernels.ternary_decode_gemm.ternary_decode_gemm` and
`kernels.vlut_lookup_gemm.vlut_lookup_gemm` (the JAX package exports them
at the package level, shadowing its submodules). `LAUNCH_COUNTERS` maps
the name of every wrapper that counts its launches (``fn.launches``) to
it."""
from . import autotune
from ._build import LAUNCH_COUNTERS
from .flash_attention import flash_attention_plain, flash_attention_trainable
from .ops import (
    DispatchConfig,
    configure_dispatch,
    dispatch_config,
    dispatch_override,
    segment_mpgemm,
    ternary_matmul,
    ternary_matmul_batched,
    vlut_mpgemm,
)
from .ref import ref_mpgemm, ref_mpgemm_int, ref_segment_gemm_int
from .ternary_decode_gemm import (
    ternary_decode_gemm_fused,
    ternary_decode_gemm_fused_grouped,
    ternary_decode_gemm_fused_plain,
    ternary_decode_gemm_grouped,
    ternary_decode_gemm_plain,
)
from .vlut_lookup_gemm import (
    vlut_lookup_gemm_fused,
    vlut_lookup_gemm_fused_grouped,
    vlut_lookup_gemm_fused_plain,
    vlut_lookup_gemm_grouped,
    vlut_lookup_gemm_plain,
)

__all__ = [
    "autotune", "LAUNCH_COUNTERS",
    "flash_attention_plain", "flash_attention_trainable",
    "DispatchConfig", "configure_dispatch", "dispatch_config",
    "dispatch_override", "segment_mpgemm", "ternary_matmul", "ternary_matmul_batched",
    "vlut_mpgemm",
    "ref_mpgemm", "ref_mpgemm_int", "ref_segment_gemm_int",
    "ternary_decode_gemm_plain",
    "ternary_decode_gemm_fused", "ternary_decode_gemm_fused_plain",
    "ternary_decode_gemm_fused_grouped", "ternary_decode_gemm_grouped",
    "vlut_lookup_gemm_plain",
    "vlut_lookup_gemm_fused", "vlut_lookup_gemm_fused_plain",
    "vlut_lookup_gemm_fused_grouped", "vlut_lookup_gemm_grouped",
]
