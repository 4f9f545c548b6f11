"""repro_torch.kernels — the Vec-LUT mpGeMM kernels (fused, and the
unfused pipeline's integer twins) and the flash-attention forward (CUDA,
built at first use by `_build`), their plain PyTorch versions, and the
mpGeMM dispatch. Three wrappers stay in their submodules, which keep the
names: `kernels.flash_attention.flash_attention`,
`kernels.ternary_decode_gemm.ternary_decode_gemm` and
`kernels.vlut_lookup_gemm.vlut_lookup_gemm` (the JAX package exports them
at the package level, shadowing its submodules)."""
from .flash_attention import flash_attention_plain, flash_attention_trainable
from .ops import (
    DispatchConfig,
    configure_dispatch,
    dispatch_config,
    dispatch_override,
    segment_mpgemm,
    ternary_matmul,
    vlut_mpgemm,
)
from .ref import ref_mpgemm, ref_mpgemm_int, ref_segment_gemm_int
from .ternary_decode_gemm import (
    ternary_decode_gemm_fused,
    ternary_decode_gemm_fused_plain,
    ternary_decode_gemm_plain,
)
from .vlut_lookup_gemm import (
    vlut_lookup_gemm_fused,
    vlut_lookup_gemm_fused_plain,
    vlut_lookup_gemm_plain,
)

__all__ = [
    "flash_attention_plain", "flash_attention_trainable",
    "DispatchConfig", "configure_dispatch", "dispatch_config",
    "dispatch_override", "segment_mpgemm", "ternary_matmul", "vlut_mpgemm",
    "ref_mpgemm", "ref_mpgemm_int", "ref_segment_gemm_int",
    "ternary_decode_gemm_plain",
    "ternary_decode_gemm_fused", "ternary_decode_gemm_fused_plain",
    "vlut_lookup_gemm_plain",
    "vlut_lookup_gemm_fused", "vlut_lookup_gemm_fused_plain",
]
