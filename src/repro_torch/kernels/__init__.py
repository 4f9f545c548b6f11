"""repro_torch.kernels — the fused Vec-LUT mpGeMM kernels and the
flash-attention forward (CUDA, built at first use by `_build`), their plain
PyTorch versions, and the mpGeMM dispatch. The flash wrapper itself is
`kernels.flash_attention.flash_attention` (the submodule keeps that name)."""
from .flash_attention import flash_attention_plain, flash_attention_trainable
from .ops import (
    DispatchConfig,
    configure_dispatch,
    dispatch_config,
    dispatch_override,
    ternary_matmul,
    vlut_mpgemm,
)
from .ref import ref_mpgemm, ref_mpgemm_int, ref_segment_gemm_int
from .ternary_decode_gemm import ternary_decode_gemm_fused, ternary_decode_gemm_fused_plain
from .vlut_lookup_gemm import vlut_lookup_gemm_fused, vlut_lookup_gemm_fused_plain

__all__ = [
    "flash_attention_plain", "flash_attention_trainable",
    "DispatchConfig", "configure_dispatch", "dispatch_config",
    "dispatch_override", "ternary_matmul", "vlut_mpgemm",
    "ref_mpgemm", "ref_mpgemm_int", "ref_segment_gemm_int",
    "ternary_decode_gemm_fused", "ternary_decode_gemm_fused_plain",
    "vlut_lookup_gemm_fused", "vlut_lookup_gemm_fused_plain",
]
