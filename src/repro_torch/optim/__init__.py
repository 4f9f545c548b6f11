"""repro_torch.optim — AdamW (+ row-wise int8 states) and its schedule."""
from .adamw import (
    AdamWConfig,
    QTensor,
    adamw_init,
    adamw_update,
    dequantize_blockwise,
    global_norm,
    lr_at,
    quantize_blockwise,
)

__all__ = [
    "AdamWConfig", "QTensor", "adamw_init", "adamw_update",
    "dequantize_blockwise", "global_norm", "lr_at", "quantize_blockwise",
]
