"""internlm2-1.8b [dense]: 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92544. [arXiv:2403.17297; hf]"""
from .base import ModelConfig, uniform_layers

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=92_544,
    layers=uniform_layers(24, rope_theta=1_000_000.0),
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="internlm2-1.8b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512,
    layers=uniform_layers(2, rope_theta=1_000_000.0),
    tie_embeddings=False, attn_dense_max=8192, loss_chunk=64,
)
