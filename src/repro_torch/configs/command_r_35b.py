"""command-r-35b [dense]: 40L d_model=8192 64H (GQA kv=8) d_ff=22528
vocab=256000 — GQA, no-bias. [hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from .base import ModelConfig, uniform_layers

CONFIG = ModelConfig(
    name="command-r-35b",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22_528, vocab=256_000,
    layers=uniform_layers(40, rope_theta=8_000_000.0),
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="command-r-35b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=160, vocab=512,
    layers=uniform_layers(2, rope_theta=8_000_000.0),
    tie_embeddings=True, attn_dense_max=8192, loss_chunk=64,
)
