"""smollm-360m [dense]: 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152
— llama-arch small. [hf:HuggingFaceTB/SmolLM-360M; hf]"""
from .base import ModelConfig, uniform_layers

CONFIG = ModelConfig(
    name="smollm-360m",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, head_dim=64,
    d_ff=2560, vocab=49_152,
    layers=uniform_layers(32),
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="smollm-360m-smoke",
    n_layers=2, d_model=60, n_heads=3, n_kv_heads=1, head_dim=20,
    d_ff=160, vocab=512,
    layers=uniform_layers(2),
    tie_embeddings=True, attn_dense_max=8192, loss_chunk=64,
)
