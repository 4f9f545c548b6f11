"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 routed top-1 + 1 shared expert, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from .base import LayerSpec, MoEConfig, ModelConfig, uniform_layers

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=202_048,
    layers=uniform_layers(48, mixer="attn", ffn="moe", rope_theta=500_000.0),
    moe=MoEConfig(n_experts=16, top_k=1, d_ff_expert=8192, n_shared=1),
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="llama4-scout-17b-a16e-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512,
    layers=uniform_layers(2, mixer="attn", ffn="moe", rope_theta=500_000.0),
    moe=MoEConfig(n_experts=4, top_k=1, d_ff_expert=128, n_shared=1, capacity_factor=4.0),
    tie_embeddings=False, attn_dense_max=8192, loss_chunk=64,
)
