"""chameleon-34b [vlm]: 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536 — early fusion, VQ image tokens share the text vocab (frontend
stub: inputs are token ids), QK-norm. [arXiv:2405.09818; unverified]"""
from .base import ModelConfig, uniform_layers

CONFIG = ModelConfig(
    name="chameleon-34b",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22_016, vocab=65_536,
    layers=uniform_layers(48),
    qk_norm=True, tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="chameleon-34b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512,
    layers=uniform_layers(2),
    qk_norm=True, tie_embeddings=False, attn_dense_max=8192, loss_chunk=64,
)
