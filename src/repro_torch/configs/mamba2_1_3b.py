"""mamba2-1.3b [ssm]: 48L d_model=2048 attn-free, ssm_state=128 — SSD
(state-space duality), d_inner=4096, 64 heads x headdim 64, no FFN blocks.
[arXiv:2405.21060; unverified]"""
from .base import ModelConfig, SSMConfig, uniform_layers

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    n_layers=48, d_model=2048, n_heads=1, n_kv_heads=1, head_dim=64,
    d_ff=0, vocab=50_280,
    layers=uniform_layers(48, mixer="ssm", ffn="none"),
    ssm=SSMConfig(d_inner=4096, d_state=128, n_heads=64, head_dim=64,
                  n_groups=1, chunk=64),
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-1.3b-smoke",
    n_layers=2, d_model=64, n_heads=1, n_kv_heads=1, head_dim=16,
    d_ff=0, vocab=512,
    layers=uniform_layers(2, mixer="ssm", ffn="none"),
    ssm=SSMConfig(d_inner=128, d_state=32, n_heads=8, head_dim=16,
                  n_groups=1, chunk=16),
    tie_embeddings=True, attn_dense_max=8192, loss_chunk=64,
)
