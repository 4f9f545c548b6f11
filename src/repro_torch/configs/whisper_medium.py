"""whisper-medium [audio]: 24L(enc)+24L(dec) d_model=1024 16H d_ff=4096
vocab=51865 — enc-dec; the conv frontend is a STUB (input_specs feeds
precomputed frame embeddings at ratio 4). [arXiv:2212.04356; unverified]

Deviation noted in DESIGN.md: decoder self-attn uses RoPE instead of
Whisper's learned absolute positions (frontend+positions are stubbed)."""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab=51_865,
    layers=tuple(LayerSpec(cross_attn=True) for _ in range(24)),
    family="encdec", enc_layers=24, enc_frame_ratio=4,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="whisper-medium-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=512,
    layers=tuple(LayerSpec(cross_attn=True) for _ in range(2)),
    family="encdec", enc_layers=2, enc_frame_ratio=4,
    tie_embeddings=True, attn_dense_max=8192, loss_chunk=64,
)
