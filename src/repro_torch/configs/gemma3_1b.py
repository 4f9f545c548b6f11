"""gemma3-1b [dense]: 26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144 —
5:1 local:global attention (window 512, global every 6th layer), dual RoPE
bases (10k local / 1M global), 128k-class context.
[hf:google/gemma-3-1b-pt; unverified]"""
from .base import LayerSpec, ModelConfig

def _layers(n, window=512):
    out = []
    for i in range(n):
        if (i + 1) % 6 == 0:
            out.append(LayerSpec(window=0, rope_theta=1_000_000.0))
        else:
            out.append(LayerSpec(window=window, rope_theta=10_000.0))
    return tuple(out)

CONFIG = ModelConfig(
    name="gemma3-1b",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
    d_ff=6912, vocab=262_144,
    layers=_layers(26),
    qk_norm=True, emb_scale_by_dim=True, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma3-1b-smoke",
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab=512,
    layers=_layers(6, window=16),
    qk_norm=True, emb_scale_by_dim=True, tie_embeddings=True,
    attn_dense_max=8192, loss_chunk=64,
)
