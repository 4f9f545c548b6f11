"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2, Mamba+attention 1:7 interleave (1 attention layer
per 8-layer period), MoE every other layer. [arXiv:2403.19887; hf]

Deviation (as in the JAX package): Mamba layers use the Mamba2/SSD
formulation (chunk-parallel, memory-feasible at 500k ctx) with Jamba's
d_state=16. A copy of the JAX package's config."""
from .base import LayerSpec, MoEConfig, ModelConfig, SSMConfig

def _period():
    out = []
    for i in range(8):
        mixer = "attn" if i == 3 else "ssm"
        ffn = "moe" if i % 2 == 1 else "dense"
        out.append(LayerSpec(mixer=mixer, ffn=ffn))
    return tuple(out)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24_576, vocab=65_536,
    layers=_period() * 9,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24_576),
    ssm=SSMConfig(d_inner=16_384, d_state=16, n_heads=256, head_dim=64,
                  n_groups=1, chunk=64),
    tie_embeddings=False,
)

def _smoke_period():
    out = []
    for i in range(4):
        mixer = "attn" if i == 3 else "ssm"
        ffn = "moe" if i % 2 == 1 else "dense"
        out.append(LayerSpec(mixer=mixer, ffn=ffn))
    return tuple(out)

SMOKE = ModelConfig(
    name="jamba-1.5-large-398b-smoke",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512,
    layers=_smoke_period(),
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128, capacity_factor=4.0),
    ssm=SSMConfig(d_inner=128, d_state=16, n_heads=8, head_dim=16,
                  n_groups=1, chunk=16),
    tie_embeddings=False, attn_dense_max=8192, loss_chunk=64,
)
