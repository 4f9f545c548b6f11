"""deepseek-v3-671b [moe]: 61L d_model=7168 128H MLA d_ff=2048(routed)
vocab=129280, 1 shared + 256 routed top-8, aux-loss-free routing, first 3
layers dense (d_ff 18432). A copy of the JAX package's config.
[arXiv:2412.19437; hf]"""
from .base import LayerSpec, MLAConfig, MoEConfig, ModelConfig

_DENSE = LayerSpec(mixer="mla", ffn="dense", d_ff=18_432)
_MOE = LayerSpec(mixer="mla", ffn="moe")

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=2048, vocab=129_280,
    layers=(_DENSE,) * 3 + (_MOE,) * 58,
    moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048, n_shared=1,
                  router_aux_free=True),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128,
                  qk_rope_dim=64, v_dim=128),
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="deepseek-v3-671b-smoke",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=96, vocab=512,
    layers=(LayerSpec(mixer="mla", ffn="dense", d_ff=160),)
    + (LayerSpec(mixer="mla", ffn="moe"),) * 2,
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=96, n_shared=1,
                  router_aux_free=True, capacity_factor=4.0),
    mla=MLAConfig(q_lora_rank=48, kv_lora_rank=32, qk_nope_dim=16,
                  qk_rope_dim=8, v_dim=16),
    tie_embeddings=False, attn_dense_max=8192, loss_chunk=64,
)
