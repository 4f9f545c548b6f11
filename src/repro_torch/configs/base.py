"""Model/system configuration dataclasses.

A copy of the JAX package's `repro.configs.base` dataclasses, so the port
imports nothing of that package: every architecture is a `ModelConfig`
built from per-layer `LayerSpec`s. The port runs the layers in a Python
loop (models/decoder.py), one module per layer.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0            # 0 → d_ff_expert
    capacity_factor: float = 1.25
    router_aux_free: bool = False   # DeepSeek aux-loss-free bias routing
    aux_loss_weight: float = 0.01
    router_z_weight: float = 1e-3


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_dim: int
    qk_rope_dim: int
    v_dim: int


@dataclass(frozen=True)
class SSMConfig:
    d_inner: int
    d_state: int
    n_heads: int
    head_dim: int
    n_groups: int = 1
    d_conv: int = 4
    chunk: int = 64
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclass(frozen=True)
class LayerSpec:
    """Static per-layer structure. Equal specs at a fixed period compress
    into one scanned stage."""
    mixer: str = "attn"             # 'attn' | 'mla' | 'ssm'
    window: int = 0                 # 0 = full/global attention
    rope_theta: float = 10_000.0
    ffn: str = "dense"              # 'dense' | 'moe' | 'none'
    d_ff: int = 0                   # 0 → cfg.d_ff (deepseek dense-layer size)
    cross_attn: bool = False        # decoder cross-attention (enc-dec)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    layers: tuple[LayerSpec, ...] = ()
    family: str = "lm"              # 'lm' | 'encdec'
    # sub-configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # encoder (enc-dec only)
    enc_layers: int = 0
    enc_frame_ratio: int = 4        # stub frontend downsampling (whisper conv)
    # attention details
    qk_norm: bool = False
    attn_bias: bool = False
    attn_logit_softcap: float = 0.0
    # embeddings / head
    tie_embeddings: bool = True
    emb_scale_by_dim: bool = False  # gemma-style sqrt(d) embedding scale
    # quantization (the paper's technique)
    quant: str = "ternary"          # 'ternary' | 'none'
    pack_mode: str = "auto"         # 'i1' | 'i2' | 'auto'
    # numerics / memory policy
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    attn_chunk: int = 512           # online-softmax kv-chunk for long seqs
    attn_dense_max: int = 2048      # use dense attention below this seq len
    attn_impl: str = "auto"         # 'auto' | 'flash' (Pallas kernel on TPU)
    loss_chunk: int = 2048          # sequence chunking for the CE loss
    remat: bool = True
    remat_policy: str = "full"      # 'full' | 'dots' (save dot outputs) 
    # serving
    max_cache_len: int = 0          # set per-shape by the launcher
    cache_in_carry: bool = False    # scan-carry KV cache (in-place update;
                                    # halves decode HBM traffic — see §Perf)
    moe_shard_capacity: bool = False  # REFUTED variant kept for the §Perf log
    moe_block_dispatch: bool = False  # block-local dispatch positions (§Perf
                                      # 4.2: keeps scatter/gather data-local)

    # -- derived -----------------------------------------------------------
    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def layer_specs(self) -> tuple[LayerSpec, ...]:
        if self.layers:
            assert len(self.layers) == self.n_layers
            return self.layers
        return tuple(LayerSpec() for _ in range(self.n_layers))


def uniform_layers(
    n: int, mixer: str = "attn", ffn: str = "dense", **kw
) -> tuple[LayerSpec, ...]:
    return tuple(LayerSpec(mixer=mixer, ffn=ffn, **kw) for _ in range(n))


@dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell of the dry run's matrix."""
    name: str                       # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                       # 'train' | 'prefill' | 'decode'


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
