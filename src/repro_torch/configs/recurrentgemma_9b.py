"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (kv=1) d_ff=12288
vocab=256000 — RG-LRU + local attention, 2 recurrent : 1 attention.
[arXiv:2402.19427]
(counterpart of ``repro.configs.recurrentgemma_9b``)

Pattern: (rec, rec, attn) × 12 + (rec, rec) = 38 layers.  Local attention
window 2048, MQA (1 KV head).  GeGLU MLP.  Gemma-style √d embedding
multiplier.
"""
import math

from repro_torch.common.types import LayerSpec, ModelConfig, RGLRUConfig


def config() -> ModelConfig:
    d = 4096
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        n_layers=38,
        d_model=d,
        n_heads=16,
        n_kv_heads=1,
        d_ff=12288,
        vocab_size=256000,
        head_dim=256,
        layer_specs={
            "rec": LayerSpec(mixer="rglru", mlp="geglu", rope="none"),
            "attn": LayerSpec(mixer="gqa", mlp="geglu", window=2048),
        },
        pattern_unit=("rec", "rec", "attn"),
        pattern_suffix=("rec", "rec"),
        rglru=RGLRUConfig(d_inner=4096, d_conv=4, n_blocks=16, chunk=256),
        embedding_multiplier=math.sqrt(d),
        tie_embeddings=True,
        norm="rmsnorm",
    )


def reduced() -> ModelConfig:
    return config().replace(
        name="recurrentgemma-9b-reduced",
        n_layers=8, pattern_unit=("rec", "rec", "attn"),
        pattern_suffix=("rec", "rec"),
        d_model=64, n_heads=4, n_kv_heads=1, d_ff=160, vocab_size=512,
        head_dim=16,
        rglru=RGLRUConfig(d_inner=64, d_conv=4, n_blocks=4, chunk=8),
        embedding_multiplier=8.0,
        dtype="float32", attn_chunk_q=16, attn_chunk_k=16,
        layer_specs={
            "rec": LayerSpec(mixer="rglru", mlp="geglu", rope="none"),
            "attn": LayerSpec(mixer="gqa", mlp="geglu", window=16),
        },
    )
