"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144 — 5:1 local:global, 128k context, qk-norm, no softcaps.
[hf:google/gemma-3-4b-pt]
(counterpart of ``repro.configs.gemma3_4b``)

Pattern: (5 × local + 1 × global) × 5 + 4 × local = 34 layers.  Local
window 1024 with rope theta 10k; global layers theta 1M.
"""
import math

from repro_torch.common.types import LayerSpec, ModelConfig


def config() -> ModelConfig:
    d = 2560
    return ModelConfig(
        name="gemma3-4b",
        family="dense",
        n_layers=34,
        d_model=d,
        n_heads=8,
        n_kv_heads=4,
        d_ff=10240,
        vocab_size=262144,
        layer_specs={
            "local": LayerSpec(mixer="gqa", mlp="geglu", window=1024,
                               rope="local_rope"),
            "global": LayerSpec(mixer="gqa", mlp="geglu"),
        },
        pattern_unit=("local", "local", "local", "local", "local", "global"),
        pattern_suffix=("local", "local", "local", "local"),
        qk_norm=True,
        post_norm=True,
        rope_theta=1_000_000.0,
        local_rope_theta=10000.0,
        embedding_multiplier=math.sqrt(d),
        tie_embeddings=True,
        norm="rmsnorm",
    )


def reduced() -> ModelConfig:
    return config().replace(
        name="gemma3-4b-reduced",
        n_layers=10, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
        vocab_size=512, embedding_multiplier=8.0,
        pattern_suffix=("local", "local", "local", "local"),
        dtype="float32", attn_chunk_q=16, attn_chunk_k=16,
        layer_specs={
            "local": LayerSpec(mixer="gqa", mlp="geglu", window=16,
                               rope="local_rope"),
            "global": LayerSpec(mixer="gqa", mlp="geglu"),
        },
    )
