"""nemotron-4-15b [dense]: 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000 — GQA, squared-ReLU MLP (no gate), LayerNorm.
[arXiv:2402.16819]
(counterpart of ``repro.configs.nemotron_4_15b``)
"""
from repro_torch.common.types import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b",
        family="dense",
        n_layers=32,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=24576,
        vocab_size=256000,
        layer_specs={"full": LayerSpec(mixer="gqa", mlp="sqrelu")},
        pattern_unit=("full",),
        rope_theta=10000.0,
        tie_embeddings=False,
        norm="layernorm",
        norm_eps=1e-5,
    )


def reduced() -> ModelConfig:
    return config().replace(
        name="nemotron-4-15b-reduced",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=512, dtype="float32", attn_chunk_q=16, attn_chunk_k=16,
    )
