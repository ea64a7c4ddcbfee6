"""tinyllama-1.1b [dense]: 22L d_model=2048 32H (GQA kv=4) d_ff=5632
vocab=32000 — llama2-arch small.  [arXiv:2401.02385; hf]
(counterpart of ``repro.configs.tinyllama_1_1b``)
"""
from repro_torch.common.types import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-1.1b",
        family="dense",
        n_layers=22,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        d_ff=5632,
        vocab_size=32000,
        layer_specs={"full": LayerSpec(mixer="gqa", mlp="swiglu")},
        pattern_unit=("full",),
        rope_theta=10000.0,
        tie_embeddings=False,
        norm="rmsnorm",
        norm_eps=1e-5,
    )


def reduced() -> ModelConfig:
    return config().replace(
        name="tinyllama-1.1b-reduced",
        n_layers=4, d_model=64, n_heads=8, n_kv_heads=2, d_ff=160,
        vocab_size=512, dtype="float32", attn_chunk_q=16, attn_chunk_k=16,
    )
