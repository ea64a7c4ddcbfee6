"""qwen2-vl-72b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — M-RoPE, dynamic resolution.  [arXiv:2409.12191; hf]
(counterpart of ``repro.configs.qwen2_vl_72b``)

The vision frontend is a stub: the model takes precomputed patch
embeddings [B, S, d_model] plus 3-channel (t, h, w) M-RoPE position ids
(``lm_forward``); the serving engine feeds text tokens through the
shared embedding table, whose M-RoPE streams are equal.
"""
from repro_torch.common.types import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b",
        family="vlm",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=29568,
        vocab_size=152064,
        head_dim=128,
        layer_specs={"full": LayerSpec(mixer="gqa", mlp="swiglu",
                                       rope="mrope")},
        pattern_unit=("full",),
        rope_theta=1_000_000.0,
        mrope_sections=(16, 24, 24),       # pairs per (t, h, w); sum = hd/2
        tie_embeddings=False,
        input_kind="embeds",
        norm="rmsnorm",
        norm_eps=1e-6,
    )


def reduced() -> ModelConfig:
    return config().replace(
        name="qwen2-vl-72b-reduced",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
        vocab_size=512, head_dim=16, mrope_sections=(2, 3, 3),
        dtype="float32", attn_chunk_q=16, attn_chunk_k=16,
    )
