"""gemma2-2b [dense]: 26L d_model=2304 8H (GQA kv=4) d_ff=9216
vocab=256000 — local+global alternating, logit softcaps.  [arXiv:2408.00118]
(counterpart of ``repro.configs.gemma2_2b``)

head_dim derived as d_model / n_heads = 288 (the HF release uses 256 with
an unfused head width; we keep the spec-derived value).  Pre+post norms
(sandwich), attention softcap 50, final logit softcap 30, window 4096.
"""
import math

from repro_torch.common.types import LayerSpec, ModelConfig


def config() -> ModelConfig:
    d = 2304
    return ModelConfig(
        name="gemma2-2b",
        family="dense",
        n_layers=26,
        d_model=d,
        n_heads=8,
        n_kv_heads=4,
        d_ff=9216,
        vocab_size=256000,
        layer_specs={
            "local": LayerSpec(mixer="gqa", mlp="geglu", window=4096,
                               rope="local_rope", attn_logit_softcap=50.0),
            "global": LayerSpec(mixer="gqa", mlp="geglu",
                                attn_logit_softcap=50.0),
        },
        pattern_unit=("local", "global"),
        post_norm=True,
        final_logit_softcap=30.0,
        embedding_multiplier=math.sqrt(d),
        tie_embeddings=True,
        norm="rmsnorm",
    )


def reduced() -> ModelConfig:
    return config().replace(
        name="gemma2-2b-reduced",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
        vocab_size=512, embedding_multiplier=8.0,
        dtype="float32", attn_chunk_q=16, attn_chunk_k=16,
        layer_specs={
            "local": LayerSpec(mixer="gqa", mlp="geglu", window=16,
                               rope="local_rope", attn_logit_softcap=50.0),
            "global": LayerSpec(mixer="gqa", mlp="geglu",
                                attn_logit_softcap=50.0),
        },
    )
