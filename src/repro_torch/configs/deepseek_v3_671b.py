"""deepseek-v3-671b [moe]: 61L d_model=7168 128H d_ff(expert)=2048
vocab=129280 — MLA (kv_lora 512, rope 64), 1 shared + 256 routed top-8,
aux-free sigmoid-bias routing.  [arXiv:2412.19437; hf]
(counterpart of ``repro.configs.deepseek_v3_671b``)

First 3 layers are dense (d_ff 18432); the remaining 58 are MoE.  The
assigned d_ff=2048 is the routed-expert hidden dim.  The MTP head is not
implemented.
"""
from repro_torch.common.types import (LayerSpec, MLAConfig, ModelConfig,
                                     MoEConfig)


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=128,
        n_kv_heads=128,
        d_ff=18432,                       # dense-prefix FFN width
        vocab_size=129280,
        head_dim=128,
        layer_specs={
            "dense": LayerSpec(mixer="mla", mlp="swiglu"),
            "moe": LayerSpec(mixer="mla", mlp="moe"),
        },
        pattern_prefix=("dense", "dense", "dense"),
        pattern_unit=("moe",),
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        moe=MoEConfig(n_routed_experts=256, n_shared_experts=1, top_k=8,
                      d_expert=2048, router="sigmoid_bias",
                      capacity_factor=1.25, routed_scaling_factor=2.5,
                      norm_topk_prob=True),
        rope_theta=10000.0,
        tie_embeddings=False,
        norm="rmsnorm",
    )


def reduced() -> ModelConfig:
    return config().replace(
        name="deepseek-v3-671b-reduced",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160,
        vocab_size=512, head_dim=16,
        pattern_prefix=("dense",),
        mla=MLAConfig(kv_lora_rank=16, q_lora_rank=24, qk_nope_head_dim=8,
                      qk_rope_head_dim=4, v_head_dim=8),
        moe=MoEConfig(n_routed_experts=8, n_shared_experts=1, top_k=2,
                      d_expert=32, router="sigmoid_bias",
                      capacity_factor=2.0, routed_scaling_factor=2.5),
        dtype="float32", attn_chunk_q=16, attn_chunk_k=16,
    )
