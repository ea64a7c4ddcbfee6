"""deepseek-v2-236b [moe]: 60L d_model=5120 128H d_ff(expert)=1536
vocab=102400 — MLA kv_lora=512, 2 shared + 160 routed top-6, softmax
router with aux load-balance loss.  [arXiv:2405.04434; hf]
(counterpart of ``repro.configs.deepseek_v2_236b``)

First layer dense (d_ff 12288); remaining 59 MoE.
"""
from repro_torch.common.types import (LayerSpec, MLAConfig, ModelConfig,
                                     MoEConfig)


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        d_ff=12288,                       # dense-prefix FFN width
        vocab_size=102400,
        head_dim=128,
        layer_specs={
            "dense": LayerSpec(mixer="mla", mlp="swiglu"),
            "moe": LayerSpec(mixer="mla", mlp="moe"),
        },
        pattern_prefix=("dense",),
        pattern_unit=("moe",),
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        moe=MoEConfig(n_routed_experts=160, n_shared_experts=2, top_k=6,
                      d_expert=1536, router="softmax",
                      capacity_factor=1.25, routed_scaling_factor=16.0,
                      norm_topk_prob=False, aux_loss_coef=0.003,
                      n_experts_padded=256),    # 256-way EP storage padding
        rope_theta=10000.0,
        tie_embeddings=False,
        norm="rmsnorm",
    )


def reduced() -> ModelConfig:
    return config().replace(
        name="deepseek-v2-236b-reduced",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160,
        vocab_size=512, head_dim=16,
        pattern_prefix=("dense",),
        mla=MLAConfig(kv_lora_rank=16, q_lora_rank=0, qk_nope_head_dim=8,
                      qk_rope_head_dim=4, v_head_dim=8),
        moe=MoEConfig(n_routed_experts=8, n_shared_experts=2, top_k=2,
                      d_expert=32, router="softmax", capacity_factor=2.0,
                      norm_topk_prob=False),
        dtype="float32", attn_chunk_q=16, attn_chunk_k=16,
    )
