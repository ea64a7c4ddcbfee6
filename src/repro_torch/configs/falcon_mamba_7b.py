"""falcon-mamba-7b [ssm]: 64L d_model=4096 (attention-free) vocab=65024,
ssm_state=16 — Mamba1 architecture.  [arXiv:2410.05355]
(counterpart of ``repro.configs.falcon_mamba_7b``)

d_inner = 2·d_model = 8192, conv 4, dt_rank = d_model/16 = 256.  The
mixer IS the layer (no separate MLP).  Decode state is O(1) in sequence
length: per layer a conv window [3, 8192] in the model dtype and the SSM
state [8192, 16] in fp32.
"""
from repro_torch.common.types import LayerSpec, ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b",
        family="ssm",
        n_layers=64,
        d_model=4096,
        n_heads=1,
        n_kv_heads=1,
        d_ff=0,
        vocab_size=65024,
        head_dim=64,
        layer_specs={"m": LayerSpec(mixer="mamba", mlp="none", rope="none")},
        pattern_unit=("m",),
        ssm=SSMConfig(d_inner=8192, d_state=16, d_conv=4, dt_rank=256,
                      chunk=256),
        tie_embeddings=False,
        norm="rmsnorm",
        norm_eps=1e-5,
    )


def reduced() -> ModelConfig:
    return config().replace(
        name="falcon-mamba-7b-reduced",
        n_layers=4, d_model=64, d_ff=0, vocab_size=512, head_dim=16,
        ssm=SSMConfig(d_inner=128, d_state=4, d_conv=4, dt_rank=8, chunk=8),
        dtype="float32", attn_chunk_q=16, attn_chunk_k=16,
    )
