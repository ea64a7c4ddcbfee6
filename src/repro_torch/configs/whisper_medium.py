"""whisper-medium [audio]: 24L d_model=1024 16H (kv=16) d_ff=4096
vocab=51865 — enc-dec, conv frontend (stub).  [arXiv:2212.04356]
(counterpart of ``repro.configs.whisper_medium``)

The conv/mel frontend is a STUB: the encoder consumes precomputed frame
embeddings [B, 1500, d].  Fixed sinusoidal positions on both stacks
(deviation: the real decoder uses learned positions).  24 encoder +
24 decoder layers; decoder layers carry cross-attention.
"""
from repro_torch.common.types import EncDecConfig, LayerSpec, ModelConfig

ENC_FRAMES = 1500       # 30 s of audio at 50 Hz after the conv frontend


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium",
        family="audio",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=4096,
        vocab_size=51865,
        layer_specs={
            "dec": LayerSpec(mixer="gqa", mlp="gelu", rope="none",
                             cross_attn=True),
            "enc": LayerSpec(mixer="gqa", mlp="gelu", rope="none",
                             causal=False),
        },
        pattern_unit=("dec",),
        encdec=EncDecConfig(n_enc_layers=24),
        norm="layernorm",
        norm_eps=1e-5,
        tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return config().replace(
        name="whisper-medium-reduced",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=512, encdec=EncDecConfig(n_enc_layers=2),
        dtype="float32", attn_chunk_q=16, attn_chunk_k=16,
    )
