"""The paper's model family: dense 6B/13B/30B baselines and their
Parallel-Track counterparts (n = 8 tracks, D in {2, 4, 8}), generated
from the dense configs by ``pt_ify`` (counterpart of
``repro.configs.pt_paper``)."""
from repro_torch.common.types import LayerSpec, ModelConfig
from repro_torch.core.track import pt_ify

_VOCAB = 100352


def _dense(name, n_layers, d, heads, kv, d_ff) -> ModelConfig:
    return ModelConfig(
        name=name,
        family="dense",
        n_layers=n_layers,
        d_model=d,
        n_heads=heads,
        n_kv_heads=kv,
        d_ff=d_ff,
        vocab_size=_VOCAB,
        layer_specs={"full": LayerSpec(mixer="gqa", mlp="swiglu")},
        pattern_unit=("full",),
        rope_theta=500_000.0,
        tie_embeddings=False,
        norm="rmsnorm",
    )


def dense_6b() -> ModelConfig:
    return _dense("dense-6b", 32, 4096, 32, 8, 11008)


def dense_13b() -> ModelConfig:
    return _dense("dense-13b", 40, 5120, 40, 8, 13824)


def dense_30b() -> ModelConfig:
    return _dense("dense-30b", 48, 7168, 64, 8, 21504)


def pt_6b(block_depth: int = 4) -> ModelConfig:
    return pt_ify(dense_6b(), 8, block_depth)


def pt_13b(block_depth: int = 4) -> ModelConfig:
    return pt_ify(dense_13b(), 8, block_depth)


def pt_30b(block_depth: int = 4) -> ModelConfig:
    return pt_ify(dense_30b(), 8, block_depth)


def reduced_dense() -> ModelConfig:
    return _dense("dense-paper-reduced", 8, 64, 8, 2, 160).replace(
        dtype="float32", attn_chunk_q=16, attn_chunk_k=16)


def reduced_pt(block_depth: int = 4) -> ModelConfig:
    return pt_ify(reduced_dense(), 4, block_depth, width_mult=16).replace(
        dtype="float32")
