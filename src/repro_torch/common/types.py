"""Config dataclasses (the port's own copy of ``repro.common.types``).

Only what the ported serving and train paths read is kept: ``MoEConfig``,
``MLAConfig``, ``PTConfig``, ``SSMConfig``, ``RGLRUConfig``,
``EncDecConfig`` (whisper's encoder stack), ``LayerSpec`` and
``ModelConfig`` with the fields ``pt_ify`` and the models touch.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Mapping, Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts MLP (shared + routed, capacity-based dispatch)."""

    n_routed_experts: int
    n_shared_experts: int
    top_k: int
    d_expert: int                      # per-expert FFN hidden dim
    router: str = "softmax"            # 'softmax' (+aux loss) |
                                       # 'sigmoid_bias' (aux-free)
    capacity_factor: float = 1.25
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = True
    aux_loss_coef: float = 0.001
    # storage padding of the expert axis in the reference's tree, so that
    # it divides an expert-parallel mesh (deepseek-v2: 160 experts padded
    # to 256); padded experts are never routed to.  The port's train tree
    # keeps them (the reference's layout); its serving tree keeps the
    # n_routed_experts real experts only (``weights.from_jax_params``
    # and ``weights.drop_expert_padding`` drop the padding).
    n_experts_padded: int = 0


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention."""

    kv_lora_rank: int                  # compressed KV dim (c_kv)
    q_lora_rank: int                   # 0 => full-rank Q projection
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclass(frozen=True)
class PTConfig:
    """Parallel-Track parameters (the paper's contribution)."""

    n_tracks: int
    block_depth: int                   # D: layers between cross-track fusions
    fusion_op: str = "mean"            # 'mean' | 'sum'
    fuse_final: bool = True            # fuse after the last block


@dataclass(frozen=True)
class SSMConfig:
    """Mamba1 selective-state-space mixer."""

    d_inner: int
    d_state: int = 16
    d_conv: int = 4
    dt_rank: int = 0                   # 0 => ceil(d_model / 16)
    chunk: int = 256                   # sequential chunk for the train scan


@dataclass(frozen=True)
class RGLRUConfig:
    """RG-LRU recurrent block (RecurrentGemma / Griffin)."""

    d_inner: int                       # width of the recurrent stream
    d_conv: int = 4
    n_blocks: int = 0                  # block-diagonal gate projections;
                                       # 0 => n_heads
    c: float = 8.0                     # gate sharpness constant
    chunk: int = 256


@dataclass(frozen=True)
class EncDecConfig:
    """Encoder stack configuration for encoder-decoder models (whisper)."""

    n_enc_layers: int
    cross_attn: bool = True
    enc_window: Optional[int] = None


@dataclass(frozen=True)
class LayerSpec:
    """One transformer-layer flavour referenced by the layer pattern."""

    mixer: str                         # 'gqa' (PT), 'mla', 'mamba' and
                                       # 'rglru' are ported
    mlp: str                           # 'swiglu' (PT), 'geglu', 'gelu',
                                       # 'sqrelu', 'moe' and 'none' are
                                       # ported
    window: Optional[int] = None
    rope: str = "rope"                 # 'rope' | 'mrope' | 'local_rope' | 'none'
    attn_logit_softcap: Optional[float] = None
    causal: bool = True                # False for encoder layers (whisper)
    cross_attn: bool = False           # decoder cross-attention (whisper)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 => d_model // n_heads

    layer_specs: Mapping[str, LayerSpec] = field(default_factory=dict)
    pattern_prefix: Tuple[str, ...] = ()
    pattern_unit: Tuple[str, ...] = ("full",)
    pattern_repeat: int = 0            # 0 => derived from n_layers
    pattern_suffix: Tuple[str, ...] = ()

    norm: str = "rmsnorm"
    norm_eps: float = 1e-6
    post_norm: bool = False
    qk_norm: bool = False
    final_logit_softcap: Optional[float] = None
    embedding_multiplier: float = 1.0
    tie_embeddings: bool = True

    rope_theta: float = 10000.0
    local_rope_theta: float = 10000.0  # theta of ``rope="local_rope"`` layers
    mrope_sections: Tuple[int, ...] = ()   # M-RoPE (t, h, w) pairs; sum
                                           # = head_dim // 2

    # sub-configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    pt: Optional[PTConfig] = None
    encdec: Optional[EncDecConfig] = None

    input_kind: str = "tokens"         # 'tokens' | 'embeds' (vlm stub)

    dtype: str = "bfloat16"
    attn_chunk_q: int = 512            # blockwise attention's chunks
    attn_chunk_k: int = 1024           # (train mode)
    remat: bool = True                 # activation checkpointing on the
                                       # scanned unit (train mode)
    remat_policy: str = "nothing"      # 'nothing' | 'dots' (matmul outputs
                                       # kept)
    logits_fp32: bool = True

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.pattern_repeat == 0:
            body = (self.n_layers - len(self.pattern_prefix)
                    - len(self.pattern_suffix))
            if self.pattern_unit:
                if body % len(self.pattern_unit) != 0:
                    raise ValueError(
                        f"{self.name}: pattern does not tile n_layers "
                        f"({body} % {len(self.pattern_unit)} != 0)")
                object.__setattr__(self, "pattern_repeat",
                                   body // len(self.pattern_unit))
        got = (len(self.pattern_prefix) + len(self.pattern_suffix)
               + self.pattern_repeat * len(self.pattern_unit))
        if got != self.n_layers:
            raise ValueError(f"{self.name}: pattern covers {got} layers, "
                             f"config says {self.n_layers}")
        if not self.layer_specs:
            object.__setattr__(self, "layer_specs",
                               {"full": LayerSpec(mixer="gqa", mlp="swiglu")})
        for nm in (*self.pattern_prefix, *self.pattern_unit,
                   *self.pattern_suffix):
            if nm not in self.layer_specs:
                raise ValueError(
                    f"{self.name}: pattern references unknown spec {nm!r}")

    def spec(self, name: str) -> LayerSpec:
        return self.layer_specs[name]

    @property
    def layer_names(self) -> Tuple[str, ...]:
        return (tuple(self.pattern_prefix)
                + tuple(self.pattern_unit) * self.pattern_repeat
                + tuple(self.pattern_suffix))

    def replace(self, **kw) -> "ModelConfig":
        if "n_layers" in kw and "pattern_repeat" not in kw:
            kw.setdefault("pattern_repeat", 0)
        return dataclasses.replace(self, **kw)
