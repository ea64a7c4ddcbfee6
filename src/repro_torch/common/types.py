"""Config dataclasses (the port's own copy of ``repro.common.types``).

Only what the ported serving paths read is kept: ``PTConfig``,
``SSMConfig``, ``LayerSpec`` and ``ModelConfig`` with the fields
``pt_ify`` and the models touch.  The sub-configs of the other mixers
(MoE, MLA, RG-LRU, encoder-decoder) are not ported yet (ROADMAP queue 1,
item 3); their fields stay so a config reads the same, and must be None.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional, Tuple


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
class LayerSpec:
    """One transformer-layer flavour referenced by the layer pattern."""

    mixer: str                         # 'gqa' (PT) and 'mamba' are ported
    mlp: str                           # 'swiglu' (PT) and 'none' are ported
    window: Optional[int] = None
    rope: str = "rope"
    attn_logit_softcap: Optional[float] = None
    causal: bool = True
    cross_attn: bool = False


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

    # sub-configs; only ``ssm`` and ``pt`` are ported
    moe: Optional[Any] = None
    mla: Optional[Any] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[Any] = None
    pt: Optional[PTConfig] = None
    encdec: Optional[Any] = None

    dtype: str = "bfloat16"
    attn_chunk_q: int = 512            # kept for config parity; unused
    attn_chunk_k: int = 1024
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
