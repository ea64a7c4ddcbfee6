"""Parameter bridge from the JAX package's trees (no JAX counterpart).

``from_jax_params`` takes the tree ``repro.core.track.init_pt`` (a PT
config) or ``repro.models.decoder.init_lm`` (any other config) builds,
with its leaves turned into numpy arrays (``np.asarray``), and returns
the port's parameters with the same nesting and the same layouts.  PT:
embed [V, d], head [d, V], blocks leaves [R, D, n, ...] with wq
[d, H, hd], wk/wv [d, KH, hd], wo [H, hd, d], mlp wi_gate/wi_up [d, ff],
wo [ff, d].  lm_*: embed, head, and the prefix / unit / suffix layer
tuples, unit leaves stacked [R, ...]; a Mamba layer's conv_w, conv_b,
dt_w, dt_bias, A_log and D stay fp32.  Norm scales are fp32 everywhere.
An MLA layer's mixer carries w_dq / q_norm / w_uq (or w_uq alone at
q_lora_rank 0), w_dkv, kv_norm, w_uk, w_uv and wo; a MoE layer's MLP
its router (fp32), e_bias (fp32, the sigmoid_bias router), expert stacks
w_gate / w_up / w_down and shared experts ws_gate / ws_up / ws_down.  A
reference tree that stores its experts padded to ``n_experts_padded``
loses the padded experts (router columns, e_bias entries, expert rows)
in the serving tree: they are never routed to.  ``padded=True`` keeps
them: the train tree, in the reference's stored layout.
Nothing here imports JAX: the caller hands over numpy arrays.

``from_jax_state`` carries a whole train state across, {"params": ...,
"opt": ...} with the optimizer state of the reference's ``adamw_init``
(step, fp32 m / v / master with the params' structure) or
``adafactor_init`` (step, fp32 factored statistics), so that both
packages can start training from one state; params, moments and
statistics in the train tree's layout, padded experts included.  The
train tree goes back to the reference through a checkpoint
(``checkpoint/store.py``, the same layout), and to the serving tree
through ``drop_expert_padding``.

A tree from the reference's ``quantize_params`` carries across too: each
of its ``QuantTensor`` leaves given as a ``(payload, scale)`` numpy pair
becomes a :class:`~repro_torch.common.quant.QuantTensor`, checked
against the quantization rule of its name (int8 payload of the weight's
shape, fp32 scale with the contraction axes collapsed to 1).
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.pytree import map_with_path
from repro_torch.common.quant import QuantTensor, weight_axes
from repro_torch.common.types import ModelConfig
from repro_torch.core.track import param_specs
from repro_torch.models.decoder import lm_param_specs, model_dtype
from repro_torch.models.moe import e_store
from repro_torch.models.params import Leaf


def _to_torch(a: Any, device: torch.device) -> torch.Tensor:
    a = np.array(a, order="C")              # a copy; a scalar stays 0-d
    if a.dtype.name == "bfloat16":          # ml_dtypes bfloat16 (2 bytes)
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


# the expert axis of each MoE leaf (its padding is dropped)
_EXPERT_AXIS = {"router": -1, "e_bias": -1, "w_gate": -3, "w_up": -3,
                "w_down": -3}


def _is_expert_leaf(path: str) -> bool:
    keys = path.replace("/", ".").split(".")
    return len(keys) > 1 and keys[-2] == "mlp" and keys[-1] in _EXPERT_AXIS


def from_jax_params(tree: Any, cfg: ModelConfig,
                    device: DeviceLike = None,
                    dtype: Optional[torch.dtype] = None,
                    padded: bool = False) -> Any:
    """Numpy-leaved JAX ``init_pt`` / ``init_lm`` tree (optionally
    quantized, with ``(payload, scale)`` pairs) -> the port's parameters
    on ``device`` (the serving tree, or with ``padded`` the train tree).
    Raises when the tree's keys, shapes or dtypes differ from what
    ``cfg`` describes; ``dtype`` set: every leaf must be of that dtype
    (an optimizer's fp32 moments)."""
    device = resolve_device(device)
    model = model_dtype(cfg)
    n_exp = (cfg.moe.n_routed_experts if cfg.moe is not None and not padded
             else 0)

    def quantized(shape, node, path):
        keys = path.split(".")
        axes = weight_axes(keys[-1], keys[-2] if len(keys) > 1 else "")
        if axes is None:
            raise ValueError(f"{path}: no int8 rule for this weight")
        payload, scale = (_to_torch(a, device) for a in node)
        want = tuple(1 if i - len(shape) in axes else s
                     for i, s in enumerate(shape))
        if tuple(payload.shape) != tuple(shape) \
                or payload.dtype != torch.int8 \
                or tuple(scale.shape) != want \
                or scale.dtype != torch.float32:
            raise ValueError(f"{path}: got payload {tuple(payload.shape)} "
                             f"{payload.dtype}, scale {tuple(scale.shape)} "
                             f"{scale.dtype}; want int8 {tuple(shape)}, "
                             f"fp32 {want}")
        return QuantTensor(payload, scale)

    def walk(spec, node, path):
        if isinstance(spec, dict):
            if not isinstance(node, dict) or set(node) != set(spec):
                raise ValueError(f"{path or 'params'}: want keys "
                                 f"{sorted(spec)}")
            return {k: walk(spec[k], node[k], f"{path}.{k}".lstrip("."))
                    for k in spec}
        if isinstance(spec, tuple):
            if not isinstance(node, (tuple, list)) or len(node) != len(spec):
                raise ValueError(f"{path}: want a sequence of {len(spec)}")
            return tuple(walk(sp, nd, f"{path}.{i}")
                         for i, (sp, nd) in enumerate(zip(spec, node)))
        assert isinstance(spec, Leaf), spec
        if isinstance(node, tuple):
            return quantized(spec.shape, node, path)
        if n_exp and _is_expert_leaf(path):
            node = np.take(np.asarray(node), np.arange(n_exp),
                           axis=_EXPERT_AXIS[path.rsplit(".", 1)[-1]])
        t = _to_torch(node, device)
        want = dtype or spec.dtype(model)
        if tuple(t.shape) != tuple(spec.shape) or t.dtype != want:
            raise ValueError(f"{path}: got {tuple(t.shape)} {t.dtype}, "
                             f"want {tuple(spec.shape)} {want}")
        return t

    specs = (param_specs(cfg) if cfg.pt is not None
             else lm_param_specs(cfg, padded))
    return walk(specs, tree, "")


def drop_expert_padding(params: Any, cfg: ModelConfig) -> Any:
    """The serving tree of a train tree (or of a checkpoint's params): each
    MoE leaf cut to its ``n_routed_experts`` real experts (copies, so
    that the padded leaf can be freed); other leaves as they are."""
    if cfg.moe is None or e_store(cfg) == cfg.moe.n_routed_experts:
        return params
    n = cfg.moe.n_routed_experts

    def cut(path, leaf):
        if not _is_expert_leaf(path):
            return leaf
        return leaf.narrow(_EXPERT_AXIS[path.rsplit("/", 1)[-1]], 0,
                           n).clone()

    return map_with_path(cut, params)


def _generic(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _generic(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_generic(v, device) for v in tree)
    return _to_torch(tree, device)


def from_jax_state(state: Any, cfg: ModelConfig,
                   device: DeviceLike = None) -> Any:
    """Numpy-leaved train state {"params": tree, "opt": optimizer state}
    of the reference -> the port's train state, on ``device`` (the train
    tree: a MoE's padded experts kept).  AdamW's m, v and master are
    checked against the params' specs in fp32; Adafactor's statistics are
    carried as they are."""
    device = resolve_device(device)
    opt = state["opt"]
    out = {"step": _to_torch(opt["step"], device)}
    if out["step"].dtype != torch.int32 or out["step"].dim():
        raise ValueError("opt/step: want an int32 scalar")
    for key, node in opt.items():
        if key == "stats":
            out[key] = _generic(node, device)
        elif key != "step":
            out[key] = from_jax_params(node, cfg, device, torch.float32,
                                       padded=True)
    return {"params": from_jax_params(state["params"], cfg, device,
                                      padded=True),
            "opt": out}
