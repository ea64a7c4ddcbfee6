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
Nothing here imports JAX: the caller hands over numpy arrays.

A tree from the reference's ``quantize_params`` carries across too: each
of its ``QuantTensor`` leaves given as a ``(payload, scale)`` numpy pair
becomes a :class:`~repro_torch.common.quant.QuantTensor`, checked
against the quantization rule of its name (int8 payload of the weight's
shape, fp32 scale with the contraction axes collapsed to 1).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.quant import QuantTensor, weight_axes
from repro_torch.common.types import ModelConfig
from repro_torch.core.track import param_specs
from repro_torch.models.decoder import lm_param_specs, model_dtype
from repro_torch.models.params import Leaf


def _to_torch(a: Any, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes bfloat16 (2 bytes)
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def from_jax_params(tree: Any, cfg: ModelConfig,
                    device: DeviceLike = None) -> Any:
    """Numpy-leaved JAX ``init_pt`` / ``init_lm`` tree (optionally
    quantized, with ``(payload, scale)`` pairs) -> the port's parameters
    on ``device``.  Raises when the tree's keys, shapes or dtypes differ
    from what ``cfg`` describes."""
    device = resolve_device(device)
    dtype = model_dtype(cfg)

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
        t = _to_torch(node, device)
        want = spec.dtype(dtype)
        if tuple(t.shape) != tuple(spec.shape) or t.dtype != want:
            raise ValueError(f"{path}: got {tuple(t.shape)} {t.dtype}, "
                             f"want {tuple(spec.shape)} {want}")
        return t

    specs = param_specs(cfg) if cfg.pt is not None else lm_param_specs(cfg)
    return walk(specs, tree, "")
