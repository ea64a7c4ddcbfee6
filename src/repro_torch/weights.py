"""Parameter bridge from the JAX package's trees (no JAX counterpart).

``from_jax_params`` takes the tree ``repro.core.track.init_pt`` builds,
with its leaves turned into numpy arrays (``np.asarray``), and returns
the port's parameters with the same nesting and the same layouts:
embed [V, d], head [d, V], blocks leaves [R, D, n, ...] with
wq [d, H, hd], wk/wv [d, KH, hd], wo [H, hd, d], mlp wi_gate/wi_up
[d, ff], wo [ff, d], and fp32 norm scales.  Nothing here imports JAX:
the caller hands over numpy arrays.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.types import ModelConfig
from repro_torch.core.track import param_specs
from repro_torch.models.decoder import model_dtype


def _to_torch(a: Any, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes bfloat16 (2 bytes)
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def from_jax_params(tree: Any, cfg: ModelConfig,
                    device: DeviceLike = None) -> Any:
    """Numpy-leaved JAX ``init_pt`` tree -> the port's parameters on
    ``device``.  Raises when the tree's keys, shapes or dtypes differ
    from what ``cfg`` describes."""
    device = resolve_device(device)
    dtype = model_dtype(cfg)

    def walk(spec, node, path):
        if isinstance(spec, dict):
            if not isinstance(node, dict) or set(node) != set(spec):
                raise ValueError(f"{path or 'params'}: want keys "
                                 f"{sorted(spec)}")
            return {k: walk(spec[k], node[k], f"{path}.{k}".lstrip("."))
                    for k in spec}
        if spec == ():
            if len(node):
                raise ValueError(f"{path}: expected an empty tail")
            return ()
        shape, std = spec
        t = _to_torch(node, device)
        want = torch.float32 if std is None else dtype
        if tuple(t.shape) != tuple(shape) or t.dtype != want:
            raise ValueError(f"{path}: got {tuple(t.shape)} {t.dtype}, "
                             f"want {tuple(shape)} {want}")
        return t

    return walk(param_specs(cfg), tree, "")
