"""SwiGLU feed-forward over the stacked track dim (counterpart of
``repro.models.mlp``; the other activations are not ported)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def track_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [n, ..., k] @ w [n, k, m] -> [n, ..., m]: one batched GEMM for
    all tracks."""
    n = x.shape[0]
    out = torch.matmul(x.reshape(n, -1, x.shape[-1]), w)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def mlp_apply(params, x: torch.Tensor, kind: str = "swiglu") -> torch.Tensor:
    """x [n, ..., d] with weights wi_gate/wi_up [n, d, ff], wo [n, ff, d]
    -> [n, ..., d]."""
    if kind != "swiglu":
        raise NotImplementedError(
            f"mlp {kind!r} is not ported (ROADMAP queue 1, item 8)")
    g = track_matmul(x, params["wi_gate"])
    u = track_matmul(x, params["wi_up"])
    return track_matmul(F.silu(g) * u, params["wo"])
