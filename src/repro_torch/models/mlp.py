"""SwiGLU feed-forward over the stacked track dim (counterpart of
``repro.models.mlp``; the other activations are not ported).  int8
weights (``QuantTensor`` leaves) go through the W8A16 kernel."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common import quant


def mlp_apply(params, x: torch.Tensor, kind: str = "swiglu") -> torch.Tensor:
    """x [n, ..., d] with weights wi_gate/wi_up [n, d, ff], wo [n, ff, d]
    -> [n, ..., d]: one batched product per weight for all tracks."""
    if kind != "swiglu":
        raise NotImplementedError(
            f"mlp {kind!r} is not ported (ROADMAP queue 1, item 3)")
    g = quant.matmul(x, params["wi_gate"])
    u = quant.matmul(x, params["wi_up"])
    return quant.matmul(F.silu(g) * u, params["wo"])
