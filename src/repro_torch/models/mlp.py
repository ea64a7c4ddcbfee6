"""Feed-forward layers over the stacked track dim (counterpart of
``repro.models.mlp``): SwiGLU, GeGLU (tanh-approximate GELU gate), the
GELU MLP (up, tanh-approximate GELU, down; whisper) and the squared-ReLU
MLP (up, relu^2, down).  The last two have no gate.  int8 weights
(``QuantTensor`` leaves) go through the W8A16 kernel."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common import quant
from repro_torch.models.params import Leaf

MLPS = ("swiglu", "geglu", "gelu", "sqrelu")


def mlp_shapes(kind: str, d_model: int, d_ff: int):
    """Per-track weight specs, as ``repro.models.mlp.mlp_init`` draws
    them: a gated MLP has wi_gate, wi_up and wo; gelu and sqrelu wi_up
    and wo."""
    w_in = Leaf((d_model, d_ff), 1 / d_model ** 0.5)
    w_out = Leaf((d_ff, d_model), 1 / d_ff ** 0.5)
    if kind in ("swiglu", "geglu"):
        return {"wi_gate": w_in, "wi_up": w_in, "wo": w_out}
    if kind in ("gelu", "sqrelu"):
        return {"wi_up": w_in, "wo": w_out}
    raise ValueError(f"unknown mlp {kind!r}")


def mlp_apply(params, x: torch.Tensor, kind: str = "swiglu") -> torch.Tensor:
    """x [n, ..., d] with weights wi_gate/wi_up [n, d, ff], wo [n, ff, d]
    -> [n, ..., d]: one batched product per weight for all tracks."""
    if kind not in MLPS:
        raise ValueError(f"unknown mlp {kind!r}")
    u = quant.matmul(x, params["wi_up"])
    if kind == "sqrelu":
        h = F.relu(u).square()
    elif kind == "gelu":
        h = F.gelu(u, approximate="tanh")
    else:
        g = quant.matmul(x, params["wi_gate"])
        act = F.silu(g) if kind == "swiglu" else F.gelu(g, approximate="tanh")
        h = act * u
    return quant.matmul(h, params["wo"])
