"""RG-LRU recurrent block, recurrentgemma (counterpart of
``repro.models.rglru``).

Layouts are the reference's: x [B, S, d]; w_rec, w_gate [d, di]; conv_w
[dc, di]; the block-diagonal gate projections wa, wi [nb, bd, bd] with
biases ba, bi [di]; lam [di]; w_out [di, d]; the decode state is (conv
window [B, dc-1, di] in the model dtype, h [B, di] in fp32).  conv_w,
conv_b, wa, ba, wi, bi and lam are fp32, the three projections in the
model dtype.

The recurrence ``h_t = a_t * h_{t-1} + b_t`` of ``rglru_apply`` and
``rglru_chunk`` runs through the ``ssm_scan`` kernel
(``kernels/ssm_scan``), a and b [B, S, di] taken as its di features;
the reference scans chunks of an associative jnp scan
(``_chunked_linear_scan``), so its sums run in another order;
``rglru_apply(train=True)``, the reference's train mode on plain
differentiable ops, scans with ``ssm.linear_scan``.  The decode step is
elementwise, as in the reference.  The convolution is
the Mamba mixer's shifted sum (``ssm._causal_conv``).  Every function
here is functional; the layer writes the new state rows into the cache
in place.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.types import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.params import Leaf
from repro_torch.models.ssm import _causal_conv, linear_scan

State = Tuple[torch.Tensor, torch.Tensor]     # (conv window, h)


def n_blocks(cfg: ModelConfig) -> int:
    r = cfg.rglru
    return r.n_blocks if r.n_blocks else cfg.n_heads


def _lam(c: float, shape: Tuple[int, ...]) -> torch.Tensor:
    """Λ such that a = exp(-c softplus(Λ)) spreads over (0.9, 0.999) along
    the last axis.  The reference draws the quantiles uniformly at
    random; these are evenly spaced."""
    u = (torch.arange(shape[-1], dtype=torch.float64) + 0.5) / shape[-1]
    lam = torch.log(torch.expm1(-torch.log(u * (0.999 - 0.9) + 0.9) / c))
    return lam.to(torch.float32).expand(shape).contiguous()


def rglru_shapes(cfg: ModelConfig, d_stream: int) -> Dict[str, Leaf]:
    """The leaves ``repro.models.rglru.rglru_init`` draws: w_rec, w_gate
    and w_out normal * 1/sqrt(fan_in) in the model dtype; conv_w, wa and
    wi the same in fp32; conv_b, ba and bi zeros, and lam (``_lam``),
    all fp32."""
    r = cfg.rglru
    di, dc = r.d_inner, r.d_conv
    nb = n_blocks(cfg)
    bd = di // nb
    return {
        "w_rec": Leaf((d_stream, di), 1 / math.sqrt(d_stream)),
        "w_gate": Leaf((d_stream, di), 1 / math.sqrt(d_stream)),
        "conv_w": Leaf((dc, di), 1 / math.sqrt(dc), fp32=True),
        "conv_b": Leaf((di,)),
        "wa": Leaf((nb, bd, bd), 1 / math.sqrt(bd), fp32=True),
        "ba": Leaf((di,)),
        "wi": Leaf((nb, bd, bd), 1 / math.sqrt(bd), fp32=True),
        "bi": Leaf((di,)),
        "lam": Leaf((di,), fill=functools.partial(_lam, r.c)),
        "w_out": Leaf((di, d_stream), 1 / math.sqrt(di)),
    }


def _block_diag(u: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """u [..., di] @ the block-diagonal w [nb, bd, bd], + b -> [..., di]
    fp32."""
    nb, bd, _ = w.shape
    ur = u.reshape(*u.shape[:-1], nb, bd).float()
    out = torch.einsum("...nk,nkj->...nj", ur, w)
    return out.reshape(u.shape) + b


def _gates(params, xc: torch.Tensor, cfg: ModelConfig):
    """(a, sqrt(1 - a^2), input gate), fp32: a = exp(-c softplus(Λ) r)
    with the recurrence gate r."""
    rec = torch.sigmoid(_block_diag(xc, params["wa"], params["ba"]))
    inp = torch.sigmoid(_block_diag(xc, params["wi"], params["bi"]))
    log_a = -cfg.rglru.c * F.softplus(params["lam"]) * rec
    a = torch.exp(log_a)
    mult = torch.sqrt(-torch.expm1(2.0 * log_a))
    return a, mult, inp


def _in_proj(params, x: torch.Tensor):
    """(u, gate): the recurrent stream x @ w_rec and the tanh-GELU gate
    (in fp32, cast back to x's dtype)."""
    u = x @ params["w_rec"]
    gate = F.gelu((x @ params["w_gate"]).float(),
                  approximate="tanh").to(x.dtype)
    return u, gate


def _scan_out(params, xc: torch.Tensor, gate: torch.Tensor,
              h0: torch.Tensor, cfg: ModelConfig,
              valid: Optional[torch.Tensor] = None, train: bool = False):
    """The gates of the conv output xc [B, S, di] (x's dtype), the scan
    from h0 [B, di] through the ``ssm_scan`` kernel (``valid`` [B, S]
    False: an identity update, a = 1 and b = 0; ``train``: through the
    plain ``linear_scan``, for autograd), and the gated output
    projection.  Returns (out [B, S, d], h_last [B, di] fp32)."""
    a, mult, inp = _gates(params, xc, cfg)
    b = mult * (inp * xc.float())
    if valid is not None:
        pad = ~valid[..., None]
        a.masked_fill_(pad, 1.0)
        b.masked_fill_(pad, 0.0)
    if train:
        h = linear_scan(a, b, h0.float())
        h_last = h[:, -1]
    else:
        h, h_last = ops.ssm_scan(a, b, h0.float())
    del a, b
    return (h.to(gate.dtype) * gate) @ params["w_out"], h_last


def rglru_apply(params, x: torch.Tensor, *, cfg: ModelConfig,
                return_cache: bool = False,
                h0: Optional[torch.Tensor] = None, train: bool = False
                ) -> Tuple[torch.Tensor, Optional[State]]:
    """Whole-sequence forward.  x [B, S, d] -> (out [B, S, d], cache |
    None) with cache = (conv window [B, dc-1, di], h_last [B, di]).
    ``train``: the reference's train mode, the gates op for op (the
    gradient of sqrt(1 - a^2) grows as a nears 1), the scan plain."""
    B, S, _ = x.shape
    u, gate = _in_proj(params, x)
    xc = _causal_conv(u, params["conv_w"], params["conv_b"]).to(x.dtype)
    if h0 is None:
        h0 = torch.zeros((B, cfg.rglru.d_inner), dtype=torch.float32,
                         device=x.device)
    out, h_last = _scan_out(params, xc, gate, h0, cfg, train=train)
    if not return_cache:
        return out, None
    dc = params["conv_w"].shape[0]
    conv_state = (u[:, S - (dc - 1):] if S >= dc - 1
                  else F.pad(u, (0, 0, dc - 1 - S, 0)))
    return out, (conv_state.to(x.dtype).contiguous(), h_last)


def rglru_chunk(params, x: torch.Tensor, cache: State, *, cfg: ModelConfig,
                chunk_lens: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, State]:
    """Chunked-prefill step: C tokens appended to the carried state.

    x [B, C, d]; cache = (conv window [B, dc-1, di], h [B, di]) rows of
    the chunk batch: the window seeds the conv, h the scan.
    ``chunk_lens`` [B] counts each row's valid tokens: padded tail
    positions do identity updates and stay out of the new window, which
    holds the last dc-1 *valid* inputs."""
    B, C, _ = x.shape
    conv_state, h0 = cache
    u, gate = _in_proj(params, x)
    w = params["conv_w"]
    dc = w.shape[0]
    ufull = torch.cat([conv_state.to(u.dtype), u], dim=1)
    y = sum(ufull[:, i:i + C] * w[i][None, None, :] for i in range(dc))
    xc = (y + params["conv_b"][None, None, :]).to(x.dtype)
    valid = None
    if chunk_lens is not None:
        valid = (torch.arange(C, device=x.device)[None]
                 < chunk_lens.to(x.device)[:, None])
    out, h_last = _scan_out(params, xc, gate, h0, cfg, valid)
    lens = (torch.full((B,), C, dtype=torch.long, device=x.device)
            if chunk_lens is None else chunk_lens.to(x.device, torch.long))
    idx = lens[:, None] + torch.arange(dc - 1, device=x.device)[None, :]
    conv_new = ufull[torch.arange(B, device=x.device)[:, None], idx]
    return out, (conv_new.to(conv_state.dtype), h_last)


def rglru_decode(params, x: torch.Tensor, cache: State, *, cfg: ModelConfig,
                 active: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, State]:
    """One token per row, elementwise.  x [B, 1, d]; cache = (conv window,
    h).  ``active`` [B] bool keeps the state of inactive lanes as it
    was."""
    conv_state, h = cache
    u, gate = _in_proj(params, x[:, 0])
    window = torch.cat([conv_state, u[:, None]], dim=1)        # [B, dc, di]
    xc = (torch.einsum("bci,ci->bi", window.float(), params["conv_w"])
          + params["conv_b"]).to(x.dtype)
    a, mult, inp = _gates(params, xc, cfg)
    h_new = a * h + mult * (inp * xc.float())
    out = ((h_new.to(x.dtype) * gate) @ params["w_out"])[:, None]
    win_new = window[:, 1:]
    if active is not None:
        keep = ~active.to(x.device, torch.bool)
        h_new = torch.where(keep[:, None], h, h_new)
        win_new = torch.where(keep[:, None, None], conv_state, win_new)
    return out, (win_new, h_new)
