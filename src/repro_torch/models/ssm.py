"""Mamba1 selective SSM mixer, falcon-mamba (counterpart of
``repro.models.ssm``).

Layouts are the reference's: x [B, S, d]; in_proj [d, 2·di]; conv_w
[dc, di]; x_proj [di, dt_rank + 2·ds]; dt_w [dt_rank, di]; A_log
[di, ds]; out_proj [di, d]; the decode state is (conv window
[B, dc-1, di] in the model dtype, h [B, di, ds] in fp32).

The recurrence ``h_t = a_t * h_{t-1} + b_t`` of ``ssm_apply`` and
``ssm_chunk`` runs through the ``ssm_scan`` kernel (``kernels/ssm_scan``),
where the reference takes a jnp associative scan in ``ssm_apply`` and
the Pallas kernel in ``ssm_chunk``: the same function.  Every dtype
promotion JAX makes silently is written out: ``conv_w`` and ``dt_w``
are fp32, so the conv output, ``x_dbl`` and ``dt`` of prefill and chunk
are fp32 (``x_proj`` is upcast), while decode casts the conv output back
to the model dtype and upcasts only ``dt_in``.  The convolution is the
reference's shifted sum (no ``conv1d``, which cuDNN would run in TF32).
Every function here is functional; the layer writes the new state rows
into the cache in place.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.types import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.params import Leaf

State = Tuple[torch.Tensor, torch.Tensor]     # (conv window, h)


def dt_rank_of(cfg: ModelConfig) -> int:
    s = cfg.ssm
    return s.dt_rank if s.dt_rank else -(-cfg.d_model // 16)


def _a_log(shape: Tuple[int, ...]) -> torch.Tensor:
    ds = shape[-1]
    a = torch.arange(1, ds + 1, dtype=torch.float32)
    return torch.log(a).expand(shape).contiguous()


def ssm_shapes(cfg: ModelConfig, d_stream: int) -> Dict[str, Leaf]:
    """The leaves ``repro.models.ssm.ssm_init`` draws: projections normal
    * 1/sqrt(fan_in) in the model dtype; conv_w and dt_w the same in
    fp32; conv_b zeros, dt_bias softplus^-1(1), A_log log(1..ds), D ones,
    all fp32."""
    s = cfg.ssm
    di, ds, dc = s.d_inner, s.d_state, s.d_conv
    dtr = dt_rank_of(cfg)
    return {
        "in_proj": Leaf((d_stream, 2 * di), 1 / math.sqrt(d_stream)),
        "conv_w": Leaf((dc, di), 1 / math.sqrt(dc), fp32=True),
        "conv_b": Leaf((di,)),
        "x_proj": Leaf((di, dtr + 2 * ds), 1 / math.sqrt(di)),
        "dt_w": Leaf((dtr, di), 1 / math.sqrt(dtr), fp32=True),
        "dt_bias": Leaf((di,), fill=lambda shape: torch.full(
            shape, math.log(math.e - 1))),
        "A_log": Leaf((di, ds), fill=_a_log),
        "D": Leaf((di,), fill=torch.ones),
        "out_proj": Leaf((di, d_stream), 1 / math.sqrt(di)),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv as the reference's shifted sum.  x [B, S, di]
    (model dtype); w [dc, di] fp32 -> [B, S, di] fp32."""
    dc = w.shape[0]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, dc - 1, 0))
    y = sum(xp[:, i:i + S] * w[i][None, None, :] for i in range(dc))
    return y + b[None, None, :]


def _scan_inputs(params, xc: torch.Tensor, x_dbl: torch.Tensor,
                 ds: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Discretisation of prefill and chunk: xc [B, S, di] fp32, x_dbl
    [B, S, dtr + 2 ds] fp32 -> (a, b [B, S, di, ds] fp32, Ct [B, S, ds])."""
    dtr = params["dt_w"].shape[0]
    dt_in, Bt, Ct = (x_dbl[..., :dtr], x_dbl[..., dtr:dtr + ds],
                     x_dbl[..., dtr + ds:])
    dt = F.softplus((dt_in @ params["dt_w"]).float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])                          # [di, ds]
    a = (dt[..., None] * A[None, None]).exp_()               # [B,S,di,ds]
    b = (dt * xc)[..., None] * Bt.float()[:, :, None, :]
    return a, b, Ct


def _output(params, h: torch.Tensor, Ct: torch.Tensor, xc: torch.Tensor,
            z: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """y = h·C + D·x, gated by silu(z), through out_proj.  h [B, S, di, ds]
    fp32 -> [B, S, d] in ``dtype``."""
    y = torch.einsum("bsiz,bsz->bsi", h, Ct.float())
    y = (y + params["D"][None, None] * xc).to(dtype)
    return (y * F.silu(z)) @ params["out_proj"]


def ssm_apply(params, x: torch.Tensor, *, cfg: ModelConfig,
              return_cache: bool = False,
              h0: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Optional[State]]:
    """Whole-sequence forward.  x [B, S, d] -> (out [B, S, d], cache |
    None) with cache = (conv window [B, dc-1, di], h_last [B, di, ds])."""
    s = cfg.ssm
    B, S, _ = x.shape
    di, ds = s.d_inner, s.d_state
    xz = x @ params["in_proj"]
    xr, z = xz[..., :di], xz[..., di:]
    xc = F.silu(_causal_conv(xr, params["conv_w"], params["conv_b"]))
    x_dbl = xc @ params["x_proj"].float()
    a, b, Ct = _scan_inputs(params, xc, x_dbl, ds)
    if h0 is None:
        h0 = torch.zeros((B, di, ds), dtype=torch.float32, device=x.device)
    h, h_last = ops.ssm_scan(a, b, h0.float())
    del a, b
    out = _output(params, h, Ct, xc, z, x.dtype)
    if not return_cache:
        return out, None
    dc = params["conv_w"].shape[0]
    conv_state = (xr[:, S - (dc - 1):] if S >= dc - 1
                  else F.pad(xr, (0, 0, dc - 1 - S, 0)))
    return out, (conv_state.to(x.dtype).contiguous(), h_last)


def ssm_chunk(params, x: torch.Tensor, cache: State, *, cfg: ModelConfig,
              chunk_lens: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, State]:
    """Chunked-prefill step: C tokens appended to the carried state.

    x [B, C, d]; cache = (conv window [B, dc-1, di], h [B, di, ds]) rows
    of the chunk batch.  The window replaces the whole-prompt conv's zero
    left pad and h seeds the scan, so consecutive chunks compose to the
    whole-prompt recurrence.  ``chunk_lens`` [B] counts each row's valid
    tokens: padded tail positions do identity updates (a = 1, b = 0)
    before the scan, and the new window holds the last dc-1 *valid*
    inputs."""
    s = cfg.ssm
    B, C, _ = x.shape
    di, ds = s.d_inner, s.d_state
    conv_state, h0 = cache
    xz = x @ params["in_proj"]
    xr, z = xz[..., :di], xz[..., di:]
    w = params["conv_w"]
    dc = w.shape[0]
    xfull = torch.cat([conv_state.to(xr.dtype), xr], dim=1)
    y = sum(xfull[:, i:i + C] * w[i][None, None, :] for i in range(dc))
    xc = F.silu(y + params["conv_b"][None, None, :])
    x_dbl = xc @ params["x_proj"].float()
    a, b, Ct = _scan_inputs(params, xc, x_dbl, ds)
    if chunk_lens is not None:
        pad = (torch.arange(C, device=x.device)[None]
               >= chunk_lens.to(x.device)[:, None])[..., None, None]
        a.masked_fill_(pad, 1.0)
        b.masked_fill_(pad, 0.0)
    h, h_last = ops.ssm_scan(a, b, h0.float())
    del a, b
    out = _output(params, h, Ct, xc, z, x.dtype)
    lens = (torch.full((B,), C, dtype=torch.long, device=x.device)
            if chunk_lens is None else chunk_lens.to(x.device, torch.long))
    # the new window: xfull rows lens .. lens + dc - 2
    idx = lens[:, None] + torch.arange(dc - 1, device=x.device)[None, :]
    conv_new = xfull[torch.arange(B, device=x.device)[:, None], idx]
    return out, (conv_new.to(conv_state.dtype), h_last)


def ssm_decode(params, x: torch.Tensor, cache: State, *, cfg: ModelConfig,
               active: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, State]:
    """One token per row.  x [B, 1, d]; cache = (conv window, h).
    ``active`` [B] bool keeps the state of inactive lanes (idle slots,
    slots mid-chunked-prefill) as it was."""
    s = cfg.ssm
    di, ds = s.d_inner, s.d_state
    conv_state, h = cache
    xz = x[:, 0] @ params["in_proj"]
    xr, z = xz[..., :di], xz[..., di:]
    window = torch.cat([conv_state, xr[:, None]], dim=1)     # [B, dc, di]
    xc = F.silu(torch.einsum("bci,ci->bi", window.float(), params["conv_w"])
                + params["conv_b"]).to(x.dtype)
    dtr = params["dt_w"].shape[0]
    x_dbl = xc @ params["x_proj"]
    dt_in, Bt, Ct = (x_dbl[..., :dtr], x_dbl[..., dtr:dtr + ds],
                     x_dbl[..., dtr + ds:])
    dt = F.softplus(dt_in.float() @ params["dt_w"] + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    a = torch.exp(dt[..., None] * A[None])                   # [B, di, ds]
    b = (dt * xc.float())[..., None] * Bt.float()[:, None, :]
    h_new = a * h + b
    y = torch.einsum("biz,bz->bi", h_new, Ct.float())
    y = (y + params["D"][None] * xc.float()).to(x.dtype)
    out = ((y * F.silu(z)) @ params["out_proj"])[:, None]
    win_new = window[:, 1:]
    if active is not None:
        keep = ~active.to(x.device, torch.bool)
        h_new = torch.where(keep[:, None, None], h, h_new)
        win_new = torch.where(keep[:, None, None], conv_state, win_new)
    return out, (win_new, h_new)
