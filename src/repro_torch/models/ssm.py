"""Mamba1 selective SSM mixer, falcon-mamba (counterpart of
``repro.models.ssm``).

Layouts are the reference's: x [B, S, d]; in_proj [d, 2·di]; conv_w
[dc, di]; x_proj [di, dt_rank + 2·ds]; dt_w [dt_rank, di]; A_log
[di, ds]; out_proj [di, d]; the decode state is (conv window
[B, dc-1, di] in the model dtype, h [B, di, ds] in fp32).

The discretisation, the chunk mask, the recurrence ``h_t = a_t *
h_{t-1} + b_t`` and the ``C`` contraction of ``ssm_apply`` and
``ssm_chunk`` run through the ``ssm_scan`` kernel's selective route
(``kernels/ssm_scan.py::selective_scan``), so a, b and h [B, S, di, ds]
never reach device memory; on the CPU its plain version is the unfused
composition, the reference's (which takes a jnp associative scan in
``ssm_apply`` and the Pallas kernel in ``ssm_chunk``: the same
function).  ``ssm_apply(train=True)`` is the reference's train mode on
plain differentiable ops, a, b and h [B, S, di, ds] in memory: the
recurrence through ``linear_scan``, which no kernel runs.  Every dtype
promotion JAX makes silently is written out:
``conv_w`` and ``dt_w`` are fp32, so the conv output, ``x_dbl`` and
``dt`` of prefill and chunk are fp32 (``x_proj`` is upcast), while
decode casts the conv output back to the model dtype and upcasts only
``dt_in``.  The convolution is the reference's shifted sum (no
``conv1d``, which cuDNN would run in TF32).  Every function here is
functional; the layer writes the new state rows into the cache in
place.
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


class _LinearScan(torch.autograd.Function):
    """h_t = a_t * h_{t-1} + b_t over axis 1, step by step, with its
    gradient written out: dh_t = g_t + a_{t+1} dh_{t+1} backwards from
    the last step, then da_t = dh_t h_{t-1}, db_t = dh_t, dh0 = a_0 dh_0.
    Saves a, h and h0 (autograd over the loop would keep every step's
    operands and run several ops a step)."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h = torch.empty_like(b)
        prev = h0
        for t in range(a.shape[1]):
            prev = torch.addcmul(b[:, t], a[:, t], prev, out=h[:, t])
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        a, h, h0 = ctx.saved_tensors
        dh = g.clone()
        for t in range(a.shape[1] - 2, -1, -1):
            dh[:, t].addcmul_(a[:, t + 1], dh[:, t + 1])
        da = dh * torch.cat([h0[:, None], h[:, :-1]], dim=1)
        return da, dh, a[:, 0] * dh[:, 0]


def linear_scan(a: torch.Tensor, b: torch.Tensor,
                h0: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t over axis 1 on plain ops, differentiable
    (the train modes' scan; no kernel).  a, b [B, S, ...] fp32, h0 [B,
    ...] -> h [B, S, ...].  The reference's
    ``_chunked_linear_scan`` runs an associative scan within chunks of
    ``chunk`` steps and carries h across them: the same recurrence summed
    in another order.  A sequential scan gives the same sums wherever
    chunks begin, so it has none."""
    return _LinearScan.apply(a, b, h0)


def _scan(params, xc: torch.Tensor, x_dbl: torch.Tensor, ds: int,
          h0: torch.Tensor, lens: Optional[torch.Tensor] = None,
          train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Discretisation, recurrence and ``C`` contraction of prefill and
    chunk: xc [B, S, di] fp32, x_dbl [B, S, dtr + 2 ds] fp32, h0 [B, di,
    ds], ``lens`` [B] valid tokens a row or None -> (y = h·C [B, S, di]
    fp32, h_last [B, di, ds] fp32).  ``train``: the reference's
    decomposition on plain ops, a = exp(dt A), b = dt x B,
    ``linear_scan``, y = h C (no ``lens``)."""
    dtr = params["dt_w"].shape[0]
    dt_in, Bt, Ct = (x_dbl[..., :dtr], x_dbl[..., dtr:dtr + ds],
                     x_dbl[..., dtr + ds:])
    dt = F.softplus((dt_in @ params["dt_w"]).float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])                          # [di, ds]
    if not train:
        return ops.selective_scan(dt, xc, A, Bt, Ct, h0.float(), lens)
    a = torch.exp(dt[..., None] * A[None, None])             # [B, S, di, ds]
    b = (dt * xc)[..., None] * Bt[:, :, None, :]
    h = linear_scan(a, b, h0.float())
    del a, b
    return torch.einsum("bsiz,bsz->bsi", h, Ct), h[:, -1]


def _output(params, y: torch.Tensor, xc: torch.Tensor, z: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """y + D·x, gated by silu(z), through out_proj.  y = h·C [B, S, di]
    fp32 -> [B, S, d] in ``dtype``."""
    y = (y + params["D"][None, None] * xc).to(dtype)
    return (y * F.silu(z)) @ params["out_proj"]


def ssm_apply(params, x: torch.Tensor, *, cfg: ModelConfig,
              return_cache: bool = False,
              h0: Optional[torch.Tensor] = None, train: bool = False
              ) -> Tuple[torch.Tensor, Optional[State]]:
    """Whole-sequence forward.  x [B, S, d] -> (out [B, S, d], cache |
    None) with cache = (conv window [B, dc-1, di], h_last [B, di, ds]).
    ``train``: the reference's train mode, on plain differentiable ops
    (``_scan(train=True)``), for autograd."""
    s = cfg.ssm
    B, S, _ = x.shape
    di, ds = s.d_inner, s.d_state
    xz = x @ params["in_proj"]
    xr, z = xz[..., :di], xz[..., di:]
    xc = F.silu(_causal_conv(xr, params["conv_w"], params["conv_b"]))
    x_dbl = xc @ params["x_proj"].float()
    if h0 is None:
        h0 = torch.zeros((B, di, ds), dtype=torch.float32, device=x.device)
    y, h_last = _scan(params, xc, x_dbl, ds, h0, train=train)
    out = _output(params, y, xc, z, x.dtype)
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
    tokens: padded tail positions do identity updates (a = 1, b = 0) in
    the scan, and the new window holds the last dc-1 *valid* inputs."""
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
    y, h_last = _scan(params, xc, x_dbl, ds, h0,
                      None if chunk_lens is None else chunk_lens.to(x.device))
    out = _output(params, y, xc, z, x.dtype)
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
