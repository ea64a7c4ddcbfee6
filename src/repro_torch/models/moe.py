"""Mixture-of-experts MLP: shared + routed experts, capacity-based
dispatch (counterpart of ``repro.models.moe``, single process: the
reference's mesh branch, its expert-parallel all-to-alls and its
Megatron-sharded shared experts wait for ROADMAP queue 1, item 7).

One call routes every row of x [B, S, d] together (T = B * S rows:
at decode every engine lane, the idle ones too, as in the reference):

  1. the router: fp32 logits x @ router [d, E]; 'softmax' takes the top
     k of the softmax, 'sigmoid_bias' (DeepSeek-V3, aux-free) the top k
     of sigmoid + e_bias and weighs them by the sigmoid; with
     ``norm_topk_prob`` the k weights are normalised, then scaled by
     ``routed_scaling_factor``.  The top k are in ``lax.top_k``'s order:
     descending, the lower expert first on a tie (a stable sort);
  2. dispatch: each (token, j) pair takes the next free position of its
     expert in token-major order (a cumsum over the flattened [T, k]
     one-hot), and is dropped at or past the capacity
     ``max(4, ceil(T k cf / E) rounded up to 4)``; the kept rows are
     gathered into an [E, cap, d] buffer (an inverse index: a slot's
     token, row T being a zero row, so unused slots hold zeros);
  3. every expert's SwiGLU FFN over its [cap, d] rows: three batched
     products over the [E, cap, d] buffer (the reference computes them
     outside any Pallas kernel too, so every expert's weights are read);
  4. combine: y = sum_j w_j o_j in j's order, each weight cast to the
     activation dtype first; a dropped pair reads the zero row E * cap;
  5. the shared experts, a SwiGLU of width n_shared * d_expert on every
     row, added.
Nothing depends on the data's values through the host (no ``.item()``,
no ``nonzero``, no data-dependent shape): a decode step with MoE layers
captures into a CUDA graph.

The serving tree keeps the ``n_routed_experts`` real experts: a
reference tree stored padded to ``n_experts_padded`` loses its padded
rows and router columns in ``weights.from_jax_params`` (they are never
routed to).  The train tree keeps the reference's stored layout
(``moe_shapes(padded=True)``: ``e_store(cfg)`` rows), since Adafactor's
statistics are means over a whole leaf and checkpoints cross between the
packages: every function here reads the first ``n_routed_experts``
experts and router columns of whichever tree it gets (the reference
masks the others' logits to -1e30, which gives them probability 0 and
never selects them; their FFN sees only zero rows), so a padded
expert's grads are exact zeros, as the reference's.

``moe_train`` is the train mode: the same routing and dispatch on ops
autograd differentiates (into x through the packed rows' gather, into
the router through the gathered top-k weights), and the reference's
auxiliary load-balancing loss beside the output: for the softmax router
``aux_loss_coef * E * sum(f * pbar)``, f the mean count of each expert
among the top k (no gradient) and pbar the mean probability; for
'sigmoid_bias' exactly 0 (``e_bias`` only steers the top k, so its
gradient is exactly 0; the reference updates no bias and neither does
the port).

``track_drops(device)`` turns on the drop counters: every call on that
device then adds its routed (token, expert) pairs and its dropped ones,
on the device, under its phase ('prefill', 'decode' or 'chunk');
``drop_counts()`` reads them.  A device's counters are allocated once
and kept (zeroed in place when tracking starts again), so a CUDA graph
captured while counting goes on adding to live memory.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.types import ModelConfig
from repro_torch.models.params import Leaf

PHASES = ("prefill", "decode", "chunk")
# device -> int64 [phase, (routed pairs, dropped pairs)], kept once made
_DROPS: Dict[torch.device, torch.Tensor] = {}
_TRACKED: List[Optional[torch.device]] = [None]   # the counting device


def track_drops(device: Optional[torch.device]) -> None:
    """Count routed and dropped (token, expert) pairs of the calls on
    ``device`` from now on, from zero; ``None`` stops counting.  Call it
    outside any CUDA graph capture."""
    _TRACKED[0] = None
    if device is None:
        return
    device = torch.device(device)
    if device in _DROPS:
        _DROPS[device].zero_()
    else:
        _DROPS[device] = torch.zeros(len(PHASES), 2, dtype=torch.int64,
                                     device=device)
    _TRACKED[0] = device


def drop_counts() -> Dict[str, Dict[str, int]]:
    """{phase: {'routed': n, 'dropped': n}} since ``track_drops`` (empty
    when not counting)."""
    if _TRACKED[0] is None:
        return {}
    return {p: {"routed": r, "dropped": d}
            for p, (r, d) in zip(PHASES, _DROPS[_TRACKED[0]].tolist())}


def e_store(cfg: ModelConfig) -> int:
    """Experts in the reference's stored tree (padding included)."""
    m = cfg.moe
    return max(m.n_routed_experts, m.n_experts_padded)


def moe_shapes(cfg: ModelConfig, d_stream: int,
               padded: bool = False) -> Dict[str, Leaf]:
    """The MoE MLP's leaves, as ``repro.models.moe.moe_init`` draws them
    but for the ``n_routed_experts`` real experts only (``padded``: all
    ``e_store(cfg)`` of the reference's stored layout): router [d, E]
    fp32, w_gate / w_up [E, d, de], w_down [E, de, d], e_bias [E] fp32
    zeros ('sigmoid_bias'), the shared experts' ws_gate / ws_up [d, ds]
    and ws_down [ds, d] (ds = n_shared * de).  The expert stacks draw one
    matrix at a time (``Leaf.by_matrix``)."""
    m = cfg.moe
    E = e_store(cfg) if padded else m.n_routed_experts
    de, d = m.d_expert, d_stream
    p = {"router": Leaf((d, E), 1 / math.sqrt(d), fp32=True),
         "w_gate": Leaf((E, d, de), 1 / math.sqrt(d), by_matrix=True),
         "w_up": Leaf((E, d, de), 1 / math.sqrt(d), by_matrix=True),
         "w_down": Leaf((E, de, d), 1 / math.sqrt(de), by_matrix=True)}
    if m.router == "sigmoid_bias":
        p["e_bias"] = Leaf((E,))
    if m.n_shared_experts > 0:
        ds = m.n_shared_experts * de
        p["ws_gate"] = Leaf((d, ds), 1 / math.sqrt(d))
        p["ws_up"] = Leaf((d, ds), 1 / math.sqrt(d))
        p["ws_down"] = Leaf((ds, d), 1 / math.sqrt(ds))
    return p


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert for a call of ``n_tokens`` rows."""
    m = cfg.moe
    c = math.ceil(max(1, n_tokens) * m.top_k * m.capacity_factor
                  / m.n_routed_experts)
    return max(4, -(-c // 4) * 4)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest, descending, the
    lower index first among equals."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(params, x2: torch.Tensor, cfg: ModelConfig,
           with_aux: bool = False
           ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """x2 [T, d] -> (weights [T, k] fp32, expert ids [T, k] int64, the
    auxiliary loss (an fp32 scalar) with ``with_aux``, else None).  Only
    the first E = ``n_routed_experts`` router columns are read."""
    m = cfg.moe
    E = m.n_routed_experts
    logits = x2.float() @ params["router"][:, :E].float()       # [T, E]
    aux = None
    if m.router == "sigmoid_bias":
        scores = torch.sigmoid(logits)
        _, idx = _top_k(scores + params["e_bias"][None, :E], m.top_k)
        w = torch.gather(scores, -1, idx)
        if with_aux:
            aux = torch.zeros((), dtype=torch.float32, device=x2.device)
    else:
        probs = torch.softmax(logits, dim=-1)
        w, idx = _top_k(probs, m.top_k)
        if with_aux:
            f = F.one_hot(idx, E).float().sum(dim=1).mean(dim=0)
            aux = m.aux_loss_coef * E * torch.sum(f * probs.mean(dim=0))
    if m.norm_topk_prob:
        w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-20)
    return w * m.routed_scaling_factor, idx, aux


def _dispatch_indices(idx: torch.Tensor, E: int, cap: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """idx [T, k] expert ids -> (slot [T, k] into the flat [E * cap]
    buffer, E * cap where dropped; keep [T, k])."""
    T, k = idx.shape
    flat = F.one_hot(idx.reshape(-1), E).to(torch.int32)        # [T k, E]
    pos = ((torch.cumsum(flat, dim=0, dtype=torch.int32) - flat) * flat
           ).sum(-1).reshape(T, k)
    keep = pos < cap
    slot = torch.where(keep, idx * cap + pos, torch.full_like(idx, E * cap))
    return slot, keep


def _pack(x2: torch.Tensor, slot: torch.Tensor, n_slots: int
          ) -> torch.Tensor:
    """The [n_slots, d] buffer: slot s holds the row of the token routed
    to it, zeros where none is.  Dropped pairs write the trash entry
    n_slots, which is never read."""
    T, k = slot.shape
    tok = torch.full((n_slots + 1,), T, dtype=torch.int64, device=x2.device)
    src = torch.arange(T, device=x2.device)[:, None].expand(T, k)
    tok.scatter_(0, slot.reshape(-1), src.reshape(-1))
    rows = torch.cat([x2, x2.new_zeros(1, x2.shape[1])])
    return rows[tok[:n_slots]]


def _expert_ffn(params, buf: torch.Tensor) -> torch.Tensor:
    """buf [E, cap, d] -> [E, cap, d]: each of the first E experts'
    SwiGLU."""
    E = buf.shape[0]
    g = torch.bmm(buf, params["w_gate"][:E])
    u = torch.bmm(buf, params["w_up"][:E])
    return torch.bmm(F.silu(g) * u, params["w_down"][:E])


def _moe(params, x: torch.Tensor, cfg: ModelConfig, phase: Optional[str],
         with_aux: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    B, S, d = x.shape
    m = cfg.moe
    E = m.n_routed_experts
    T = B * S
    x2 = x.reshape(T, d)
    cap = capacity(T, cfg)
    w, idx, aux = _route(params, x2, cfg, with_aux)
    slot, keep = _dispatch_indices(idx, E, cap)
    if phase is not None and _TRACKED[0] == x.device:
        row = _DROPS[x.device][PHASES.index(phase)]
        row[0].add_(keep.numel())
        row[1].add_((~keep).sum())
    out = _expert_ffn(params, _pack(x2, slot, E * cap).reshape(E, cap, d))
    out = torch.cat([out.reshape(E * cap, d), out.new_zeros(1, d)])
    y = torch.zeros_like(x2)
    for j in range(m.top_k):
        y = y + w[:, j, None].to(x.dtype) * out[slot[:, j]]
    if m.n_shared_experts > 0:
        h = F.silu(x2 @ params["ws_gate"]) * (x2 @ params["ws_up"])
        y = y + h @ params["ws_down"]
    return y.reshape(B, S, d), aux


def moe_apply(params, x: torch.Tensor, *, cfg: ModelConfig,
              phase: str = "prefill") -> torch.Tensor:
    """x [B, S, d] -> y [B, S, d] in x's dtype (every row routed in one
    capacity pool).  ``phase`` names the drop counter the call adds to."""
    return _moe(params, x, cfg, phase, False)[0]


def moe_train(params, x: torch.Tensor, *, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train mode: x [B, S, d] -> (y [B, S, d], aux fp32 scalar), the
    reference's ``moe_apply`` on one process, for autograd (no drop
    counter)."""
    return _moe(params, x, cfg, None, True)
