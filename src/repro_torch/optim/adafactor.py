"""Adafactor (Shazeer & Stern 2018): factored second moments, no first
moment, no master copy (counterpart of ``repro.optim.adafactor``, as
written there).  The statistics span a whole leaf: the RMS of the update
and the relative step size are means over a stacked leaf ([R, D, n,
...] in a PT model, [E, d, f] for a MoE's experts, padded ones
included) as one tensor, as in the reference; the factored second
moments are per trailing matrix (per expert).

A factored leaf of more than ``_SLICE_NUMEL`` values with leading dims
(a MoE's expert stack: [256, 5120, 1536] at deepseek-v2's width, whose
fp32 temporaries take 8 GB each) is updated a slice of its leading
matrices at a time, in two passes: the first computes each slice's
statistics and update and sums u^2 and p^2 over the whole leaf, the
second recomputes the update and applies the whole leaf's clip and
step size.  The same ops per matrix; only the two whole-leaf means are
summed in another order.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.common.pytree import tree_leaves, tree_map

_SLICE_NUMEL = 1 << 28     # values of a leaf updated a slice at a time


def _factored(shape) -> bool:
    return len(shape) >= 2


def adafactor_init(params) -> Dict[str, Any]:
    def stat(l):
        z = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                      device=l.device)
        if _factored(l.shape):
            return {"vr": z(l.shape[:-1]),
                    "vc": z(l.shape[:-2] + l.shape[-1:])}
        return {"v": z(l.shape)}

    device = tree_leaves(params)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "stats": tree_map(stat, params)}


def _is_stat(node) -> bool:
    return isinstance(node, dict) and ("vr" in node or "v" in node)


@torch.no_grad()
def adafactor_update(grads, state, params, lr, *, decay: float = 0.8,
                     eps1: float = 1e-30, eps2: float = 1e-3,
                     clip_threshold: float = 1.0
                     ) -> Tuple[Any, Dict[str, Any]]:
    step = state["step"] + 1
    t = step.float()
    beta = 1.0 - t ** (-decay)

    def factored_u(g, vr0, vc0):
        g = g.float()
        g2 = g * g + eps1
        vr = beta * vr0 + (1 - beta) * g2.mean(dim=-1)
        vc = beta * vc0 + (1 - beta) * g2.mean(dim=-2)
        denom = torch.clamp_min(vr.mean(dim=-1, keepdim=True), eps1)
        r = (vr / denom)[..., None]
        return g * torch.rsqrt(r * vc[..., None, :] + eps1), vr, vc

    def step_p(p, u, rms, scale):
        u = u / torch.clamp_min(rms / clip_threshold, 1.0)
        return (p.float() - lr * scale * u).to(p.dtype)  # relative step

    def upd(g, st, p):
        if _factored(g.shape):
            if g.dim() > 2 and g.numel() > _SLICE_NUMEL:
                return upd_sliced(g, st, p)
            u, vr, vc = factored_u(g, st["vr"], st["vc"])
            new_st = {"vr": vr, "vc": vc}
        else:
            g = g.float()
            v = beta * st["v"] + (1 - beta) * (g * g + eps1)
            u = g * torch.rsqrt(v + eps1)
            new_st = {"v": v}
        rms = torch.sqrt((u * u).mean() + eps1)     # update clipping by RMS
        scale = torch.clamp_min(torch.sqrt((p.float() ** 2).mean()), eps2)
        return new_st, step_p(p, u, rms, scale)

    def upd_sliced(g, st, p):
        rows, cols = g.shape[-2:]
        g3, p3 = g.reshape(-1, rows, cols), p.reshape(-1, rows, cols)
        vr0 = st["vr"].reshape(-1, rows)
        vc0 = st["vc"].reshape(-1, cols)
        n = max(1, _SLICE_NUMEL // (rows * cols))
        parts = [slice(i, i + n) for i in range(0, g3.shape[0], n)]
        vr, vc = torch.empty_like(vr0), torch.empty_like(vc0)
        usq = psq = torch.zeros((), dtype=torch.float32, device=g.device)
        for sl in parts:
            u, vr[sl], vc[sl] = factored_u(g3[sl], vr0[sl], vc0[sl])
            usq = usq + (u * u).sum()
            psq = psq + (p3[sl].float() ** 2).sum()
            del u
        rms = torch.sqrt(usq / g.numel() + eps1)
        scale = torch.clamp_min(torch.sqrt(psq / g.numel()), eps2)
        out = torch.empty_like(p3)
        for sl in parts:
            u = factored_u(g3[sl], vr0[sl], vc0[sl])[0]
            out[sl] = step_p(p3[sl], u, rms, scale)
            del u
        return ({"vr": vr.reshape(st["vr"].shape),
                 "vc": vc.reshape(st["vc"].shape)}, out.reshape(p.shape))

    def walk(g, st, p):
        if _is_stat(st):
            return upd(g, st, p)
        if isinstance(st, dict):
            pairs = {k: walk(g[k], st[k], p[k]) for k in st}
            return ({k: s for k, (s, _) in pairs.items()},
                    {k: q for k, (_, q) in pairs.items()})
        pairs = [walk(gi, si, pi) for gi, si, pi in zip(g, st, p)]
        kind = tuple if isinstance(st, tuple) else list
        return kind(s for s, _ in pairs), kind(q for _, q in pairs)

    stats, new_params = walk(grads, state["stats"], params)
    return new_params, {"step": step, "stats": stats}
