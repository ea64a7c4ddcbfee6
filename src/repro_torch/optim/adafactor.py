"""Adafactor (Shazeer & Stern 2018): factored second moments, no first
moment, no master copy (counterpart of ``repro.optim.adafactor``, as
written there).  The statistics span a whole leaf: the RMS of the update
and the relative step size are means over a stacked leaf ([R, D, n,
...] in a PT model) as one tensor, as in the reference.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.common.pytree import tree_leaves, tree_map


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

    def upd(g, st, p):
        g = g.float()
        g2 = g * g + eps1
        if _factored(g.shape):
            vr = beta * st["vr"] + (1 - beta) * g2.mean(dim=-1)
            vc = beta * st["vc"] + (1 - beta) * g2.mean(dim=-2)
            denom = torch.clamp_min(vr.mean(dim=-1, keepdim=True), eps1)
            r = (vr / denom)[..., None]
            u = g * torch.rsqrt(r * vc[..., None, :] + eps1)
            new_st = {"vr": vr, "vc": vc}
        else:
            v = beta * st["v"] + (1 - beta) * g2
            u = g * torch.rsqrt(v + eps1)
            new_st = {"v": v}
        rms = torch.sqrt((u * u).mean() + eps1)     # update clipping by RMS
        u = u / torch.clamp_min(rms / clip_threshold, 1.0)
        scale = torch.clamp_min(torch.sqrt((p.float() ** 2).mean()), eps2)
        pf = p.float() - lr * scale * u             # relative step size
        return new_st, pf.to(p.dtype)

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
