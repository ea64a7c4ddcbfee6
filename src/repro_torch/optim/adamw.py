"""AdamW with an fp32 master copy for bf16 params (counterpart of
``repro.optim.adamw``), operation for operation.

State: {step, m, v, master?}; m and v are fp32 trees with the params'
structure.  When any param is bf16 an fp32 master copy is kept and
updated, and the params become its cast.  The weight decay sits inside
the update, as the reference has it (``torch.optim.AdamW`` decays in a
separate multiply first and divides by the bias corrections in another
order, so it is not this arithmetic).

``adamw_update`` works in place: m, v and the master (the params
themselves when there is no master) are rewritten, each op rounding
where the reference's op rounds; it returns the params and the new
state.  A large leaf is updated a slice of ``CHUNK`` elements at a time,
which changes no bit (every op is elementwise) and bounds the fp32
temporaries of a multi-GB leaf.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.common.pytree import tree_leaves, tree_map

CHUNK = 1 << 26


def _is_bf16(tree) -> bool:
    return any(leaf.dtype == torch.bfloat16 for leaf in tree_leaves(tree))


def adamw_init(params) -> Dict[str, Any]:
    device = tree_leaves(params)[0].device
    zeros = lambda t: tree_map(
        lambda l: torch.zeros(l.shape, dtype=torch.float32, device=l.device),
        t)
    state = {"step": torch.zeros((), dtype=torch.int32, device=device),
             "m": zeros(params), "v": zeros(params)}
    if _is_bf16(params):
        state["master"] = tree_map(
            lambda l: l.detach().to(torch.float32, copy=True), params)
    return state


def _flat(t: torch.Tensor) -> torch.Tensor:
    if not t.is_contiguous():
        raise ValueError("optimizer state leaves must be contiguous")
    return t.view(-1)


def _leaf(g, m, v, pf, c1, c2, lr, b1, b2, eps, weight_decay) -> None:
    """One slice: m, v and pf (fp32) rewritten in place."""
    g = g.float()
    m.mul_(b1).add_((1 - b1) * g)                  # b1 m + (1 - b1) g
    v.mul_(b2).add_((1 - b2) * g * g)              # b2 v + (1 - b2) g g
    u = m / c1                                     # mhat
    d = v / c2                                     # vhat
    d.sqrt_().add_(eps)                            # sqrt(vhat) + eps
    u.div_(d).add_(weight_decay * pf)              # mhat / (..) + wd pf
    pf.sub_(u.mul_(lr))                            # pf - lr (..)


@torch.no_grad()
def adamw_update(grads, state, params, lr, *, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1) -> Tuple[Any, Dict[str, Any]]:
    step = state["step"] + 1
    t = step.float()
    c1 = 1.0 - b1 ** t
    c2 = 1.0 - b2 ** t
    master = state.get("master", params)
    for g, m, v, pf in zip(tree_leaves(grads), tree_leaves(state["m"]),
                           tree_leaves(state["v"]), tree_leaves(master)):
        if pf.dtype != torch.float32:
            raise ValueError("AdamW updates fp32 params or an fp32 master")
        g, m, v, pf = g.reshape(-1), _flat(m), _flat(v), _flat(pf)
        for lo in range(0, g.numel(), CHUNK):
            hi = lo + CHUNK
            _leaf(g[lo:hi], m[lo:hi], v[lo:hi], pf[lo:hi], c1, c2, lr,
                  b1, b2, eps, weight_decay)
    new_state = {"step": step, "m": state["m"], "v": state["v"]}
    if "master" in state:
        new_state["master"] = master
        for nm, p in zip(tree_leaves(master), tree_leaves(params)):
            p.copy_(nm)                            # the master's cast
    return params, new_state
