"""Greedy token sampling, the fused decode-step epilogue and the
speculative step's greedy accept, and the pipelined engine's device-side
carry of the next step's inputs (``advance_decode`` / ``advance_spec``)
(counterpart of ``repro.serving.sampler``).

Sampling with ``temperature > 0`` needs keys bit-exact with JAX's
threefry stream (``row_keys``) and is ROADMAP queue 1, item 4: every
entry point here checks the host-side temperatures and raises for it.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SampleParams:
    temperature: float = 0.0          # 0 => greedy (the only ported mode)
    top_k: int = 0
    top_p: float = 1.0


def stack_params(params: Sequence[SampleParams]
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """[SampleParams] -> (temperature [B] f32, top_k [B] i32, top_p [B] f32),
    host arrays."""
    return (np.asarray([p.temperature for p in params], np.float32),
            np.asarray([p.top_k for p in params], np.int32),
            np.asarray([p.top_p for p in params], np.float32))


def require_greedy(temperature) -> None:
    """Raise for any row with temperature > 0 (host-side check, no
    device sync)."""
    if np.any(np.asarray(temperature) > 0.0):
        raise NotImplementedError(
            "sampling with temperature > 0 is not ported: it needs keys "
            "bit-exact with the reference's threefry stream (ROADMAP "
            "queue 1, item 4)")


def sample_rows(logits: torch.Tensor, temperature) -> torch.Tensor:
    """logits [B, V] -> tokens [B] int32.  Greedy: the first maximal
    index, as jnp.argmax picks (no top-k substitute).  ``temperature``
    is the host array of per-row temperatures (all must be 0)."""
    require_greedy(temperature)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample_step(logits: torch.Tensor, temperature, active: torch.Tensor,
                eos: torch.Tensor, remaining: torch.Tensor) -> torch.Tensor:
    """The fused decode-step epilogue on device: per-slot token plus
    done flag, packed [2, B] int32 = (token, done) — the decode loop's
    one host transfer.  ``active`` [B] bool, ``eos`` [B] int32 (-1 =
    none), ``remaining`` [B] int32 tokens still allowed."""
    new = sample_rows(logits, temperature)
    new = torch.where(active, new, torch.zeros_like(new))
    done = active & ((remaining <= 1) | ((eos >= 0) & (new == eos)))
    return torch.stack([new, done.to(torch.int32)])


def advance_decode(packed: torch.Tensor, tok: torch.Tensor, pos: torch.Tensor,
                   counts: torch.Tensor, remaining: torch.Tensor,
                   override: torch.Tensor, h_tok: torch.Tensor,
                   h_pos: torch.Tensor, h_counts: torch.Tensor,
                   h_remaining: torch.Tensor
                   ) -> Tuple[torch.Tensor, ...]:
    """The pipelined engine's device-side carry: the next plain-decode
    inputs from the previous step's ``packed`` [2, B] result, with no
    host round trip.  A carried lane feeds packed[0] (its sampled token)
    back and advances pos and counts by one, remaining by minus one, as
    the host will once the transfer lands; a lane with ``override`` set
    (newly admitted, or idle in the previous step) takes the host
    values.  All int32 [B]; ``tok`` is unused, as in the reference."""
    return (torch.where(override, h_tok, packed[0]),
            torch.where(override, h_pos, pos + 1),
            torch.where(override, h_counts, counts + 1),
            torch.where(override, h_remaining, remaining - 1))


def advance_spec(packed: torch.Tensor, tok: torch.Tensor, pos: torch.Tensor,
                 counts: torch.Tensor, override: torch.Tensor,
                 h_tok: torch.Tensor, h_pos: torch.Tensor,
                 h_counts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The same carry after a speculative step's ``packed`` [K+2, B]
    result (rows 0..K the emitted tokens, row K+1 the count m): a
    carried lane takes its last emitted token packed[m-1] and advances
    pos and counts by m; a lane with m == 0 (inactive in that step)
    keeps its token.  All int32 [B]."""
    m = packed[-1]
    idx = (m - 1).clamp(0, packed.shape[0] - 2).long()
    last = packed[:-1].gather(0, idx[None])[0]
    c_tok = torch.where(m > 0, last, tok)
    return (torch.where(override, h_tok, c_tok),
            torch.where(override, h_pos, pos + m),
            torch.where(override, h_counts, counts + m))


def accept_step(target_logits: torch.Tensor, draft_logits: torch.Tensor,
                draft_toks: torch.Tensor, temperature,
                active: torch.Tensor) -> torch.Tensor:
    """The speculative step's greedy accept on device, one packed result.

    target_logits [B, K+1, V] (row j scores the token at pos + j + 1);
    draft_logits [B, K, V] and draft_toks [B, K], the drafter's.  A draft
    token is accepted iff it equals the target argmax at its position;
    ``n_acc`` is the length of the accepted prefix, and the token after
    it is the target argmax at ``n_acc`` (the bonus token when all K are
    accepted), so every emitted token is the one plain greedy decode
    emits.  (The reference's rejection sampling reduces to exactly this
    on its one-hot greedy rows; sampled acceptance needs ROADMAP queue 1,
    item 4, so ``draft_logits`` is unused here.)

    Returns packed int32 [K+2, B]: rows 0..K the emitted tokens, padded
    with 0, row K+1 the emitted count m = n_acc + 1, 0 for an inactive
    slot: the speculative step's one host transfer."""
    require_greedy(temperature)
    K = draft_toks.shape[1]
    best = torch.argmax(target_logits, dim=-1).to(torch.int32)  # [B, K+1]
    agree = (draft_toks.to(torch.int32) == best[:, :K]).to(torch.int32)
    n_acc = torch.cumprod(agree, dim=1).sum(dim=1)               # [B]
    j = torch.arange(K + 1, device=best.device)[None]
    toks = torch.where(j <= n_acc[:, None], best, torch.zeros_like(best))
    toks = torch.where(active[:, None], toks, torch.zeros_like(toks))
    m = torch.where(active, n_acc + 1, torch.zeros_like(n_acc))
    return torch.cat([toks.T, m[None].to(torch.int32)]).to(torch.int32)
