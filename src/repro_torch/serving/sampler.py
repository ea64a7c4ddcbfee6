"""Token samplers: greedy / temperature / top-k / top-p, the fused
decode-step epilogue, the speculative accept step, and the pipelined
engine's device-side carry of the next step's inputs
(``advance_decode`` / ``advance_spec``) (counterpart of
``repro.serving.sampler``).

Every draw is keyed per row by (request seed, token counter, salt)
(``row_keys``), through ``common.prng``'s threefry stream, bit-exact
with the reference's: a request's tokens depend on its own seed and
position only, never on who shares its batch.  The filters and the
accept step are the reference's ``jnp`` code in PyTorch, op for op; the
sampling noise goes through ``log`` (``prng.gumbel``), whose last bit
may differ between implementations, so a draw at a near-tie of the
noisy logits may differ from the reference's.

``sample_rows``, ``sample_step`` and ``accept_step`` take ``keys=None``
(``seeds=None``) for a batch whose every row is greedy: then they run
the argmax alone, no PRNG and no filter (the engine's greedy step
programs).  Greedy rows of a sampled batch get the same argmax.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common import prng

NEG = -1e30

# salts for the per-request randomness streams (row_keys)
SALT_SAMPLE = 0        # plain decode / resample / bonus token draws
SALT_ACCEPT = 1        # speculative accept uniforms
SALT_DRAFT = 2         # drafter's own sampling


@dataclasses.dataclass(frozen=True)
class SampleParams:
    temperature: float = 0.0          # 0 => greedy
    top_k: int = 0                    # 0 => no top-k filter
    top_p: float = 1.0                # 1 => no nucleus filter


def stack_params(params: Sequence[SampleParams]
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """[SampleParams] -> (temperature [B] f32, top_k [B] i32, top_p [B] f32),
    host arrays."""
    return (np.asarray([p.temperature for p in params], np.float32),
            np.asarray([p.top_k for p in params], np.int32),
            np.asarray([p.top_p for p in params], np.float32))


def fork_seeds(base_seed: int, n: int) -> list:
    """``n`` distinct deterministic sampling seeds for fork children,
    never colliding with the parent's ``base_seed``: splitmix-style
    avalanche over (base_seed, child index), as the reference."""
    base = base_seed & 0xFFFFFFFF
    seen = {base}
    out: list = []
    i = 0
    while len(out) < n:
        i += 1
        z = (base + i * 0x9E3779B9) & 0xFFFFFFFF
        z = ((z ^ (z >> 16)) * 0x85EBCA6B) & 0xFFFFFFFF
        z = ((z ^ (z >> 13)) * 0xC2B2AE35) & 0xFFFFFFFF
        z ^= z >> 16
        if z in seen:
            continue
        seen.add(z)
        out.append(z)
    return out


def row_keys(seeds: torch.Tensor, counters: torch.Tensor,
             salt: int) -> torch.Tensor:
    """Per-row keys [B, 2] (``prng`` words, int64) from (request seed,
    token counter, salt): fold_in(fold_in(PRNGKey(seed), counter), salt),
    the seeds taken modulo 2**32 (any integer dtype: an int32 holding a
    seed's bit pattern gives the same key)."""
    key = prng.prng_key(seeds)
    return prng.fold_in(prng.fold_in(key, counters), salt)


def prefill_keys(seeds: torch.Tensor, counters: torch.Tensor
                 ) -> torch.Tensor:
    """Keys of the token sampled at the end of a (re)prefill: draw
    ``counters[i]`` of each row's stream (0 for a fresh prompt), the
    same triple the decode step would use at that point."""
    return row_keys(seeds, counters, SALT_SAMPLE)


def filter_logits(logits: torch.Tensor, temperature: torch.Tensor,
                  top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Temperature-scale + per-row top-k / top-p mask.  logits [B, V]
    with params [B] (tensors on the logits' device) -> filtered scaled
    logits [B, V] in float32 (NEG outside the support).  Branch-free, so
    one captured program serves every mix of parameters."""
    logits = logits.float()
    V = logits.shape[-1]
    t = temperature.float().clamp_min(1e-6)[:, None]
    scaled = logits / t
    # top-k: per-row k-th largest value as the cutoff (rank-based)
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k_idx = (top_k.long()[:, None] - 1).clamp(0, V - 1)
    kth = sorted_desc.gather(-1, k_idx)
    cut_k = top_k[:, None] > 0
    scaled = torch.where(cut_k & (scaled < kth), NEG, scaled)
    # top-p over the (already top-k-filtered) distribution.  The reference
    # sorts the masked row again; the values below kth are a suffix of
    # the sorted row, so masking that suffix gives the same sorted row
    # (while kth >= NEG: a logit below -1e30 times the temperature)
    sorted_desc = torch.where(cut_k & (sorted_desc < kth), NEG, sorted_desc)
    cum = torch.softmax(sorted_desc, dim=-1).cumsum(dim=-1)
    cutoff_idx = (cum < top_p.float()[:, None]).sum(dim=-1, keepdim=True)
    cutoff = sorted_desc.gather(-1, cutoff_idx.clamp(0, V - 1))
    return torch.where((top_p[:, None] < 1.0) & (scaled < cutoff), NEG,
                       scaled)


def sample(logits: torch.Tensor, key: torch.Tensor,
           params: SampleParams = SampleParams()) -> torch.Tensor:
    """logits [B, V] -> tokens [B] int32 under one SampleParams for the
    batch, one shared key [2] (kept for tests and tools)."""
    if params.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    B, dev = logits.shape[0], logits.device
    full = lambda v, dt: torch.full((B,), v, dtype=dt, device=dev)
    scaled = filter_logits(logits, full(params.temperature, torch.float32),
                           full(params.top_k, torch.int32),
                           full(params.top_p, torch.float32))
    return _draw(key, scaled)


def _draw(key: torch.Tensor, scaled: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, scaled, axis=-1)`` with ONE key
    [2] for the whole batch: the Gumbel noise has the batch's shape."""
    g = prng.gumbel(key, scaled.shape)
    return torch.argmax(g + scaled, dim=-1).to(torch.int32)


def sample_batched(logits: torch.Tensor, key: torch.Tensor,
                   temperature: torch.Tensor, top_k: torch.Tensor,
                   top_p: torch.Tensor) -> torch.Tensor:
    """Per-row parameters, one shared key [2] (kept for tests and
    tools): logits [B, V] -> tokens [B] int32; a row with temperature
    <= 0 is greedy."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    sampled = _draw(key, filter_logits(logits, temperature, top_k, top_p))
    return torch.where(temperature <= 0.0, greedy, sampled)


def sample_rows(logits: torch.Tensor, keys: Optional[torch.Tensor],
                temperature: Optional[torch.Tensor] = None,
                top_k: Optional[torch.Tensor] = None,
                top_p: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits [B, V] -> tokens [B] int32, each row under its own key
    [B, 2] (``row_keys``) and parameters [B]: a row with temperature <=
    0 takes the first maximal index, as ``jnp.argmax``; the others draw
    from ``filter_logits``' distribution.  ``keys=None``: every row
    greedy, the argmax alone."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if keys is None:
        return greedy
    scaled = filter_logits(logits, temperature, top_k, top_p)
    sampled = prng.categorical(keys, scaled).to(torch.int32)
    return torch.where(temperature <= 0.0, greedy, sampled)


def sample_step(logits: torch.Tensor, keys: Optional[torch.Tensor],
                temperature: Optional[torch.Tensor],
                top_k: Optional[torch.Tensor], top_p: Optional[torch.Tensor],
                active: torch.Tensor, eos: torch.Tensor,
                remaining: torch.Tensor) -> torch.Tensor:
    """The fused decode-step epilogue on device: per-slot token plus
    done flag, packed [2, B] int32 = (token, done) -- the decode loop's
    one host transfer.  ``keys`` [B, 2] per row (None: all greedy),
    ``active`` [B] bool, ``eos`` [B] int32 (-1 = none), ``remaining``
    [B] int32 tokens still allowed."""
    new = sample_rows(logits, keys, temperature, top_k, top_p)
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


def _filtered_probs(logits: torch.Tensor, temperature: torch.Tensor,
                    top_k: torch.Tensor, top_p: torch.Tensor
                    ) -> torch.Tensor:
    """Probability vectors of the filtered distribution; greedy rows
    (temperature <= 0) are exact one-hots at the argmax, so the accept
    arithmetic reduces to argmax agreement for them."""
    cols = torch.arange(logits.shape[-1], device=logits.device)
    greedy = (cols == torch.argmax(logits, dim=-1)[:, None]).float()
    probs = torch.softmax(filter_logits(logits, temperature, top_k, top_p),
                          dim=-1)
    return torch.where((temperature <= 0.0)[:, None], greedy, probs)


def _greedy_accept(target_logits: torch.Tensor, draft_toks: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tokens [B, K+1], n_acc [B]) of an all-greedy batch: a draft is
    accepted iff it equals the target argmax at its position, the token
    after the accepted prefix is the target argmax there."""
    K = draft_toks.shape[1]
    best = torch.argmax(target_logits, dim=-1).to(torch.int32)  # [B, K+1]
    agree = (draft_toks.to(torch.int32) == best[:, :K]).to(torch.int32)
    n_acc = torch.cumprod(agree, dim=1).sum(dim=1)               # [B]
    j = torch.arange(K + 1, device=best.device)[None]
    return torch.where(j <= n_acc[:, None], best,
                       torch.zeros_like(best)), n_acc


def _sampled_accept(target_logits, draft_logits, draft_toks, seeds,
                    counters, temperature, top_k, top_p
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tokens [B, K+1], n_acc [B]) by rejection sampling under each
    row's filtered distributions: accept d_j with probability
    min(1, p_j[d_j] / q_j[d_j]); at the first rejection emit a token from
    norm(max(p_j - q_j, 0)), after K acceptances the bonus token from
    p_K."""
    B, K1, V = target_logits.shape
    K = K1 - 1

    def per_pos(logits3):
        n = logits3.shape[1]
        rep = lambda a: a[:, None].expand(B, n).reshape(B * n)
        return _filtered_probs(logits3.reshape(B * n, V), rep(temperature),
                               rep(top_k), rep(top_p)).reshape(B, n, V)

    p = per_pos(target_logits)                           # [B, K+1, V]
    q = per_pos(draft_logits)                            # [B, K, V]
    d = draft_toks.long()[..., None]
    p_at = p[:, :K].gather(-1, d)[..., 0]                # [B, K]
    q_at = q.gather(-1, d)[..., 0]
    u = torch.stack([prng.uniform(row_keys(seeds, counters + j, SALT_ACCEPT))
                     for j in range(K)], dim=1)          # [B, K]
    accept = u < p_at / q_at.clamp_min(1e-30)
    n_acc = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1)
    # residual (or bonus) distribution at the first rejected position;
    # q padded with zeros makes the all-accepted case max(p_K - 0, 0) = p_K
    q_pad = torch.cat([q, q.new_zeros(B, 1, V)], dim=1)
    at = n_acc.long()[:, None, None].expand(B, 1, V)
    p_n = p.gather(1, at)[:, 0]
    q_n = q_pad.gather(1, at)[:, 0]
    res = (p_n - q_n).clamp_min(0.0)
    res_sum = res.sum(dim=-1, keepdim=True)
    res = torch.where(res_sum > 0, res / res_sum.clamp_min(1e-30), p_n)
    res_keys = row_keys(seeds, counters + n_acc, SALT_SAMPLE)
    extra = prng.categorical(res_keys, torch.log(res.clamp_min(1e-38)))
    extra = torch.where(temperature <= 0.0, torch.argmax(res, dim=-1),
                        extra).to(torch.int32)
    jr = torch.arange(K1, device=target_logits.device)[None]
    d_pad = torch.cat([draft_toks.to(torch.int32),
                       draft_toks.new_zeros(B, 1, dtype=torch.int32)], dim=1)
    toks = torch.where(jr < n_acc[:, None], d_pad,
                       torch.where(jr == n_acc[:, None], extra[:, None],
                                   torch.zeros_like(d_pad)))
    return toks, n_acc


def accept_step(target_logits: torch.Tensor, draft_logits: torch.Tensor,
                draft_toks: torch.Tensor, seeds: Optional[torch.Tensor],
                counters: Optional[torch.Tensor],
                temperature: Optional[torch.Tensor],
                top_k: Optional[torch.Tensor], top_p: Optional[torch.Tensor],
                active: torch.Tensor) -> torch.Tensor:
    """The speculative step's batched accept / resample on device, one
    packed result.

    target_logits [B, K+1, V] (row j scores the token at pos + j + 1);
    draft_logits [B, K, V] and draft_toks [B, K], the drafter's; seeds
    and counters [B] (each row's stream: accept uniform j keyed by
    counter + j and ``SALT_ACCEPT``, the resample by counter + n_acc and
    ``SALT_SAMPLE``); parameters [B].  Rejection sampling per row under
    its own filtered distributions, so the emitted tokens follow the
    target's distribution for any drafter; greedy rows use one-hot
    distributions, so a draft is accepted iff it is the target argmax
    and every emitted token is the one plain greedy decode emits.
    ``seeds=None``: an all-greedy batch, the argmax agreement alone
    (``draft_logits`` unused).

    Returns packed int32 [K+2, B]: rows 0..K the emitted tokens, padded
    with 0, row K+1 the emitted count m = n_acc + 1, 0 for an inactive
    slot: the speculative step's one host transfer."""
    if seeds is None:
        toks, n_acc = _greedy_accept(target_logits, draft_toks)
    else:
        toks, n_acc = _sampled_accept(target_logits, draft_logits,
                                      draft_toks, seeds, counters,
                                      temperature, top_k, top_p)
    toks = torch.where(active[:, None], toks, torch.zeros_like(toks))
    m = torch.where(active, n_acc + 1, torch.zeros_like(n_acc))
    return torch.cat([toks.T, m[None].to(torch.int32)]).to(torch.int32)
