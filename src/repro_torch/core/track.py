"""Parallel Track (PT) Transformer, the paper's model (counterpart of
``repro.core.track``).

A PT model is ``n_tracks`` independent transformers of per-track width
``cfg.d_model``.  All tracks read the same embedded input; after every
``D = cfg.pt.block_depth`` layers their hidden states are fused by one
mean (the one cross-track sync point of a track block) and every track
continues from the fused state.

On one GPU the tracks are a stacked leading dim of every parameter and
activation ([R, D, n, ...] parameters, [n, B, S, d] activations), and
each op of a layer covers all tracks in one launch: batched GEMMs, one
RMSNorm launch, one attention launch.  There is no Python loop over
tracks.  Each residual add runs inside the next norm's launch, and a
track-block boundary (the last residual add, the fusion mean and the
next block's ln1, or the final norm) is one launch of the RMSNorm
kernel's ``fuse_norm`` route; its fused value f [B, S, d] is the
block's sync point, read by every track of the next block as a
broadcast view, not a copy.

On track ranks (``par``, ``runtime.parallel``) each process holds n/W
tracks of the blocks (``shard_tracks``) and of the cache, and a block
boundary is one collective: every rank's x + delta gathered in track
order, then the ``fuse_norm`` route over all n rows under the rank's
own scale rows, so the fusion sums as one process sums it.  The
drafter runs with the track axis stripped: no collective.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.quant import QuantTensor
from repro_torch.common.types import ModelConfig, PTConfig
from repro_torch.models import rope as rope_lib
from repro_torch.models.decoder import _embed, _logits, model_dtype
from repro_torch.models.layers import (check_supported, layer_shapes,
                                       layer_step, norm_in)
from repro_torch.models.norms import fuse_norm
from repro_torch.models.params import Leaf, make_params, stack
from repro_torch.runtime.parallel import NO_PARALLEL, Parallelism


# ---------------------------------------------------------------------------
# sync-point accounting (the paper's section 2.2 claim)
# ---------------------------------------------------------------------------

def dense_tp_sync_points(n_layers: int) -> int:
    """Megatron TP: one all-reduce after attention + one after FFN."""
    return 2 * n_layers


def pt_sync_points(n_layers: int, block_depth: int,
                   fuse_final: bool = True) -> int:
    n = n_layers // block_depth
    if n_layers % block_depth and fuse_final:
        n += 1
    return n


def sync_reduction(n_layers: int, block_depth: int) -> float:
    """2L / (L/D) = 2D — '16x at D=8'."""
    return dense_tp_sync_points(n_layers) / pt_sync_points(n_layers,
                                                           block_depth)


# ---------------------------------------------------------------------------
# PT-ification of a dense decoder config
# ---------------------------------------------------------------------------

def _round_mult(x: float, m: int) -> int:
    return max(m, int(round(x / m)) * m)


def pt_ify(cfg: ModelConfig, n_tracks: int, block_depth: int,
           fusion_op: str = "mean", width_mult: int = 128) -> ModelConfig:
    """Track-parallel variant of a dense decoder config: per-track width
    d/sqrt(n) (total parameters about preserved), heads and KV heads
    divided across tracks (Table 1's recipe), d_ff scaled to preserve the
    FFN parameters."""
    if cfg.encdec is not None:
        raise ValueError("PT is defined for decoder-only models")
    if cfg.moe is not None or cfg.ssm is not None or cfg.rglru is not None:
        raise NotImplementedError("PT-ification of MoE / SSM / RG-LRU "
                                  "configs is not ported (ROADMAP queue 1, "
                                  "item 3)")
    d_t = _round_mult(cfg.d_model / math.sqrt(n_tracks), width_mult)
    heads_t = max(1, cfg.n_heads // n_tracks)
    kv_t = max(1, cfg.n_kv_heads // n_tracks)
    d_ff_t = _round_mult(cfg.d_model * cfg.d_ff / (n_tracks * d_t),
                         width_mult) if cfg.d_ff else 0
    return cfg.replace(
        name=f"{cfg.name}-pt{n_tracks}d{block_depth}", family="pt",
        d_model=d_t, n_heads=heads_t, n_kv_heads=kv_t, d_ff=d_ff_t,
        head_dim=cfg.head_dim,
        pt=PTConfig(n_tracks=n_tracks, block_depth=block_depth,
                    fusion_op=fusion_op))


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _pt(cfg: ModelConfig) -> PTConfig:
    if cfg.pt is None:
        raise ValueError(f"{cfg.name} has no PT config")
    return cfg.pt


def _block_counts(cfg: ModelConfig) -> Tuple[int, int]:
    D = _pt(cfg).block_depth
    R, rem = cfg.n_layers // D, cfg.n_layers % D
    if rem:
        raise NotImplementedError(
            f"{cfg.name}: a ragged tail of {rem} layers is not ported (no "
            "registered config has one)")
    return R, rem


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree of ``repro.core.track.init_pt`` as
    :class:`~repro_torch.models.params.Leaf` specs.  embed [V, d]; head
    [d, V]; blocks leaves [R, D, n, ...]."""
    check_supported(cfg)
    if len(cfg.pattern_unit) != 1 or cfg.pattern_prefix or cfg.pattern_suffix:
        raise ValueError("PT models use a uniform layer pattern")
    pt = _pt(cfg)
    d = cfg.d_model
    R, _ = _block_counts(cfg)
    lead = (R, pt.block_depth, pt.n_tracks)
    specs: Dict[str, Any] = {
        "embed": Leaf((cfg.vocab_size, d), 1.0 / math.sqrt(d)),
        "final_norm": {"scale": Leaf((d,))},
        "blocks": stack(layer_shapes(cfg, cfg.spec(cfg.pattern_unit[0]), d),
                        lead),
        "tail": (),
    }
    if not cfg.tie_embeddings:
        specs["head"] = Leaf((d, cfg.vocab_size), 1.0 / math.sqrt(d))
    return specs


def init_pt(generator: torch.Generator, cfg: ModelConfig,
            device: DeviceLike = None) -> Dict[str, Any]:
    """Random PT parameters with the reference's distributions: weights
    normal * 1/sqrt(fan_in) in the model dtype, norm scales zero (fp32).
    ``generator`` must live on ``device`` (CUDA unless 'cpu' is given).
    The numbers differ from the JAX init of the same seed; tests load one
    JAX tree into both packages through ``weights.from_jax_params``."""
    device = resolve_device(device)
    return make_params(param_specs(cfg), generator, model_dtype(cfg), device)


def _layer(blocks, r: int, j: int):
    """Parameters of layer j of track block r: leaves [n, ...] (views)."""
    if isinstance(blocks, dict):
        return {k: _layer(v, r, j) for k, v in blocks.items()}
    return blocks[r, j]


# ---------------------------------------------------------------------------
# fusion
# ---------------------------------------------------------------------------

def _fuse(h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The sync point: h [n, B, S, d] -> fused [B, S, d].  The mean is
    accumulated in fp32 and cast back, as jnp.mean does for bf16."""
    pt = _pt(cfg)
    if pt.fusion_op == "mean":
        return torch.mean(h, dim=0, dtype=torch.float32).to(h.dtype)
    if pt.fusion_op == "sum":
        return torch.sum(h, dim=0, dtype=torch.float32).to(h.dtype)
    raise ValueError(pt.fusion_op)


def _spread(x: torch.Tensor, cfg: ModelConfig,
            par: Parallelism = NO_PARALLEL) -> torch.Tensor:
    """Fused [B, S, d] -> [n, B, S, d] for every track (on a rank, its
    n/W tracks): a broadcast view (track stride 0), free as in the
    reference; the norm kernel's routes read it as it is."""
    return x[None].expand(par.local_tracks(cfg), *x.shape)


def _gathered(x: torch.Tensor, delta: torch.Tensor,
              par: Parallelism) -> torch.Tensor:
    """A rank's x + delta [n/W, ...], rounded to x's dtype where the fused
    RMSNorm rounds it (one local add, counted), gathered from every rank
    into [n, ...] in track order (one collective)."""
    s = x + delta
    par.counts.local_adds += 1
    return par.gather_tracks(s)


def _boundary(cfg: ModelConfig, nxt, x: torch.Tensor, delta: torch.Tensor,
              par: Parallelism) -> Tuple[torch.Tensor, torch.Tensor]:
    """A track-block boundary, the block's one sync point: (f, y) with f
    [B, S, d] the fusion of x + delta over all n tracks and y its norm
    under ``nxt`` (the next block's ln1, [n/W, d] on a rank, or the final
    norm).  On a rank the local x + delta of every rank is gathered first
    (one collective), and the fused norm runs over the n gathered rows
    with nothing left to add: the bits of one process's launch."""
    if par.sharded:
        x, delta = _gathered(x, delta, par), None
    return fuse_norm(cfg.norm, nxt, x, delta, eps=cfg.norm_eps,
                     fusion_op=_pt(cfg).fusion_op)


def _blocks(params, h: torch.Tensor, cfg: ModelConfig, layer,
            final: bool, par: Parallelism) -> torch.Tensor:
    """The track blocks over the embedded input h [B, S, d]:
    ``layer(lp, x, y, r, j) -> (x, delta)`` runs layer j of block r
    (parameters ``lp``, stream x, ln1 output y) and leaves its last
    residual add pending; the next norm folds it in, and a block
    boundary (``_boundary``) also the fusion and the next block's ln1.
    Returns the final norm's output [B, S, d] (``final``), or the fused
    hidden states without it: the last block's bare fuse.  On a rank
    the blocks hold its n/W tracks, and each of the R boundaries is one
    collective."""
    pt = _pt(cfg)
    R, _ = _block_counts(cfg)
    blocks = params["blocks"]
    held = blocks["ln1"]["scale"].shape[2]
    if held != par.local_tracks(cfg):
        raise ValueError(f"the blocks hold {held} tracks, rank {par.rank} "
                         f"of {par.world} runs {par.local_tracks(cfg)}: "
                         "pass shard_tracks(params, cfg, par)")
    x = _spread(h, cfg, par)
    _, y = norm_in(cfg, _layer(blocks["ln1"], 0, 0), x, None)
    for r in range(R):
        for j in range(pt.block_depth):
            lp = _layer(blocks, r, j)
            if j:
                x, y = norm_in(cfg, lp["ln1"], x, delta)
            x, delta = layer(lp, x, y, r, j)
        if r + 1 < R or final:
            nxt = (_layer(blocks["ln1"], r + 1, 0) if r + 1 < R
                   else params["final_norm"])
            f, y = _boundary(cfg, nxt, x, delta, par)      # 1 sync / block
            x = _spread(f, cfg, par)
    if final:
        return y
    return _fuse(_gathered(x, delta, par) if par.sharded else x + delta,
                 cfg)


# ---------------------------------------------------------------------------
# forward / decode
# ---------------------------------------------------------------------------

def pt_forward(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
               mode: str = "prefill", head: bool = True, *,
               par: Parallelism = NO_PARALLEL):
    """Whole-prompt prefill.  batch: {'inputs': [B, S] token ids,
    'positions'?: [B, S]}.  Returns (logits [B, S, V], cache) with cache
    {'blocks': (k, v) each [R, D, n, B, S, KH, hd], 'tail': ()}, the
    reference's prefill cache layout; ``head=False`` skips the final
    norm and the LM head and returns (None, cache), for a caller that
    reads only the cache (the drafter's prefill, whose logits the
    reference computes and drops).  On a rank (``par``) the blocks and
    the cache hold its n/W tracks.  (The reference also returns an
    auxiliary loss, always zero here; training is ROADMAP queue 1,
    item 9.)"""
    if mode != "prefill":
        raise NotImplementedError(f"pt_forward mode {mode!r} is not ported "
                                  "(train: ROADMAP queue 1, item 9)")
    pt = _pt(cfg)
    spec = cfg.spec(cfg.pattern_unit[0])
    inputs = batch["inputs"]
    B, S = inputs.shape[:2]
    positions = batch.get("positions")
    if positions is None:
        positions = rope_lib.positions_default(B, S, device=inputs.device)
    R, _ = _block_counts(cfg)
    ks, vs = [], []

    def layer(lp, x, y, r, j):
        x, delta, (k, v) = layer_step(lp, x, y, cfg=cfg, spec=spec,
                                      mode="prefill", positions=positions)
        ks.append(k)
        vs.append(v)
        return x, delta

    h = _blocks(params, _embed(params, inputs, cfg), cfg, layer, head, par)
    logits = _logits(params, h, cfg) if head else None

    def stacked(xs):
        return torch.stack(xs).reshape(R, pt.block_depth, *xs[0].shape)

    return logits, {"blocks": (stacked(ks), stacked(vs)), "tail": ()}


def _pt_step(params, cache, h: torch.Tensor, pos: torch.Tensor,
             cfg: ModelConfig, mode: str,
             block_table: Optional[torch.Tensor], kv_max_len: Optional[int],
             active: Optional[torch.Tensor] = None,
             final: bool = True,
             par: Parallelism = NO_PARALLEL) -> torch.Tensor:
    """Shared decode / chunk drive over the track blocks: embedded h
    [B, C, d] in; out the final norm's output (``final``) or the fused
    hidden states [B, C, d]; every layer reads and writes its slice of
    the cache in place: the paged pools (int8 pools with their scales)
    through ``block_table``, or the contiguous rows [n, B, S, KH, hd]
    (``block_table`` None), whose inactive lanes keep their rows."""
    spec = cfg.spec(cfg.pattern_unit[0])
    k_leaf, v_leaf = cache["blocks"]

    def layer(lp, x, y, r, j):
        x, delta, _ = layer_step(lp, x, y, cfg=cfg, spec=spec, mode=mode,
                                 pos=pos, cache=(k_leaf[r, j], v_leaf[r, j]),
                                 block_table=block_table,
                                 kv_max_len=kv_max_len, active=active)
        return x, delta

    return _blocks(params, h, cfg, layer, final, par)


def pt_decode_step(params, cache, tokens: torch.Tensor, pos: torch.Tensor,
                   cfg: ModelConfig,
                   block_table: Optional[torch.Tensor] = None,
                   kv_max_len: Optional[int] = None,
                   active: Optional[torch.Tensor] = None, head: bool = True,
                   *, par: Parallelism = NO_PARALLEL):
    """One token per row against the cache: the paged cache {'blocks':
    (PagedLeaf k, PagedLeaf v) with pools [R, D, n, N, bs, KH, hd]} with
    block_table [B, nmax] int32, or the contiguous cache {'blocks': (k,
    v) each [R, D, n, B, S, KH, hd]} with none.  tokens [B]; pos [B]
    int32 (cache write index).  The cache is updated in place.
    ``active`` [B] bool keeps the contiguous rows of inactive lanes (in
    the paged cache they write through zeroed table rows into the trash
    block).  ``head=False`` skips the final norm and the LM head.  On a
    rank (``par``) the blocks and the cache hold its n/W tracks.
    Returns (logits [B, V] or None, cache)."""
    h = _embed(params, tokens[:, None], cfg)                 # [B, 1, d]
    h = _pt_step(params, cache, h, pos, cfg, "decode", block_table,
                 kv_max_len, active, final=head, par=par)
    return (_logits(params, h[:, 0], cfg) if head else None), cache


def pt_chunk_hidden(params, cache, tokens: torch.Tensor, pos: torch.Tensor,
                    cfg: ModelConfig,
                    block_table: Optional[torch.Tensor] = None,
                    kv_max_len: Optional[int] = None,
                    slots: Optional[torch.Tensor] = None,
                    chunk_lens: Optional[torch.Tensor] = None, *,
                    par: Parallelism = NO_PARALLEL) -> torch.Tensor:
    """``pt_chunk_step`` without the LM head: tokens [B, C] appended at
    positions pos[:, None] + arange(C) -> fused hidden states [B, C, d].
    The serving runner applies the head to each row's last real token
    only; the head is row-wise, so those logits are the rows
    ``pt_chunk_step`` returns.  ``slots`` and ``chunk_lens`` are accepted
    for the shared step signature and unused: a PT cache has no per-slot
    state rows, and padded tail rows land past the row's live length."""
    h = _embed(params, tokens, cfg)                          # [B, C, d]
    return _pt_step(params, cache, h, pos, cfg, "chunk", block_table,
                    kv_max_len, final=False, par=par)


def pt_chunk_step(params, cache, tokens: torch.Tensor, pos: torch.Tensor,
                  cfg: ModelConfig,
                  block_table: Optional[torch.Tensor] = None,
                  kv_max_len: Optional[int] = None, *,
                  par: Parallelism = NO_PARALLEL):
    """Chunked prefill or the K+1-token speculative verify: tokens [B, C]
    appended at positions pos[:, None] + arange(C) against the cache,
    updated in place: the paged cache through ``block_table``, or (with
    none) contiguous rows aligned with the batch, the drafter's cache
    filled chunk by chunk.  Returns (logits [B, C, V], cache)."""
    h = _pt_step(params, cache, _embed(params, tokens, cfg), pos, cfg,
                 "chunk", block_table, kv_max_len, par=par)
    return _logits(params, h, cfg), cache


# ---------------------------------------------------------------------------
# track-subset drafter (speculative decoding)
# ---------------------------------------------------------------------------

def pt_draft_config(cfg: ModelConfig, draft_tracks: int) -> ModelConfig:
    """Config of the track-subset drafter: the same PT stack restricted
    to its first ``draft_tracks`` tracks.  Per-track widths and heads are
    unchanged (only the fusion mean runs over fewer tracks), so sliced
    parameters drive it directly."""
    pt = _pt(cfg)
    if not 1 <= draft_tracks <= pt.n_tracks:
        raise ValueError(f"draft_tracks={draft_tracks} not in "
                         f"[1, {pt.n_tracks}]")
    return cfg.replace(name=f"{cfg.name}-draft{draft_tracks}",
                       pt=dataclasses.replace(pt, n_tracks=draft_tracks))


def pt_draft_params(params, cfg: ModelConfig, draft_tracks: int):
    """The first ``draft_tracks`` tracks of stacked PT params: blocks
    leaves [R, D, n, ...] -> [R, D, d, ...]; embed, final_norm and head
    are shared as they are.  The slices are views, so the drafter costs
    no parameter memory: layer (r, j)'s [d, ...] is a contiguous prefix
    of its [n, ...], and every product over it is one batched GEMM.
    (The reference also slices a ragged tail [rem, n, ...]; the port
    has none, see ``_block_counts``.)"""
    d = draft_tracks
    if not 1 <= d <= _pt(cfg).n_tracks:
        raise ValueError(f"draft_tracks={d} not in [1, {_pt(cfg).n_tracks}]")
    _block_counts(cfg)
    return dict(params, blocks=map_blocks(lambda t: t[:, :, :d],
                                          params["blocks"]))


def map_blocks(fn, tree):
    """``fn`` on every tensor of a parameter (sub)tree, on an int8 leaf's
    payload and scale alike (both keep the leaf's leading axes)."""
    if isinstance(tree, dict):
        return {k: map_blocks(fn, v) for k, v in tree.items()}
    if isinstance(tree, QuantTensor):
        return QuantTensor(fn(tree.payload), fn(tree.scale))
    return fn(tree)


def shard_tracks(params, cfg: ModelConfig, par: Parallelism):
    """This rank's share of the full stacked PT params: blocks leaves
    [R, D, n, ...] -> [R, D, n/W, ...], tracks ``par.track_range(cfg)``,
    as copies (int8 payload and scale together), so that the rank holds
    only its share once the full tree is dropped; embed, final_norm and
    head are kept as they are (replicated).  Under ``NO_PARALLEL`` the
    tree comes back as it is.  (The reference shards the same leaves
    over its 'track' mesh axis, ``repro/runtime/sharding.py``.)"""
    if not par.sharded:
        return params
    _block_counts(cfg)
    a, b = par.track_range(cfg)
    n = _pt(cfg).n_tracks
    held = params["blocks"]["ln1"]["scale"].shape[2]
    if held != n:
        raise ValueError(f"blocks hold {held} tracks: shard_tracks takes "
                         f"the full tree, all {n}")
    return dict(params, blocks=map_blocks(lambda t: t[:, :, a:b].clone(),
                                          params["blocks"]))


def pt_draft_step(draft_params, cache, tokens: torch.Tensor,
                  pos: torch.Tensor, cfg_draft: ModelConfig,
                  active: Optional[torch.Tensor] = None,
                  kv_max_len: Optional[int] = None, head: bool = True, *,
                  par: Parallelism = NO_PARALLEL):
    """One decode step of the track-subset drafter on its contiguous
    cache: ``pt_decode_step`` on ``cfg_draft = pt_draft_config(cfg, d)``
    with the matching ``pt_draft_params`` slice.  It has no cross-track
    collective: it runs with the track axis stripped from ``par``, the d
    tracks are replicated on every rank, and the fusion mean is plain
    compute.  ``head=False`` only writes the step's K/V (the speculative
    step's last draft step, whose logits are dropped).  Returns (logits
    [B, V] or None, cache)."""
    return pt_decode_step(draft_params, cache, tokens, pos, cfg_draft,
                          kv_max_len=kv_max_len, active=active, head=head,
                          par=par.without_axis("track"))


def pt_cache_shape(cfg: ModelConfig, batch: int, seq_len: int,
                   par: Parallelism = NO_PARALLEL) -> Tuple[int, ...]:
    """Shape of one K or V leaf: [R, D, n, batch, seq_len, KH, hd], on a
    rank n/W tracks in place of n.  The paged engine lays its pools out
    the same way, with (num_blocks, block_size) in place of (batch,
    seq_len)."""
    pt = _pt(cfg)
    R, _ = _block_counts(cfg)
    return (R, pt.block_depth, par.local_tracks(cfg), batch, seq_len,
            cfg.n_kv_heads, cfg.head_dim)


def pt_init_cache(cfg: ModelConfig, batch: int, seq_len: int,
                  device: DeviceLike = None, *,
                  par: Parallelism = NO_PARALLEL) -> Dict[str, Any]:
    """Zeroed contiguous cache {'blocks': (k, v), 'tail': ()}, each leaf
    [R, D, n, batch, seq_len, KH, hd] (on a rank n/W tracks) in the model
    dtype (the reference's ``pt_init_cache``)."""
    device = resolve_device(device)
    shape = pt_cache_shape(cfg, batch, seq_len, par)
    dtype = model_dtype(cfg)
    return {"blocks": (torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device)),
            "tail": ()}
