"""The dense ``lm_*`` decoder (counterpart of ``repro.models.decoder``),
with the embedding and LM head the Parallel-Track model shares.

The layer stack is (prefix, unit × R, suffix) per ModelConfig, as in the
reference; the repeated unit's parameters and cache leaves are stacked
on a leading [R] axis, and the layers run as a Python loop over it (the
reference scans).  Three layers are ported on this path: GQA (the
paper's dense baselines and tinyllama-1.1b with SwiGLU; nemotron-4-15b
with LayerNorm and the squared-ReLU MLP; gemma2-2b and gemma3-4b with
GeGLU, sandwich norms, sliding windows, softcaps and qk-norm;
qwen2-vl-72b with M-RoPE), Mamba (falcon-mamba-7b), RG-LRU
(recurrentgemma-9b, beside its windowed MQA layers) and MLA with a
SwiGLU or MoE MLP (deepseek-v2-236b, deepseek-v3-671b: a dense prefix,
then the MoE unit), and whisper-medium's encoder-decoder: ``encode``
runs the encoder stack (non-causal GQA layers with a GELU MLP over
precomputed frame embeddings, the stub of its conv frontend) and each
decoder layer cross-attends to its output; both stacks add fixed
sinusoid positions (``_sinusoid``) to their inputs and take no RoPE.
``lm_forward`` also takes precomputed input embeddings (qwen2-vl's stub
vision frontend) with (t, h, w) M-RoPE positions.

  init_lm(generator, cfg, device)               -> params
  lm_forward(params, batch, cfg, mode)          -> prefill: (logits, cache)
                                                   train: (logits, aux)
  encode(params, enc_inputs, cfg)               -> encoder output
  lm_loss(params, batch, cfg)                   -> (loss, metrics)
  lm_decode_step(params, cache, tokens, pos, cfg, ...) -> (logits, cache)
  lm_chunk_step(params, cache, tokens, pos, cfg, ...)  -> (logits, cache)
  lm_chunk_hidden(...)                          -> hidden states (no head)
  init_cache(cfg, batch, seq_len, device, enc_len) -> zeroed cache

The cache is the reference's tree {"prefix", "unit", "suffix"} (unit
leaves stacked [R, ...]).  A GQA layer's entry is (k, v), each
[.., B, S, KH, hd] in the model dtype (the contiguous cache), or the
paged engine's (PagedLeaf k, PagedLeaf v) pools [.., N, bs, KH, hd],
or for a window W shorter than the cache ring rows [.., B, W, KH, hd]
(slot = position % W) in either engine; an
MLA layer's entry is its latents (c_kv [.., B, S, r], k_rope [.., B, S,
rope]) or the paged engine's latent pools [.., N, bs, r] and [.., N,
bs, rope] (no KV-head axis); a
Mamba layer's entry is (conv window [.., B, dc-1, di] in the model
dtype, h [.., B, di, ds] fp32) and an RG-LRU layer's (conv window
[.., B, dc-1, di], h [.., B, di] fp32): per-slot state rows.  A
whisper decoder layer's entry is ((k, v), (enc_k, enc_v)): its own
contiguous K/V and the encoder's output projected once at prefill,
[.., B, S_enc, KH, hd], which no later step writes (whisper runs on the
contiguous cache only: the engine, as the reference's, serves
decoder-only models).  The decode and chunk steps update every leaf in
place.  (The reference's prefill also returns an auxiliary loss, always
zero here.)

Train mode (``lm_forward(mode="train")``, ``lm_loss``) runs the
reference's train-time functions on plain PyTorch ops, so autograd
differentiates them: ``layers.layer_train`` (plain norms, blockwise
attention, the plain scan, the MoE with its auxiliary loss), each
repeat of the unit (and each encoder layer) under ``_remat``
(activation checkpointing).  It reaches no kernel wrapper.  Every
layer trains.  The train tree (``init_lm(padded=True)``,
``lm_param_specs(padded=True)``) holds a MoE's experts in the
reference's stored layout, padding included; the serving tree drops the
padded experts (``weights.drop_expert_padding``).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.common import quant
from repro_torch.common.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.common.pytree import unstack
from repro_torch.common.types import ModelConfig
from repro_torch.models.layers import (check_supported,
                                       layer_shapes, layer_step,
                                       layer_train, norm_in, norm_shapes)
from repro_torch.models import rope as rope_lib
from repro_torch.models.norms import apply_norm, plain_norm
from repro_torch.models.params import Leaf, make_params, stack


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.dtype)


# the matmul outputs that remat policy "dots" keeps (the reference's
# dots_with_no_batch_dims_saveable keeps its dot products' outputs)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _keep_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn: Callable, cfg: ModelConfig) -> Callable:
    """``fn`` under activation checkpointing (the reference's ``_remat``):
    with ``cfg.remat`` only its inputs are saved and its forward runs
    again in the backward; remat policy 'dots' also keeps the matmul
    outputs, 'nothing' recomputes everything."""
    if not cfg.remat:
        return fn
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _keep_dots)
    elif cfg.remat_policy != "nothing":
        raise ValueError(f"unknown remat policy {cfg.remat_policy!r}")

    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **kw)

    return run


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def lm_param_specs(cfg: ModelConfig, padded: bool = False
                   ) -> Dict[str, Any]:
    """The tree ``repro.models.decoder.init_lm`` builds, as
    :class:`~repro_torch.models.params.Leaf` specs: embed [V, d], head
    [d, V], prefix/suffix layers, unit layers stacked [R, ...], and for
    an encoder-decoder model enc {"layers": stacked [n_enc, ...],
    "final_norm"}.  A MoE's experts: the ``n_routed_experts`` real ones,
    or with ``padded`` all of the reference's stored layout (the train
    tree)."""
    check_supported(cfg)
    if cfg.pt is not None:
        raise ValueError(f"{cfg.name} is a PT model: use core.track.init_pt")
    d = cfg.d_model
    specs: Dict[str, Any] = {
        "embed": Leaf((cfg.vocab_size, d), 1.0 / math.sqrt(d)),
        "final_norm": norm_shapes(cfg.norm, d),
        "prefix": tuple(layer_shapes(cfg, cfg.spec(nm), d, padded)
                        for nm in cfg.pattern_prefix),
        "unit": tuple(stack(layer_shapes(cfg, cfg.spec(nm), d, padded),
                            (cfg.pattern_repeat,))
                      for nm in cfg.pattern_unit) if cfg.pattern_repeat else (),
        "suffix": tuple(layer_shapes(cfg, cfg.spec(nm), d, padded)
                        for nm in cfg.pattern_suffix),
    }
    if not cfg.tie_embeddings:
        specs["head"] = Leaf((d, cfg.vocab_size), 1.0 / math.sqrt(d))
    if cfg.encdec is not None:
        specs["enc"] = {
            "layers": stack(layer_shapes(cfg, cfg.spec("enc"), d),
                            (cfg.encdec.n_enc_layers,)),
            "final_norm": norm_shapes(cfg.norm, d)}
    return specs


def init_lm(generator: torch.Generator, cfg: ModelConfig,
            device: DeviceLike = None, padded: bool = False
            ) -> Dict[str, Any]:
    """Random parameters with the reference's distributions (see
    ``lm_param_specs``; ``padded``: the train tree).  ``generator`` must
    live on ``device`` (CUDA unless 'cpu' is given).  The numbers differ
    from the JAX init of the same seed; tests load one JAX tree into both
    packages through ``weights.from_jax_params``."""
    device = resolve_device(device)
    return make_params(lm_param_specs(cfg, padded), generator,
                       model_dtype(cfg), device)


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def _sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings (the reference's
    ``_sinusoid``): positions [B, S] -> [B, S, d] fp32, sines then
    cosines of positions x exp(-ln(10000) i / max(d / 2 - 1, 1))."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device)
        / max(half - 1, 1))
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _embed(params, inputs: torch.Tensor, cfg: ModelConfig,
           positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """inputs [B, S] token ids, or [B, S, d] floating precomputed
    embeddings (cast to the model dtype) -> [B, S, d] in the model dtype,
    times the embedding multiplier; an encoder-decoder model adds the
    sinusoid at ``positions`` [B, S] (or the first of M-RoPE's [3, B, S]
    streams), cast to the model dtype."""
    dtype = model_dtype(cfg)
    if inputs.is_floating_point():
        h = inputs.to(dtype)
    else:
        h = params["embed"][inputs.long()]
    if cfg.embedding_multiplier != 1.0:
        h = (h.float() * cfg.embedding_multiplier).to(dtype)
    if cfg.encdec is not None:
        p = positions if positions.dim() == 2 else positions[0]
        h = h + _sinusoid(p, cfg.d_model).to(dtype)
    return h


def _head(params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Final norm + LM head: h [..., d] -> logits [..., V]."""
    return _logits(params, apply_norm(cfg.norm, params["final_norm"], h,
                                      eps=cfg.norm_eps), cfg)


def _logits(params, y: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The LM head on the final norm's output y [..., d] -> [..., V].

    With ``cfg.logits_fp32`` the product runs in fp32 on the fp32 cast
    of both operands, as the reference does.  ``head.float()`` is free
    when the caller already holds an fp32 copy of the head (the serving
    runner does, so no step re-casts the bf16 head).  An int8 head
    (``QuantTensor`` [d, V]) goes through the W8A16 kernel, in y's
    dtype."""
    h = y.float() if cfg.logits_fp32 else y
    w = params["embed"].t() if cfg.tie_embeddings else params["head"]
    if quant.is_quantized(w):
        logits = quant.matmul(h.reshape(1, -1, h.shape[-1]), w[None])
        logits = logits.reshape(*h.shape[:-1], w.shape[-1])
    else:
        logits = h @ w.to(h.dtype)
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _final(params, x: torch.Tensor, delta: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """The last residual add folded into the final norm: the normed
    hidden states [..., d] the LM head reads."""
    return norm_in(cfg, params["final_norm"], x, delta)[1]


# ---------------------------------------------------------------------------
# forward / decode / chunk
# ---------------------------------------------------------------------------

def _at(tree, r: int):
    """Layer r of a [R]-stacked tree (views; QuantTensors slice too)."""
    if isinstance(tree, dict):
        return {k: _at(v, r) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_at(v, r) for v in tree)
    return tree[r]


def _layers(cfg: ModelConfig):
    """(group, index, r, spec name) of every layer in order; r is the
    unit repeat (None outside the unit)."""
    out = [("prefix", i, None, nm) for i, nm in enumerate(cfg.pattern_prefix)]
    for r in range(cfg.pattern_repeat):
        out += [("unit", j, r, nm) for j, nm in enumerate(cfg.pattern_unit)]
    out += [("suffix", i, None, nm) for i, nm in enumerate(cfg.pattern_suffix)]
    return out


def _stacked(caches: List[Any]) -> Any:
    """Per-layer caches of one unit position -> one [R]-stacked cache."""
    first = caches[0]
    if isinstance(first, tuple):
        return tuple(_stacked([c[i] for c in caches])
                     for i in range(len(first)))
    return torch.stack(caches)


def encode(params, enc_inputs: torch.Tensor, cfg: ModelConfig,
           train: bool = False) -> torch.Tensor:
    """The encoder stack (the reference's ``encode``): enc_inputs [B,
    S_enc, d] precomputed frame embeddings (the stub of whisper's conv
    frontend), cast to the model dtype, plus the sinusoid at positions
    0 .. S_enc - 1, through the stacked ``params["enc"]["layers"]`` (GQA
    without a causal mask, ``spec("enc")``) and ``enc.final_norm``.
    Self-attention runs on the flash kernel (full, no mask) and each
    layer's last residual add is folded into the next norm; with
    ``train`` every layer is ``layer_train`` (plain ops) under
    ``_remat``, as the reference's scan body.  Returns [B, S_enc, d]."""
    B, S, _ = enc_inputs.shape
    positions = rope_lib.positions_default(B, S, device=enc_inputs.device)
    dtype = model_dtype(cfg)
    h = enc_inputs.to(dtype) + _sinusoid(positions, cfg.d_model).to(dtype)
    spec, enc = cfg.spec("enc"), params["enc"]
    n = cfg.encdec.n_enc_layers
    if train:
        layer = _remat(lambda x, lp: layer_train(
            lp, x, cfg=cfg, spec=spec, positions=positions)[0], cfg)
        for lp in unstack(enc["layers"], n):
            h = layer(h, lp)
        return plain_norm(cfg.norm, enc["final_norm"], h, eps=cfg.norm_eps)
    x, delta = h, None
    for r in range(n):
        lp = _at(enc["layers"], r)
        x, y = norm_in(cfg, lp["ln1"], x, delta)
        x, delta, _ = layer_step(lp, x, y, cfg=cfg, spec=spec,
                                 mode="encode", positions=positions)
    return norm_in(cfg, enc["final_norm"], x, delta)[1]


def lm_forward(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
               mode: str = "prefill"):
    """Whole-prompt prefill.  batch: {'inputs': [B, S] token ids or
    [B, S, d] floating precomputed embeddings, 'positions'?: [B, S] or
    [3, B, S] (M-RoPE's (t, h, w) streams), 'lengths'?: [B] true lengths
    of right-padded rows, 'enc_inputs': [B, S_enc, d] frame embeddings
    of an encoder-decoder model}.
    Returns (logits [B, S, V], cache) in the reference's prefill layout
    (a GQA layer's (k, v) [B, S, KH, hd] with RoPE applied, a window
    W < S's rings [B, W, KH, hd] built from ``lengths``, a cross-
    attending layer's ((k, v), (enc_k, enc_v)) with the encoder's K/V
    [B, S_enc, KH, hd], unit leaves stacked [R, B, ...]).  Right-padded
    rows are safe for attention: a padded key lies causally after every
    real query, and ``lengths`` keeps padding out of the rings.  Recurrent layers carry every
    position into their state, so their rows must not be right-padded:
    the engine prefills them at exact length.  ``mode="train"``:
    (logits, aux) of ``_lm_train`` (no cache, plain ops)."""
    if mode == "train":
        return _lm_train(params, batch, cfg)
    if mode != "prefill":
        raise ValueError(f"unknown lm_forward mode {mode!r}")
    inputs = batch["inputs"]
    lengths = batch.get("lengths")
    positions = batch.get("positions")
    if positions is None:
        positions = rope_lib.positions_default(*inputs.shape[:2],
                                               device=inputs.device)
    enc_states = (encode(params, batch["enc_inputs"], cfg)
                  if cfg.encdec is not None else None)
    x, delta = _embed(params, inputs, cfg, positions), None
    caches: Dict[str, Any] = {"prefix": [], "unit": [[] for _ in
                                                     cfg.pattern_unit],
                              "suffix": []}
    for group, i, r, nm in _layers(cfg):
        lp = (params[group][i] if r is None
              else _at(params["unit"][i], r))
        x, y = norm_in(cfg, lp["ln1"], x, delta)
        x, delta, c = layer_step(lp, x, y, cfg=cfg, spec=cfg.spec(nm),
                                 mode="prefill", positions=positions,
                                 lengths=lengths, enc_states=enc_states)
        (caches[group] if r is None else caches["unit"][i]).append(c)
    cache = {"prefix": tuple(caches["prefix"]),
             "unit": (tuple(_stacked(cs) for cs in caches["unit"])
                      if cfg.pattern_repeat else ()),
             "suffix": tuple(caches["suffix"])}
    return _logits(params, _final(params, x, delta, cfg), cfg), cache


def train_head(params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The final norm (plain) and the LM head of train mode."""
    return _logits(params, plain_norm(cfg.norm, params["final_norm"], h,
                                      eps=cfg.norm_eps), cfg)


def _lm_train(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """lm_forward(mode="train"): (logits [B, S, V], aux) as the
    reference's, aux the MoE layers' auxiliary losses summed as the
    reference sums them (each prefix layer's into the total, the unit's
    repeats into a carry that leaves each remat'd repeat, then the
    suffix's); an encoder-decoder model encodes ``batch["enc_inputs"]``
    first."""
    check_supported(cfg)
    inputs = batch["inputs"]
    positions = batch.get("positions")
    if positions is None:
        positions = rope_lib.positions_default(*inputs.shape[:2],
                                               device=inputs.device)
    enc_states = (encode(params, batch["enc_inputs"], cfg, train=True)
                  if cfg.encdec is not None else None)
    h = _embed(params, inputs, cfg, positions)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)

    def run(lp, x, nm):
        return layer_train(lp, x, cfg=cfg, spec=cfg.spec(nm),
                           positions=positions, enc_states=enc_states)

    for i, nm in enumerate(cfg.pattern_prefix):
        h, a = run(params["prefix"][i], h, nm)
        aux = aux + a

    def unit(x, carry, layers):
        for lp, nm in zip(layers, cfg.pattern_unit):
            x, a = run(lp, x, nm)
            carry = carry + a
        return x, carry

    unit = _remat(unit, cfg)
    R = cfg.pattern_repeat
    if R:
        carry = torch.zeros((), dtype=torch.float32, device=h.device)
        for layers in zip(*(unstack(u, R) for u in params["unit"])):
            h, carry = unit(h, carry, layers)
        aux = aux + carry
    for i, nm in enumerate(cfg.pattern_suffix):
        h, a = run(params["suffix"][i], h, nm)
        aux = aux + a
    return train_head(params, h, cfg), aux


def xent(logits: torch.Tensor, targets: torch.Tensor, aux: torch.Tensor):
    """Next-token cross entropy of the reference's losses: the fp32
    logsumexp, targets == -1 masked out, the mean over at least one
    token; returns (loss + aux, metrics)."""
    mask = (targets >= 0).float()
    t = torch.clamp_min(targets, 0).long()
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, t[..., None])[..., 0] - logz
    denom = torch.clamp_min(mask.sum(), 1.0)
    loss = -torch.sum(ll * mask) / denom
    return loss + aux, {"loss": loss, "aux": aux, "tokens": mask.sum()}


def lm_loss(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """(loss, metrics) of train mode: batch {'inputs', 'targets',
    'positions'?, 'enc_inputs' (an encoder-decoder model)}."""
    logits, aux = lm_forward(params, batch, cfg, mode="train")
    return xent(logits, batch["targets"], aux)


def _step_layers(params, cache, h: torch.Tensor, pos: torch.Tensor,
                 cfg: ModelConfig, mode: str,
                 block_table: Optional[torch.Tensor],
                 kv_max_len: Optional[int],
                 slots: Optional[torch.Tensor] = None,
                 chunk_lens: Optional[torch.Tensor] = None,
                 active: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the (prefix, unit × R, suffix) stack in decode or chunk mode
    ('fill': a prompt's chunk program); every layer updates its cache
    entry in place.  Returns (x, delta):
    the hidden states are x + delta, the last residual add left for the
    final norm to fold in."""
    x, delta = h, None
    for group, i, r, nm in _layers(cfg):
        if r is None:
            lp, lc = params[group][i], cache[group][i]
        else:
            lp, lc = _at(params["unit"][i], r), _at(cache["unit"][i], r)
        x, y = norm_in(cfg, lp["ln1"], x, delta)
        x, delta, _ = layer_step(lp, x, y, cfg=cfg, spec=cfg.spec(nm),
                                 mode=mode, pos=pos, cache=lc,
                                 block_table=block_table,
                                 kv_max_len=kv_max_len, slots=slots,
                                 chunk_lens=chunk_lens, active=active)
    return x, delta


def lm_decode_step(params, cache, tokens: torch.Tensor, pos: torch.Tensor,
                   cfg: ModelConfig,
                   block_table: Optional[torch.Tensor] = None,
                   kv_max_len: Optional[int] = None,
                   active: Optional[torch.Tensor] = None):
    """tokens [B]; pos [B] int32 (cache write index).  ``active`` [B]
    bool freezes the state rows of inactive lanes.  The cache is updated
    in place.  Returns (logits [B, V], cache)."""
    h = _embed(params, tokens[:, None], cfg, pos[:, None])
    x, delta = _step_layers(params, cache, h, pos, cfg, "decode",
                            block_table, kv_max_len, active=active)
    return _logits(params, _final(params, x, delta, cfg)[:, 0], cfg), cache


def _chunk_positions(pos: torch.Tensor, C: int) -> torch.Tensor:
    """[B, C] positions pos[:, None] + arange(C) of a chunk's tokens."""
    return pos[:, None] + torch.arange(C, dtype=pos.dtype, device=pos.device)


def lm_chunk_hidden(params, cache, tokens: torch.Tensor, pos: torch.Tensor,
                    cfg: ModelConfig,
                    block_table: Optional[torch.Tensor] = None,
                    kv_max_len: Optional[int] = None,
                    slots: Optional[torch.Tensor] = None,
                    chunk_lens: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """``lm_chunk_step`` without the LM head: tokens [B, C] appended at
    positions pos[:, None] + arange(C) -> hidden states [B, C, d].  State
    rows advance at ``slots`` by ``chunk_lens`` valid tokens.  The
    serving runner applies the head to each row's last real token only;
    the head is row-wise, so those logits are the rows ``lm_chunk_step``
    returns.  It runs as the chunk program of a prompt (mode 'fill')."""
    h = _embed(params, tokens, cfg, _chunk_positions(pos, tokens.shape[1]))
    x, delta = _step_layers(params, cache, h, pos, cfg, "fill",
                            block_table, kv_max_len, slots=slots,
                            chunk_lens=chunk_lens)
    return x + delta


def lm_chunk_step(params, cache, tokens: torch.Tensor, pos: torch.Tensor,
                  cfg: ModelConfig,
                  block_table: Optional[torch.Tensor] = None,
                  kv_max_len: Optional[int] = None,
                  slots: Optional[torch.Tensor] = None,
                  chunk_lens: Optional[torch.Tensor] = None):
    """Chunked prefill: tokens [B, C] appended against the cache (updated
    in place).  Returns (logits [B, C, V], cache)."""
    h = _embed(params, tokens, cfg, _chunk_positions(pos, tokens.shape[1]))
    x, delta = _step_layers(params, cache, h, pos, cfg, "chunk",
                            block_table, kv_max_len, slots=slots,
                            chunk_lens=chunk_lens)
    return _logits(params, _final(params, x, delta, cfg), cfg), cache


def layer_cache(cfg: ModelConfig, nm: str, lead, batch: int, seq_len: int,
                device, kv_dtype: Optional[torch.dtype] = None,
                pool: bool = False, enc_len: int = 0) -> Any:
    """Zeroed cache entry of layer ``nm`` with stacking dims ``lead``: a
    GQA layer's (k, v) [*lead, batch, min(seq_len, window), KH, hd] (in
    ``kv_dtype``, default the model dtype; the paged engine asks for
    pools with ``pool``, (num_blocks, block_size) in place of (batch,
    seq_len), which no window clamps), an MLA layer's latents (c_kv
    [*lead, batch, seq_len, r], k_rope [*lead, batch, seq_len, rope]),
    a Mamba or RG-LRU layer's state rows for ``batch`` slots; a cross-
    attending layer's ((k, v), (enc_k, enc_v)), the encoder's K/V
    [*lead, batch, enc_len, KH, hd]."""
    spec = cfg.spec(nm)
    if spec.mixer == "mla":
        dtype = kv_dtype or model_dtype(cfg)
        return tuple(torch.zeros(*lead, batch, seq_len, w, dtype=dtype,
                                 device=device)
                     for w in (cfg.mla.kv_lora_rank,
                               cfg.mla.qk_rope_head_dim))
    if spec.mixer == "gqa":
        if spec.window is not None and not pool:
            seq_len = min(seq_len, spec.window)
        dtype = kv_dtype or model_dtype(cfg)

        def kv(s):
            return tuple(torch.zeros(*lead, batch, s, cfg.n_kv_heads,
                                     cfg.head_dim, dtype=dtype,
                                     device=device) for _ in range(2))

        return (kv(seq_len), kv(enc_len)) if spec.cross_attn else kv(seq_len)
    s = cfg.rglru if spec.mixer == "rglru" else cfg.ssm
    h = (s.d_inner,) if spec.mixer == "rglru" else (s.d_inner, s.d_state)
    return (torch.zeros(*lead, batch, s.d_conv - 1, s.d_inner,
                        dtype=model_dtype(cfg), device=device),
            torch.zeros(*lead, batch, *h, dtype=torch.float32,
                        device=device))


def map_layers(cfg: ModelConfig, fn) -> Dict[str, Any]:
    """The {"prefix", "unit", "suffix"} tree of ``fn(name, lead)`` over
    the layer pattern; ``lead`` is (R,) in the unit, () elsewhere."""
    R = cfg.pattern_repeat
    return {"prefix": tuple(fn(nm, ()) for nm in cfg.pattern_prefix),
            "unit": tuple(fn(nm, (R,)) for nm in cfg.pattern_unit)
            if R else (),
            "suffix": tuple(fn(nm, ()) for nm in cfg.pattern_suffix)}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device: DeviceLike = None, enc_len: int = 0) -> Dict[str, Any]:
    """Zeroed contiguous cache for ``batch`` rows of ``seq_len``
    positions (``seq_len`` does not change the size of state leaves;
    ``enc_len`` is the encoder K/V's rows of a cross-attending layer)."""
    check_supported(cfg)
    device = resolve_device(device)
    return map_layers(cfg, lambda nm, lead: layer_cache(
        cfg, nm, lead, batch, seq_len, device, enc_len=enc_len))
