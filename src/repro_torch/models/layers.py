"""Layer assembly: norm + mixer (+ MLP) per LayerSpec (counterpart of
``repro.models.layers``).

Three flavours are ported:
  * the GQA layer: GQA + SwiGLU over the stacked track dim in a
    Parallel-Track model (x [n, B, S, d], every parameter [n, ...]), and
    in the dense ``lm_*`` decoder (x [B, S, d]) with a SwiGLU, GeGLU or
    squared-ReLU MLP, RMSNorm or LayerNorm, and gemma's sandwich norms
    (``post_norm``: ln1_post / ln2_post normalise the mixer's and the
    MLP's output before their residual adds), qk-norm, sliding windows,
    local RoPE and softcaps; the ``lm_*`` layer views x as [1, B, S, d]
    and every parameter and cache leaf with a leading track dim of 1
    (views, no copies) and runs the same code;
  * the Mamba layer of the dense ``lm_*`` decoder, mixer only
    (``mlp="none"``, x [B, S, d]);
  * the RG-LRU layer of the dense ``lm_*`` decoder (recurrentgemma): the
    RG-LRU mixer, then a GeGLU MLP on n = 1 views, x [B, S, d];
  * the MLA layer of the dense ``lm_*`` decoder (deepseek-v2 / -v3):
    Multi-head Latent Attention (``models/mla.py``), then a SwiGLU MLP
    on n = 1 views (the dense prefix) or the capacity-routed MoE
    (``models/moe.py``), x [B, S, d];
  * whisper-medium's layers, GQA with no RoPE, a GELU MLP and LayerNorm:
    the encoder's (no causal mask, mode 'encode': no cache) and the
    decoder's, which add a cross-attention sub-block (ln_x, attention
    over the encoder's K/V, its residual add) between self-attention and
    the MLP.

``layer_step`` is what the model loops run: its caller applies ln1 (the
norm of the residual stream, with the previous layer's pending residual
add, or a track fusion, folded into the same launch: ``norm_in`` and
``models/norms.py``), and it leaves its own last residual add pending
for the next norm; ``layer_apply`` is the whole layer, residuals added.
Both run the modes the serving path needs:
  'prefill' — full-sequence forward, returns the layer's cache
              ((k, v) for GQA, (c_kv, k_rope) latents for MLA, (conv
              window, h) for Mamba and RG-LRU)
  'encode'  — an encoder layer's full-sequence forward, no cache
  'decode'  — one token per row against the layer's cache
  'chunk'   — C tokens per row appended to the layer's cache
A cross-attending layer's cache is ((k, v), (enc_k, enc_v)): the
encoder's K/V are projected at prefill and only read after that.
``layer_train`` is any of these layers in the reference's 'train' mode
(no cache) on plain ops, so that autograd differentiates it: plain
norms, blockwise attention (GQA and MLA), the plain sequential scan
(Mamba and RG-LRU: ``ssm.linear_scan``), the MoE with its auxiliary
loss; no kernel wrapper.
GQA caches are block pools written through the block table, or
contiguous per-slot rows [.., B, S, KH, hd] written at each row's
position (inactive decode lanes keep their rows), or for a window
shorter than the cache ring rows [.., B, W, KH, hd] (slot = position %
W), which a chunk reads at ``slots`` and advances by ``chunk_lens``
valid tokens, as the Mamba rows; MLA caches are latent pools [N, bs, r]
and [N, bs, rope] (or contiguous rows [B, S, r], [B, S, rope]), with no
chunk mode (``mla.mla_chunk`` raises); Mamba and RG-LRU caches are
per-slot state rows, updated in place: the chunk batch
gathers its rows at ``slots``, advances them by ``chunk_lens`` valid
tokens and writes them back (``index_copy_``), and a decode step
rewrites every row with ``active`` lanes frozen (the reference does the
same functionally, on donated buffers).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.common.paged import PagedLeaf
from repro_torch.common.quant import QuantTensor
from repro_torch.common.types import LayerSpec, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mla as mla_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.mlp import MLPS, mlp_apply, mlp_shapes
from repro_torch.models.norms import NORMS, add_norm, apply_norm, plain_norm
from repro_torch.models.params import Leaf

_PT_LAYER = ("gqa", "swiglu")       # (mixer, mlp) of the PT path
_LM_LAYERS = tuple(("gqa", m) for m in MLPS) + (("mamba", "none"),
                                                 ("rglru", "geglu"),
                                                 ("mla", "swiglu"),
                                                 ("mla", "moe"))
_GQA_ROPES = ("rope", "local_rope", "mrope", "none")


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless every layer is a ported flavour: GQA + SwiGLU with
    RMSNorm and plain RoPE in a PT model (no encoder, no cross-attention);
    in a dense ``lm_*`` model GQA with a SwiGLU, GeGLU, GELU or
    squared-ReLU MLP (windows, local RoPE, M-RoPE or none, softcaps,
    qk-norm and sandwich norms too), Mamba alone, RG-LRU + GeGLU, or MLA
    with a SwiGLU MLP or MoE.  An encoder-decoder ``lm_*`` model
    (whisper) has GQA encoder layers (``spec("enc")``) and GQA decoder
    layers with cross-attention."""
    unported = []
    names = cfg.layer_names
    if cfg.encdec is not None:
        if "enc" not in cfg.layer_specs:
            unported.append("encoder-decoder without an 'enc' layer spec")
        else:
            names += ("enc",)
    for nm in names:
        s = cfg.spec(nm)
        if cfg.pt is not None:
            if (s.mixer, s.mlp) != _PT_LAYER:
                unported.append(f"PT layer mixer={s.mixer} mlp={s.mlp}")
            if s.window is not None or s.rope != "rope":
                unported.append(f"PT layer window={s.window} rope={s.rope}")
        elif (s.mixer, s.mlp) not in _LM_LAYERS:
            unported.append(f"lm_* layer mixer={s.mixer} mlp={s.mlp}")
        if s.mixer == "gqa" and s.rope not in _GQA_ROPES:
            unported.append(f"rope={s.rope}")
        if s.cross_attn and (cfg.encdec is None or cfg.pt is not None
                             or s.mixer != "gqa" or nm == "enc"):
            unported.append("cross-attention outside an encoder-decoder's "
                            "GQA decoder layers")
    if cfg.norm not in NORMS:
        unported.append(f"norm={cfg.norm}")
    if cfg.pt is not None and (cfg.post_norm or cfg.qk_norm
                               or cfg.norm != "rmsnorm"):
        unported.append("PT with post_norm / qk_norm / non-RMS norms")
    if cfg.encdec is not None and (
            cfg.pt is not None or "enc" in cfg.layer_specs
            and cfg.spec("enc").mixer != "gqa"):
        unported.append("encoder-decoder other than GQA encoder layers in "
                        "a dense lm_* model")
    if cfg.pt is not None and (cfg.ssm is not None or cfg.rglru is not None):
        unported.append("SSM / RG-LRU in a PT model")
    if unported:
        raise NotImplementedError(
            f"{cfg.name}: not ported to repro_torch yet ("
            + "; ".join(sorted(set(unported)))
            + "); see ROADMAP queue 1, item 3")


def norm_shapes(kind: str, d: int) -> Dict[str, Leaf]:
    """A norm's fp32 leaves, as ``repro.models.norms.norm_init`` makes
    them: RMSNorm's (1 + scale) scale zeros; LayerNorm's scale ones and
    bias zeros."""
    if kind == "layernorm":
        return {"scale": Leaf((d,), fill=torch.ones), "bias": Leaf((d,))}
    return {"scale": Leaf((d,))}


def layer_shapes(cfg: ModelConfig, spec: LayerSpec, d_stream: int,
                 padded: bool = False) -> Dict[str, Any]:
    """Parameter specs of one layer (per track for a PT layer); a MoE
    MLP's experts in the reference's stored layout with ``padded``
    (``moe.moe_shapes``)."""
    norm = norm_shapes(cfg.norm, d_stream)
    if spec.mixer == "mamba":
        return {"ln1": norm, "mixer": ssm_lib.ssm_shapes(cfg, d_stream)}
    if spec.mixer == "rglru":
        mixer = rglru_lib.rglru_shapes(cfg, d_stream)
    elif spec.mixer == "mla":
        mixer = mla_lib.mla_shapes(cfg, d_stream)
    else:
        mixer = attn.attention_shapes(d_stream, cfg.n_heads, cfg.n_kv_heads,
                                      cfg.head_dim, qk_norm=cfg.qk_norm)
    p = {"ln1": norm,
         "mixer": mixer,
         "ln2": norm,
         "mlp": (moe_lib.moe_shapes(cfg, d_stream, padded)
                 if spec.mlp == "moe"
                 else mlp_shapes(spec.mlp, d_stream, cfg.d_ff))}
    if spec.cross_attn:
        p["ln_x"] = norm
        p["cross"] = attn.attention_shapes(d_stream, cfg.n_heads,
                                           cfg.n_kv_heads, cfg.head_dim)
    if cfg.post_norm:
        p["ln1_post"] = norm
        p["ln2_post"] = norm
    return p


def norm_in(cfg: ModelConfig, params, x: torch.Tensor,
            delta: Optional[torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, y): the residual stream with the pending residual ``delta``
    added (None: none pending) and its norm under ``params`` (a
    ``{"scale": ...}`` node), in one launch."""
    if delta is None:
        return x, apply_norm(cfg.norm, params, x, eps=cfg.norm_eps)
    return add_norm(cfg.norm, params, x, delta, eps=cfg.norm_eps)


def _write_rows(cache, new_rows, slots: Optional[torch.Tensor]):
    """Write advanced state rows into the per-slot leaves in place: at
    ``slots`` (a chunk batch), or every row when ``slots`` is None."""
    for leaf, row in zip(cache, new_rows):
        if slots is None:
            leaf.copy_(row)
        else:
            leaf.index_copy_(0, slots, row.to(leaf.dtype))
    return cache


_RECURRENT = {"mamba": (ssm_lib.ssm_apply, ssm_lib.ssm_decode,
                        ssm_lib.ssm_chunk),
              "rglru": (rglru_lib.rglru_apply, rglru_lib.rglru_decode,
                        rglru_lib.rglru_chunk)}


def _recurrent(params, h: torch.Tensor, *, cfg: ModelConfig, mixer: str,
               mode: str, cache: Any, slots: Optional[torch.Tensor],
               chunk_lens: Optional[torch.Tensor],
               active: Optional[torch.Tensor]):
    """A Mamba or RG-LRU mixer on its per-slot state rows."""
    apply, decode, chunk = _RECURRENT[mixer]
    if mode == "prefill":
        return apply(params, h, cfg=cfg, return_cache=True)
    if mode == "decode":
        out, new_rows = decode(params, h, cache, cfg=cfg, active=active)
        return out, _write_rows(cache, new_rows, None)
    if mode in ("chunk", "fill"):
        rows = cache if slots is None else tuple(l[slots] for l in cache)
        out, new_rows = chunk(params, h, rows, cfg=cfg, chunk_lens=chunk_lens)
        return out, _write_rows(cache, new_rows, slots)
    raise ValueError(f"unknown layer mode {mode!r}")


def _mla(params, h: torch.Tensor, *, cfg: ModelConfig, spec: LayerSpec,
         mode: str, positions, pos, cache, block_table, kv_max_len, active):
    """An MLA mixer: prefill, or decode against its latent pools or
    rows (no chunk mode: ``mla.mla_chunk`` raises)."""
    if mode == "prefill":
        return mla_lib.mla_apply(params, h, spec=spec, cfg=cfg,
                                 positions=positions, return_cache=True)
    if mode == "decode":
        return mla_lib.mla_decode(params, h, cache, spec=spec, cfg=cfg,
                                  pos=pos, block_table=block_table,
                                  kv_max_len=kv_max_len, active=active)
    if mode in ("chunk", "fill"):
        return mla_lib.mla_chunk()
    raise ValueError(f"unknown layer mode {mode!r}")


def _gqa(params, h: torch.Tensor, *, cfg: ModelConfig, spec: LayerSpec,
         mode: str, positions, pos, cache, block_table, kv_max_len, active,
         lengths, slots, chunk_lens):
    if mode in ("prefill", "encode"):
        return attn.attention_apply(params, h, spec=spec, cfg=cfg,
                                    positions=positions,
                                    return_cache=mode == "prefill",
                                    lengths=lengths)
    if mode == "decode":
        return attn.attention_decode(params, h, cache, spec=spec, cfg=cfg,
                                     pos=pos, block_table=block_table,
                                     kv_max_len=kv_max_len, active=active)
    if mode in ("chunk", "fill"):
        return attn.attention_chunk(params, h, cache, spec=spec, cfg=cfg,
                                    pos=pos, block_table=block_table,
                                    kv_max_len=kv_max_len, slots=slots,
                                    chunk_lens=chunk_lens,
                                    prefill=mode == "fill")
    raise ValueError(f"unknown layer mode {mode!r}")


def _track1(tree):
    """An lm_* GQA layer's parameters or cache with a leading track dim
    of 1: views of every tensor, QuantTensor and PagedLeaf."""
    if isinstance(tree, dict):
        return {k: _track1(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_track1(v) for v in tree)
    if isinstance(tree, (torch.Tensor, QuantTensor, PagedLeaf)):
        return tree[None]
    return tree


def _untrack1(tree):
    """The inverse of ``_track1`` on a tree of tensors: track 0 of each."""
    if isinstance(tree, tuple):
        return tuple(_untrack1(v) for v in tree)
    return tree[0]


def _post(cfg: ModelConfig, params, name: str,
          h: torch.Tensor) -> torch.Tensor:
    """A sublayer's output before its residual add: normed under
    ``name`` with ``cfg.post_norm`` (the sandwich), else as it is."""
    if not cfg.post_norm:
        return h
    return apply_norm(cfg.norm, params[name], h, eps=cfg.norm_eps)


def _step(params, x: torch.Tensor, y: torch.Tensor, *, cfg: ModelConfig,
          spec: LayerSpec, mode: str, positions, pos, cache, block_table,
          kv_max_len, slots, chunk_lens, active, lengths, enc_states
          ) -> Tuple[torch.Tensor, torch.Tensor, Any]:
    if spec.mixer in _RECURRENT or spec.mixer == "mla":
        if spec.mixer == "mla":
            h, new_cache = _mla(params["mixer"], y, cfg=cfg, spec=spec,
                                mode=mode, positions=positions, pos=pos,
                                cache=cache, block_table=block_table,
                                kv_max_len=kv_max_len, active=active)
        else:
            h, new_cache = _recurrent(params["mixer"], y, cfg=cfg,
                                      mixer=spec.mixer, mode=mode,
                                      cache=cache, slots=slots,
                                      chunk_lens=chunk_lens, active=active)
        if spec.mlp == "none":
            return x, h, new_cache
        x, y = norm_in(cfg, params["ln2"], x, _post(cfg, params, "ln1_post",
                                                    h))
        if spec.mlp == "moe":
            h = moe_lib.moe_apply(params["mlp"], y, cfg=cfg,
                                  phase="chunk" if mode == "fill" else mode)
        else:
            # the MLP's weights take a track dim of 1, as a GQA layer's
            h = mlp_apply(_track1(params["mlp"]), y[None], spec.mlp)[0]
        return x, _post(cfg, params, "ln2_post", h), new_cache
    # a cross-attending layer's cache is (self K/V, encoder K/V); the
    # encoder's are projected at prefill and only read after that
    self_cache, enc_kv = (cache if spec.cross_attn and cache is not None
                          else (cache, None))
    h, new_cache = _gqa(params["mixer"], y, cfg=cfg, spec=spec, mode=mode,
                        positions=positions, pos=pos, cache=self_cache,
                        block_table=block_table, kv_max_len=kv_max_len,
                        active=active, lengths=lengths, slots=slots,
                        chunk_lens=chunk_lens)
    h = _post(cfg, params, "ln1_post", h)
    if spec.cross_attn:
        if enc_kv is None:
            enc_kv = attn.cross_kv(params["cross"], enc_states)
        x, y = norm_in(cfg, params["ln_x"], x, h)
        h = attn.cross_attention_apply(params["cross"], y, enc_kv, cfg=cfg,
                                       mode=mode)
        new_cache = (new_cache, enc_kv)
    x, y = norm_in(cfg, params["ln2"], x, h)
    return x, _post(cfg, params, "ln2_post",
                    mlp_apply(params["mlp"], y, spec.mlp)), new_cache


def layer_step(params, x: torch.Tensor, y: torch.Tensor, *,
               cfg: ModelConfig, spec: LayerSpec, mode: str,
               positions: Optional[torch.Tensor] = None,
               pos: Optional[torch.Tensor] = None, cache: Any = None,
               block_table: Optional[torch.Tensor] = None,
               kv_max_len: Optional[int] = None,
               slots: Optional[torch.Tensor] = None,
               chunk_lens: Optional[torch.Tensor] = None,
               active: Optional[torch.Tensor] = None,
               lengths: Optional[torch.Tensor] = None,
               enc_states: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, Any]:
    """One layer whose ln1 the caller applied: x the residual stream (in a
    PT model possibly one fused row broadcast to every track), y =
    ln1(x).  Returns (x, delta, cache): the layer's output is x + delta,
    the add left for the next norm to fold in (``norm_in``).  Arguments
    and cache as ``layer_apply``; mode 'fill' is 'chunk' run as the
    chunk program of a prompt (``attention_chunk(prefill=True)``), mode
    'encode' an encoder layer's prefill, which returns no cache.  A
    cross-attending layer's residual adds run in the reference's order,
    each in the model dtype: self-attention's (folded into ln_x's
    launch), cross-attention's (into ln2's), the MLP's (left pending)."""
    kw = dict(cfg=cfg, spec=spec, mode=mode, positions=positions, pos=pos,
              block_table=block_table, kv_max_len=kv_max_len, slots=slots,
              chunk_lens=chunk_lens, active=active, lengths=lengths)
    if cfg.pt is None and spec.mixer == "gqa":
        # an lm_* GQA layer runs the PT layer's code at n = 1, on views
        x1, d1, c1 = _step(_track1(params), x[None], y[None],
                           cache=_track1(cache),
                           enc_states=_track1(enc_states), **kw)
        if mode == "prefill":
            cache = _untrack1(c1)
        return x1[0], d1[0], cache
    return _step(params, x, y, cache=cache, enc_states=enc_states, **kw)


def layer_train(params, x: torch.Tensor, *, cfg: ModelConfig,
                spec: LayerSpec, positions: torch.Tensor,
                enc_states: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer in train mode, the reference's ``layer_apply(mode=
    "train")`` on plain ops: ln1, the mixer (GQA and MLA on
    ``blockwise_attention``, Mamba and RG-LRU on ``ssm.linear_scan``),
    ln1_post, the residual add, for a cross-attending layer ln_x, cross-
    attention over ``enc_states`` projected here and the residual add,
    then (unless the layer has no MLP) ln2, the MLP or the MoE, ln2_post,
    the residual add; every norm the plain one (``plain_norm``), so that
    no kernel wrapper runs and autograd differentiates it.  x [n, B, S,
    d] with track-stacked params (PT), or [B, S, d] (lm_*: a GQA layer
    runs on n = 1 views; enc_states [B, S_enc, d]).  Returns (the
    layer's output, its auxiliary loss: the MoE's, else an fp32 zero)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    views = cfg.pt is None and spec.mixer == "gqa"
    if views:
        params, x = _track1(params), x[None]
        enc_states = _track1(enc_states)

    def norm(name, h):
        return plain_norm(cfg.norm, params[name], h, eps=cfg.norm_eps)

    def post(name, h):
        return norm(name, h) if cfg.post_norm else h

    y = norm("ln1", x)
    if spec.mixer == "gqa":
        h, _ = attn.attention_apply(params["mixer"], y, spec=spec, cfg=cfg,
                                    positions=positions, train=True)
    elif spec.mixer == "mla":
        h, _ = mla_lib.mla_apply(params["mixer"], y, spec=spec, cfg=cfg,
                                 positions=positions, train=True)
    else:                       # Mamba or RG-LRU: its apply function
        apply = _RECURRENT[spec.mixer][0]
        h, _ = apply(params["mixer"], y, cfg=cfg, train=True)
    x = x + post("ln1_post", h)
    if spec.cross_attn:
        x = x + attn.cross_attention_apply(
            params["cross"], norm("ln_x", x),
            attn.cross_kv(params["cross"], enc_states), cfg=cfg,
            mode="train")
    if spec.mlp == "none":
        return (x[0] if views else x), aux
    y = norm("ln2", x)
    if spec.mlp == "moe":
        h, aux = moe_lib.moe_train(params["mlp"], y, cfg=cfg)
    elif views or cfg.pt is not None:
        h = mlp_apply(params["mlp"], y, spec.mlp)
    else:
        # the MLP's weights take a track dim of 1, as a GQA layer's
        h = mlp_apply(_track1(params["mlp"]), y[None], spec.mlp)[0]
    x = x + post("ln2_post", h)
    return (x[0] if views else x), aux


def layer_apply(params, x: torch.Tensor, *, cfg: ModelConfig,
                spec: LayerSpec, mode: str,
                positions: Optional[torch.Tensor] = None,
                pos: Optional[torch.Tensor] = None, cache: Any = None,
                block_table: Optional[torch.Tensor] = None,
                kv_max_len: Optional[int] = None,
                slots: Optional[torch.Tensor] = None,
                chunk_lens: Optional[torch.Tensor] = None,
                active: Optional[torch.Tensor] = None,
                lengths: Optional[torch.Tensor] = None,
                enc_states: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Any]:
    """One layer.  A PT layer takes x [n, B, S, d] and params leaves
    [n, ...]; an lm_* layer x [B, S, d].  'prefill' takes ``positions``
    [B, S] and returns (x, cache); 'decode' and 'chunk' take ``pos`` [B]
    (the row's first new position) and this layer's cache: a GQA layer's
    pools with the block table, or its contiguous rows; a Mamba or
    RG-LRU layer's state rows with ``slots`` [B] (chunk rows -> engine
    slots; None when the rows align with the batch) and ``chunk_lens``
    [B] (valid tokens of a padded final chunk).  ``active`` [B] marks the decode lanes
    whose contiguous rows or state may change.  A cross-attending layer
    (whisper's decoder) takes the encoder's output ``enc_states`` [B,
    S_enc, d] in 'prefill' and returns its cache as ((k, v), (enc_k,
    enc_v)); in 'decode' and 'chunk' it reads that cache's encoder K/V
    and writes only its own.  Returns (x, cache).
    (The reference also returns an auxiliary MoE loss, a training
    quantity: ``layer_train`` computes it.)"""
    x, y = norm_in(cfg, params["ln1"], x, None)
    x, delta, cache = layer_step(params, x, y, cfg=cfg, spec=spec,
                                 mode=mode, positions=positions, pos=pos,
                                 cache=cache, block_table=block_table,
                                 kv_max_len=kv_max_len, slots=slots,
                                 chunk_lens=chunk_lens, active=active,
                                 lengths=lengths, enc_states=enc_states)
    return x + delta, cache
