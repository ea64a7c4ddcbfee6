"""qwen2-vl-72b (M-RoPE, precomputed input embeddings) and
recurrentgemma-9b (RG-LRU beside windowed MQA) in the port's ``lm_*``
decoder against the JAX package on the CPU: ``mrope_cos_sin`` and its
section check, the three RG-LRU functions (whole prompt, a padded chunk,
a decode step with a frozen lane), whole reduced models (qwen2-vl from
precomputed embeddings with distinct (t, h, w) streams, then decode;
recurrentgemma's prefill logits), configs, parameter trees and the
weight bridge, leaf kinds and serving capabilities, greedy engine
streams (recurrentgemma with chunked prefill at L 3, 8, 9, as
``tests/test_serving.py::test_chunked_prefill_serves_ring_and_state_archs``)
and the serve CLI.  One JAX ``init_lm`` tree per model
(``reduced_config``: qwen2-vl 4 layers, d 64, hd 16, sections (2, 3, 3);
recurrentgemma 8 layers (rec, rec, attn) x 2 + (rec, rec), d_inner 64 in
4 blocks, window 16) is loaded into both packages; op-level inputs are
drawn with numpy.

Tolerances: single ops fp32 2e-5, as tests/test_kernels.py; whole-model
logits 1e-4, as tests/test_torch_model.py; greedy streams identical.
The port's RG-LRU scan is sequential (the ``ssm_scan`` kernel's plain
version on the CPU) where the reference scans chunks associatively: the
sums differ in order only, well inside 2e-5 at these sizes."""
import functools
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.types import LayerSpec as JLayerSpec
from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.models import decoder as jdec
from repro.models import rglru as jrglru
from repro.models import rope as jrope
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import arch_capabilities as j_arch_capabilities
from repro_torch.common.paged import leaf_kind
from repro_torch.common.types import LayerSpec
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import decoder, rglru
from repro_torch.models import rope
from repro_torch.serving.cache import PagedKVCache
from repro_torch.serving.engine import Engine, RequestState, arch_capabilities
from repro_torch.weights import from_jax_params

OP_TOL = 2e-5
MODEL_TOL = 1e-4
QWEN, RG = "qwen2-vl-72b", "recurrentgemma-9b"
ARCHS = (QWEN, RG)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs on several pytest-xdist
    workers at once, and these shapes are too small to gain from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(t, j, tol=OP_TOL):
    np.testing.assert_allclose(np.asarray(t.detach().float()),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _x(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(JAX config, port config, JAX tree, port tree) of ``arch`` reduced."""
    jcfg, cfg = j_reduced_config(arch), reduced_config(arch)
    jparams = jax.jit(lambda k: jdec.init_lm(k, jcfg))(jax.random.PRNGKey(5))
    return jcfg, cfg, jparams, from_jax_params(_np(jparams), cfg,
                                               device="cpu")


def _rec_layer(j=0):
    """recurrentgemma's unit layer j (a 'rec' position), repeat 1: (JAX
    mixer params, port mixer params)."""
    _, cfg, jparams, params = _model(RG)
    assert cfg.pattern_unit[j] == "rec"
    jl = jax.tree_util.tree_map(lambda a: a[1], jparams["unit"][j]["mixer"])
    return jl, decoder._at(params["unit"][j], 1)["mixer"]


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sections", [(2, 3, 3), (16, 24, 24)])
def test_mrope_cos_sin_matches_reference(sections):
    """cos / sin of random distinct (t, h, w) streams [3, B, S] at qwen2-vl's
    theta; equal streams give the plain RoPE tables; sections that do not
    sum to hd / 2 raise in both packages."""
    hd = 2 * sum(sections)
    rng = np.random.default_rng(sum(sections))
    pos = rng.integers(0, 4096, size=(3, 2, 9)).astype(np.int32)
    want = jrope.mrope_cos_sin(jnp.asarray(pos), hd, 1e6, sections)
    got = rope.mrope_cos_sin(_t(pos), hd, 1e6, sections)
    for a, b in zip(got, want):
        assert tuple(a.shape) == (2, 9, hd // 2)
        _close(a, b)
    same = rope.mrope_positions_default(2, 9, 5)
    np.testing.assert_array_equal(
        np.asarray(same), np.asarray(jrope.mrope_positions_default(2, 9, 5)))
    for a, b in zip(rope.mrope_cos_sin(same, hd, 1e6, sections),
                    rope.rope_cos_sin(same[0], hd, 1e6)):
        assert torch.equal(a, b)
    bad = sections[:2] + (sections[2] + 1,)
    with pytest.raises(ValueError, match="sum"):
        rope.mrope_cos_sin(_t(pos), hd, 1e6, bad)
    with pytest.raises(ValueError, match="sum"):
        jrope.mrope_cos_sin(jnp.asarray(pos), hd, 1e6, bad)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def test_rglru_apply_matches_reference():
    """Whole prompt of 16 tokens (two of the reference's scan chunks of 8)
    from a non-zero h0: the output, the conv window and h_last; a prompt
    shorter than the window (S 2) pads the window as the reference."""
    _, cfg, _, _ = _model(RG)
    jcfg = j_reduced_config(RG)
    jl, tl = _rec_layer(0)
    rng = np.random.default_rng(1)
    x = _x(rng, 2, 16, cfg.d_model)
    h0 = _x(rng, 2, cfg.rglru.d_inner) * 0.5
    japply = jax.jit(functools.partial(jrglru.rglru_apply, cfg=jcfg,
                                       return_cache=True))
    jout, (jconv, jh) = japply(jl, jnp.asarray(x), h0=jnp.asarray(h0))
    out, (conv, h) = rglru.rglru_apply(tl, _t(x), cfg=cfg, return_cache=True,
                                       h0=_t(h0))
    _close(out, jout)
    _close(conv, jconv)
    _close(h, jh)
    jout, (jconv, jh) = japply(jl, jnp.asarray(x[:, :2]))
    out, (conv, h) = rglru.rglru_apply(tl, _t(x[:, :2]), cfg=cfg,
                                       return_cache=True)
    _close(out, jout)
    _close(conv, jconv)
    _close(h, jh)


def test_rglru_chunk_and_decode_match_reference():
    """A chunk of 8 onto a carried state with the second row's last 3
    positions padded (``chunk_lens`` 8, 5: identity updates, kept out of
    the window), then a decode step with the second lane frozen
    (``active``)."""
    _, cfg, _, _ = _model(RG)
    jcfg = j_reduced_config(RG)
    jl, tl = _rec_layer(1)
    rng = np.random.default_rng(2)
    dc, di = cfg.rglru.d_conv, cfg.rglru.d_inner
    x = _x(rng, 2, 8, cfg.d_model)
    conv, h = _x(rng, 2, dc - 1, di), _x(rng, 2, di) * 0.5
    lens = np.asarray([8, 5], np.int32)
    jout, (jconv, jh) = jax.jit(functools.partial(
        jrglru.rglru_chunk, cfg=jcfg))(
        jl, jnp.asarray(x), (jnp.asarray(conv), jnp.asarray(h)),
        chunk_lens=jnp.asarray(lens))
    out, (tconv, th) = rglru.rglru_chunk(tl, _t(x), (_t(conv), _t(h)),
                                         cfg=cfg, chunk_lens=_t(lens))
    _close(out, jout)
    _close(tconv, jconv)
    _close(th, jh)
    xd = _x(rng, 2, 1, cfg.d_model)
    active = np.asarray([True, False])
    jout, (jconv2, jh2) = jax.jit(functools.partial(
        jrglru.rglru_decode, cfg=jcfg))(
        jl, jnp.asarray(xd), (jconv, jh), active=jnp.asarray(active))
    out, (tconv2, th2) = rglru.rglru_decode(tl, _t(xd), (tconv, th),
                                            cfg=cfg, active=_t(active))
    _close(out, jout)
    _close(tconv2, jconv2)
    _close(th2, jh2)
    assert torch.equal(th2[1], th[1]) and torch.equal(tconv2[1], tconv[1])


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

def _grid_positions(B, S, grid=4):
    """(t, h, w) streams of a patch grid: ``grid`` x ``grid`` patches a
    frame, one frame after another (distinct streams), [3, B, S]."""
    i = np.arange(S)
    t = i // (grid * grid)
    hw = i % (grid * grid)
    pos = np.stack([t, hw // grid, hw % grid]).astype(np.int32)
    return np.broadcast_to(pos[:, None], (3, B, S)).copy()


def test_qwen2_vl_embeddings_prefill_and_decode_match_reference():
    """qwen2-vl from precomputed embeddings [2, 24, d] with distinct grid
    (t, h, w) streams: prefill logits and cache against the reference's
    ``lm_forward``; then four decode steps of text tokens into the port's
    paged cache (the prefill rows inserted) against ``lm_decode_step`` on
    the reference's contiguous cache; and with ``embed[tokens]`` as the
    inputs and three equal streams the logits equal the token prefill's."""
    jcfg, cfg, jparams, params = _model(QWEN)
    rng = np.random.default_rng(3)
    B, S = 2, 24
    emb = _x(rng, B, S, cfg.d_model) * 0.3
    pos = _grid_positions(B, S)
    jl, jcache, _ = jax.jit(lambda p, e, ps: jdec.lm_forward(
        p, {"inputs": e, "positions": ps}, jcfg, mode="prefill"))(
        jparams, emb, pos)
    tl, cache = decoder.lm_forward(params, {"inputs": _t(emb),
                                            "positions": _t(pos)}, cfg)
    _close(tl, jl, MODEL_TOL)
    for a, b in zip(jax.tree_util.tree_leaves(cache),
                    jax.tree_util.tree_leaves(jcache)):
        _close(a, b, MODEL_TOL)
    # decode after it: the reference's cache padded to capacity 32
    cap = 32
    jc = jax.tree_util.tree_map(
        lambda a: jnp.pad(a, [(0, 0)] * (a.ndim - 3) + [(0, cap - S)]
                          + [(0, 0)] * 2), jcache)
    kv = PagedKVCache(cfg, max_slots=B, max_seq_len=cap, block_size=8,
                      device="cpu")
    for s in range(B):
        kv.allocate(s, cap)
    kv.insert_prefill(cache, range(B), kv.table())
    jstep = jax.jit(lambda p, c, t, ps: jdec.lm_decode_step(p, c, t, ps,
                                                            jcfg))
    teacher = rng.integers(1, cfg.vocab_size, size=(4, B)).astype(np.int32)
    for k in range(4):
        p_k = np.full((B,), S + k, np.int32)
        jld, jc = jstep(jparams, jc, teacher[k], p_k)
        tld, _ = decoder.lm_decode_step(params, kv.engine_cache(),
                                        _t(teacher[k]).long(), _t(p_k), cfg,
                                        block_table=kv.table(),
                                        kv_max_len=cap)
        _close(tld, jld, MODEL_TOL)
    toks = rng.integers(1, cfg.vocab_size, size=(B, S))
    by_tok, _ = decoder.lm_forward(params, {"inputs": _t(toks)}, cfg)
    by_emb, _ = decoder.lm_forward(params, {
        "inputs": params["embed"][_t(toks)],
        "positions": rope.mrope_positions_default(B, S)}, cfg)
    assert torch.equal(by_tok, by_emb)


def test_recurrentgemma_prefill_and_chunks_match_reference():
    """recurrentgemma's prefill logits and cache (two rows of 20 tokens,
    past the 16-token window: rings) against the reference; then chunks
    of 8 into the port's paged cache (state rows, rings) against the
    reference's ``lm_chunk_step`` on its contiguous cache, the second
    row's last chunk padded."""
    jcfg, cfg, jparams, params = _model(RG)
    rng = np.random.default_rng(4)
    toks = rng.integers(1, cfg.vocab_size, size=(2, 20)).astype(np.int32)
    jl, jcache, _ = jax.jit(lambda p, t: jdec.lm_forward(
        p, {"inputs": t}, jcfg, mode="prefill"))(jparams, toks)
    tl, cache = decoder.lm_forward(params, {"inputs": _t(toks).long()}, cfg)
    _close(tl, jl, MODEL_TOL)
    for a, b in zip(jax.tree_util.tree_leaves(cache),
                    jax.tree_util.tree_leaves(jcache)):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b, MODEL_TOL)
    lens = np.asarray([24, 21])
    toks = rng.integers(1, cfg.vocab_size, size=(2, 24)).astype(np.int32)
    jc = jdec.init_cache(jcfg, 2, 40)
    kv = PagedKVCache(cfg, max_slots=2, max_seq_len=40, block_size=8,
                      device="cpu")
    for s in range(2):
        kv.allocate(s, int(lens[s]))
    jchunk = jax.jit(lambda p, c, t, ps, cl: jdec.lm_chunk_step(
        p, c, t, ps, jcfg, chunk_lens=cl))
    for c in range(0, 24, 8):
        ps = np.full((2,), c, np.int32)
        cl = np.clip(lens - c, 0, 8).astype(np.int32)
        jlc, jc = jchunk(jparams, jc, toks[:, c:c + 8], ps, cl)
        tlc, _ = decoder.lm_chunk_step(
            params, kv.engine_cache(), _t(toks[:, c:c + 8]).long(), _t(ps),
            cfg, block_table=kv.table(), slots=torch.arange(2),
            chunk_lens=_t(cl).long())
        for b in range(2):
            _close(tlc[b, :cl[b]], np.asarray(jlc)[b, :cl[b]], MODEL_TOL)


_FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
           "vocab_size", "head_dim", "pattern_prefix", "pattern_unit",
           "pattern_repeat", "pattern_suffix", "norm", "norm_eps",
           "post_norm", "qk_norm", "final_logit_softcap",
           "embedding_multiplier", "tie_embeddings", "rope_theta",
           "local_rope_theta", "mrope_sections", "input_kind", "dtype")


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_param_trees_and_bridge_match_reference(arch):
    """Configs field by field (layer specs and the RG-LRU sub-config
    too), the full-size and reduced ``init_lm`` trees by path, shape and
    dtype (nothing allocated at full size), the port's own init (Λ
    spreading a over (0.9, 0.999)), and the bridge refusing a tree with a
    leaf missing."""
    for mine, theirs in ((get_config(arch), j_get_config(arch)),
                         (reduced_config(arch), j_reduced_config(arch))):
        assert mine.name == theirs.name
        for f in _FIELDS:
            assert getattr(mine, f) == getattr(theirs, f), f
        if theirs.rglru is not None:
            assert asdict(mine.rglru) == asdict(theirs.rglru)
        else:
            assert mine.rglru is None
        for nm, s in theirs.layer_specs.items():
            assert mine.spec(nm) == LayerSpec(**{
                f: getattr(s, f) for f in LayerSpec.__dataclass_fields__}), nm
            assert isinstance(s, JLayerSpec)
        jtree = jax.eval_shape(lambda: jdec.init_lm(jax.random.PRNGKey(0),
                                                    theirs))
        specs = decoder.lm_param_specs(mine)
        jl, sl = (jax.tree_util.tree_leaves_with_path(x)
                  for x in (jtree, specs))
        assert [p for p, _ in jl] == [p for p, _ in sl]
        for (_, j), (_, s) in zip(jl, sl):
            assert tuple(j.shape) == tuple(s.shape)
            want = torch.float32 if j.dtype == jnp.float32 else torch.bfloat16
            assert s.dtype(decoder.model_dtype(mine)) == want
    jcfg, cfg, jparams, params = _model(arch)
    mine = decoder.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    for a, b in zip(jax.tree_util.tree_leaves(mine),
                    jax.tree_util.tree_leaves(params)):
        assert a.shape == b.shape and a.dtype == b.dtype
    if cfg.rglru is not None:
        lam = mine["suffix"][0]["mixer"]["lam"]
        a = torch.exp(-cfg.rglru.c * torch.nn.functional.softplus(lam))
        assert 0.9 < a.min() and a.max() < 0.999
    bad = _np(jparams)
    del bad["unit"][0]["ln2"]
    with pytest.raises(ValueError, match="keys"):
        from_jax_params(bad, cfg, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_kinds_and_capabilities_match_reference(arch):
    """The paged cache's leaf kinds (recurrentgemma: state rows for the
    RG-LRU layers, rings or pools for the attention layers by capacity;
    qwen2-vl: pools), pool and state bytes against the reference's
    ``PagedKVCache``; ``arch_capabilities`` equal to the reference's,
    reasons included (recurrentgemma: no prefix cache, speculation or
    int8 KV; chunked prefill on)."""
    jcfg, cfg, jparams, _ = _model(arch)
    for cap in (12, 40):
        kv = PagedKVCache(cfg, max_slots=3, max_seq_len=cap, block_size=4,
                          device="cpu")
        jkv = JEngine(jcfg, jparams, max_slots=3, max_seq_len=cap,
                      block_size=4, prefix_cache=False).runner.kv
        assert kv.leaf_kinds() == jkv.leaf_kinds(), cap
        assert kv.all_pageable == jkv.all_pageable
        assert kv.pool_bytes() == jkv.utilization()["pool_bytes"]
        # the row leaves: the reference's dense cache rows of every layer
        # whose leaves are not pooled, for the 3 slots
        jc = jdec.init_cache(jcfg, 3, cap)
        want = sum(leaf.size * leaf.dtype.itemsize
                   for grp in ("prefix", "unit", "suffix")
                   for nm, entry in zip(getattr(jcfg, f"pattern_{grp}"),
                                        jc[grp])
                   if leaf_kind(cfg.spec(nm), cap) != "paged"
                   for leaf in jax.tree_util.tree_leaves(entry))
        assert kv.state_bytes() == want, cap
    theirs = {k: (c.supported, c.reason)
              for k, c in j_arch_capabilities(jcfg).items()}
    assert {k: (c.supported, c.reason)
            for k, c in arch_capabilities(cfg).items()} == theirs
    if arch == RG:
        assert theirs["chunked_prefill"] == (True, None)
        assert not any(theirs[k][0] for k in ("prefix_cache", "speculative",
                                              "int8_kv"))


@functools.lru_cache(maxsize=None)
def _jax_streams(arch, chunk):
    """The JAX engine's greedy streams of the prompts of L 3, 8 and 9
    (``_prompts``), 5 new tokens each, 2 slots, capacity 32."""
    jcfg, _, jparams, _ = _model(arch)
    eng = JEngine(jcfg, jparams, max_slots=2, max_seq_len=32,
                  prefill_chunk=chunk, prefix_cache=False)
    assert eng.runner.prefill_chunk == chunk
    return eng.generate(_prompts(arch), 5)


def _prompts(arch):
    v = reduced_config(arch).vocab_size
    return [[(5 * i + 2) % v for i in range(L)] for L in (3, 8, 9)]


@pytest.mark.parametrize("arch,chunk,knobs", [
    (RG, 4, {}), (RG, 4, {"pipeline_depth": 1, "preplan": True}),
    (RG, 0, {}), (QWEN, 0, {}), (QWEN, 0, {"prefill_chunk": 4})])
def test_engine_streams_match_reference(arch, chunk, knobs):
    """The port's engine (paged cache; recurrentgemma with chunked
    prefill of 4 at L 3, 8, 9, as the reference's own test, sync and
    pipelined with planned programs, and whole-prompt) against the JAX
    engine's streams; every request finishes; the int8-KV request of a
    ring / state arch falls back as the reference's does."""
    _, cfg, _, params = _model(arch)
    want = _jax_streams(arch, chunk if arch == RG else 0)
    eng = Engine(cfg, params, device="cpu", max_slots=2, max_seq_len=32,
                 prefix_cache=False, **{"prefill_chunk": chunk, **knobs})
    assert eng.runner.prefill_chunk == knobs.get("prefill_chunk", chunk)
    reqs = [eng.submit(p, 5) for p in _prompts(arch)]
    eng.run()
    assert all(r.state is RequestState.DONE for r in reqs)
    assert [r.output for r in reqs] == want
    if arch == RG and not knobs:
        jcfg, _, jparams, _ = _model(arch)
        mine = Engine(cfg, params, device="cpu", max_slots=2, max_seq_len=32,
                      kv_dtype="int8", speculate_k=2).runner
        jr = JEngine(jcfg, jparams, max_slots=2, max_seq_len=32,
                     kv_dtype="int8").runner
        assert mine.kv_dtype is None and mine.speculate_k == 0
        assert mine.quant_fallbacks[0] == jr.quant_fallbacks[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_reduced_on_cpu(arch, capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--requests", "3", "--input-len", "20",
                       "--output-len", "4", "--slots", "2",
                       "--prefill-chunk", "8"]) == 0
    out = capsys.readouterr().out
    assert "finished 3/3 requests" in out
    assert ("'state'" in out) == (arch == RG)
