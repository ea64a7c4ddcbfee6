"""The layer features of gemma2-2b, gemma3-4b and nemotron-4-15b in the
port's ``lm_*`` decoder against the JAX package on the CPU: LayerNorm,
the squared-ReLU and GeGLU MLPs, qk-norm with local RoPE, windowed
prefill with the per-row ring build from right-padded rows, ring decode
across the wrap, the ring chunk and the windowed contiguous chunk,
softcap on the paged decode and chunk paths, the flash kernel's plain
offset route against the chunk program's masked softmax, whole reduced
models (prefill, chained chunks, decode), parameter trees and the weight
bridge, the paged cache's leaf kinds, serving capabilities, greedy
engine streams and the serve CLI.  One JAX ``init_lm`` tree per model
(``reduced_config``: gemma2 4 layers of window 16 / global, gemma3 10
layers with 8 of window 16, nemotron 4 layers; d 64) is loaded into
both packages; op-level inputs are drawn with numpy.

Tolerances: single ops fp32 2e-5, as tests/test_kernels.py; whole-model
logits 1e-4, as tests/test_torch_model.py; greedy streams identical."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.types import LayerSpec as JLayerSpec
from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.models import attention as jattn
from repro.models import decoder as jdec
from repro.models import mlp as jmlp
from repro.models import norms as jnorms
from repro.runtime.parallel import NO_PARALLEL
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import arch_capabilities as j_arch_capabilities
from repro_torch.common.paged import PagedLeaf
from repro_torch.common.types import LayerSpec
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models import attention as attn
from repro_torch.models import decoder
from repro_torch.models.layers import _track1
from repro_torch.models.mlp import mlp_apply
from repro_torch.models.norms import apply_norm
from repro_torch.serving.cache import PagedKVCache
from repro_torch.serving.engine import Engine, RequestState, arch_capabilities
from repro_torch.weights import from_jax_params

OP_TOL = 2e-5
MODEL_TOL = 1e-4
ARCHS = ("gemma2-2b", "gemma3-4b", "nemotron-4-15b")


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


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(JAX config, port config, JAX tree, port tree) of ``arch`` reduced."""
    jcfg, cfg = j_reduced_config(arch), reduced_config(arch)
    jparams = jax.jit(lambda k: jdec.init_lm(k, jcfg))(jax.random.PRNGKey(3))
    return jcfg, cfg, jparams, from_jax_params(_np(jparams), cfg,
                                               device="cpu")


def _layer(arch, j):
    """Unit layer j (repeat 0) of ``arch``: (spec name, JAX params, port
    params with a track dim of 1)."""
    jcfg, cfg, jparams, params = _model(arch)
    jl = jax.tree_util.tree_map(lambda a: a[0], jparams["unit"][j])
    tl = _track1(decoder._at(params["unit"][j], 0))
    return cfg.pattern_unit[j], jl, tl


def _x(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# norms, MLPs, qk-norm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["layernorm", "sqrelu", "geglu"])
def test_layernorm_sqrelu_geglu_match_reference(kind):
    """LayerNorm (scale, bias, fp32 statistics, eps 1e-5) on rows and
    with per-track rows; the squared-ReLU MLP (no gate) and GeGLU (tanh
    GELU gate) on the reference's init."""
    rng = np.random.default_rng(1)
    x = _x(rng, 2, 5, 48) * 3 + 1
    if kind == "layernorm":
        p = {"scale": _x(rng, 48), "bias": _x(rng, 48)}
        want = jnorms.layernorm(p, jnp.asarray(x), eps=1e-5)
        tp = {k: _t(v) for k, v in p.items()}
        _close(apply_norm("layernorm", tp, _t(x), eps=1e-5), want)
        # per-track rows [n, d] against x [n, ..., d]
        two = {k: torch.stack([v, v + 1]) for k, v in tp.items()}
        got = apply_norm("layernorm", two, _t(x), eps=1e-5)
        _close(got[1], jnorms.layernorm({k: v + 1 for k, v in p.items()},
                                        jnp.asarray(x[1]), eps=1e-5))
        return
    p = jmlp.mlp_init(jax.random.PRNGKey(2), kind, 48, 96)
    want = jmlp.mlp_apply(p, jnp.asarray(x), kind)
    got = mlp_apply({k: _t(v)[None] for k, v in p.items()}, _t(x)[None],
                    kind)[0]
    _close(got, want)


@pytest.mark.parametrize("j", [0, 5])
def test_qk_norm_and_local_rope_projection_match_reference(j):
    """gemma3's q / k / v projections: the q and k heads RMS-normed under
    their own scales (non-zero here), then RoPE at the local theta (layer
    0) or the global one (layer 5)."""
    jcfg, cfg, _, _ = _model("gemma3-4b")
    nm, jl, tl = _layer("gemma3-4b", j)
    rng = np.random.default_rng(j)
    for name in ("q_norm", "k_norm"):
        s = _x(rng, cfg.head_dim) * 0.3
        jl["mixer"][name] = {"scale": jnp.asarray(s)}
        tl["mixer"][name] = {"scale": _t(s)[None]}
    x = _x(rng, 2, 7, cfg.d_model)
    pos = np.stack([np.arange(7), np.arange(7) + 30]).astype(np.int32)
    want = jax.jit(lambda p, x, ps: jattn._project_qkv(
        p, x, jcfg.spec(nm), jcfg, ps, NO_PARALLEL))(
        jl["mixer"], jnp.asarray(x), jnp.asarray(pos))
    got = attn._project_qkv(tl["mixer"], _t(x)[None], cfg.spec(nm), cfg,
                            _t(pos))
    for a, b in zip(got, want):
        _close(a[0], b)


# ---------------------------------------------------------------------------
# windowed attention: prefill, rings, decode, chunks, softcap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [32, 12])
def test_windowed_prefill_and_ring_build_match_reference(S):
    """gemma3's local layer (window 16) over right-padded rows of 30 and
    21 (S 32: the cache is the per-row ring) or 12 and 7 (S 12 < W: the
    cache is the rows as they are)."""
    jcfg, cfg, _, _ = _model("gemma3-4b")
    nm, jl, tl = _layer("gemma3-4b", 0)
    rng = np.random.default_rng(S)
    x = _x(rng, 2, S, cfg.d_model)
    lens = np.asarray([S - 2, S - 11 if S > 12 else 7], np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    wout, wcache = jax.jit(lambda p, x, ps, ln: jattn.attention_apply(
        p, x, spec=jcfg.spec(nm), cfg=jcfg, positions=ps, return_cache=True,
        lengths=ln))(jl["mixer"], jnp.asarray(x), jnp.asarray(pos),
                     jnp.asarray(lens))
    gout, gcache = attn.attention_apply(
        tl["mixer"], _t(x)[None], spec=cfg.spec(nm), cfg=cfg,
        positions=_t(pos), return_cache=True, lengths=_t(lens))
    for b, L in enumerate(lens):      # the padded rows are not compared
        _close(gout[0, b, :L], np.asarray(wout)[b, :L])
    for a, w in zip(gcache, wcache):
        assert tuple(a.shape[1:]) == tuple(w.shape)
        _close(a[0], w)


def test_ring_decode_across_the_wrap_matches_reference():
    """Rings of a prefill of 12 and 9 tokens (zero-padded to W = 16),
    then 22 decode steps: each row's slots wrap past W, one lane frozen
    on odd steps."""
    jcfg, cfg, _, _ = _model("gemma3-4b")
    nm, jl, tl = _layer("gemma3-4b", 0)
    spec, W = cfg.spec(nm), cfg.spec(nm).window
    rng = np.random.default_rng(7)
    x = _x(rng, 2, 12, cfg.d_model)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    _, (k, v) = jax.jit(lambda p, x, ps: jattn.attention_apply(
        p, x, spec=jcfg.spec(nm), cfg=jcfg, positions=ps,
        return_cache=True))(jl["mixer"], jnp.asarray(x), jnp.asarray(pos))
    jstep = jax.jit(lambda p, x, c, ps, a: jattn.attention_decode(
        p, x, c, spec=jcfg.spec(nm), cfg=jcfg, pos=ps, active=a))
    ring = [np.zeros((2, W) + k.shape[2:], np.float32) for _ in range(2)]
    ring[0][:, :12], ring[1][:, :12] = np.asarray(k), np.asarray(v)
    jc = tuple(jnp.asarray(r) for r in ring)
    tc = tuple(_t(r)[None] for r in ring)
    p = np.asarray([12, 9], np.int32)
    for t in range(22):
        xt = _x(rng, 2, 1, cfg.d_model)
        act = np.asarray([True, t % 2 == 0])
        jo, jc = jstep(jl["mixer"], jnp.asarray(xt), jc, jnp.asarray(p),
                       jnp.asarray(act))
        to, tc = attn.attention_decode(tl["mixer"], _t(xt)[None], tc,
                                       spec=spec, cfg=cfg, pos=_t(p),
                                       active=_t(act), kv_max_len=64)
        _close(to[0][act], np.asarray(jo)[act])
        p = p + act
    for a, w in zip(tc, jc):
        _close(a[0], w)


def test_ring_chunk_and_windowed_dense_chunk_match_reference():
    """Chunks of 8 from position 0 into the rings of engine slots 2 and 0
    of a 3-slot ring cache (the second row's last chunk holds 5 real
    tokens): the context rows and the rings after each chunk; then the
    same chunks against a contiguous cache of 40 (> W: the window mask on
    the dense chunk)."""
    jcfg, cfg, _, _ = _model("gemma3-4b")
    nm, jl, tl = _layer("gemma3-4b", 0)
    spec, W = cfg.spec(nm), cfg.spec(nm).window
    KH, hd = cfg.n_kv_heads, cfg.head_dim
    rng = np.random.default_rng(8)
    x = _x(rng, 2, 32, cfg.d_model)
    lens = np.asarray([32, 21])
    slots = np.asarray([2, 0])
    for S in (W, 40):
        rows = 3 if S == W else 2
        zeros = np.zeros((rows, S, KH, hd), np.float32)
        jc = (jnp.asarray(zeros), jnp.asarray(zeros))
        jchunk = jax.jit(lambda p, x, c, ps, **kw: jattn.attention_chunk(
            p, x, c, spec=jcfg.spec(nm), cfg=jcfg, pos=ps, **kw))
        tc = (_t(zeros)[None], _t(zeros)[None])
        for c in range(0, 32, 8):
            cl = np.clip(lens - c, 0, 8).astype(np.int32)
            kw = dict(slots=slots, chunk_lens=cl) if S == W else {}
            jo, jc = jchunk(jl["mixer"], jnp.asarray(x[:, c:c + 8]), jc,
                            jnp.full((2,), c, jnp.int32),
                            **{k: jnp.asarray(v) for k, v in kw.items()})
            to, tc = attn.attention_chunk(
                tl["mixer"], _t(x[:, c:c + 8])[None], tc, spec=spec, cfg=cfg,
                pos=torch.full((2,), c, dtype=torch.int32),
                **{k: _t(v).long() for k, v in kw.items()})
            for b in range(2):
                if cl[b]:
                    _close(to[0, b, :cl[b]], np.asarray(jo)[b, :cl[b]])
            for a, w in zip(tc, jc):
                _close(a[0], w)


def _paged(rows, bs):
    """Rows [B, S, KH, hd] as a one-layer pool [1, N, bs, KH, hd] (block
    0 the trash block) and its table [B, S / bs]."""
    B, S = rows.shape[:2]
    nb = S // bs
    pool = np.zeros((1, B * nb + 1, bs) + rows.shape[2:], np.float32)
    pool[0, 1:] = rows.reshape(B * nb, bs, *rows.shape[2:])
    table = (np.arange(B * nb).reshape(B, nb) + 1).astype(np.int32)
    return PagedLeaf(_t(pool)), _t(table)


def test_softcap_on_paged_decode_and_chunk_matches_reference():
    """gemma2's global layer (softcap 50) on the port's block pools
    against the reference's contiguous cache (the same function): a
    chunk of 8 at positions 13 and 4, then three decode steps."""
    jcfg, cfg, _, _ = _model("gemma2-2b")
    nm, jl, tl = _layer("gemma2-2b", 1)
    spec = cfg.spec(nm)
    assert spec.attn_logit_softcap == 50.0 and spec.window is None
    KH, hd = cfg.n_kv_heads, cfg.head_dim
    rng = np.random.default_rng(9)
    rows = [_x(rng, 2, 32, KH, hd) for _ in range(2)]
    jc = tuple(jnp.asarray(r) for r in rows)
    (kl, table), (vl, _) = _paged(rows[0], 8), _paged(rows[1], 8)
    pos = np.asarray([13, 4], np.int32)
    x = _x(rng, 2, 8, cfg.d_model) * 4          # scores past the cap
    jo, jc = jax.jit(lambda p, x, c, ps: jattn.attention_chunk(
        p, x, c, spec=jcfg.spec(nm), cfg=jcfg, pos=ps))(
        jl["mixer"], jnp.asarray(x), jc, jnp.asarray(pos))
    jstep = jax.jit(lambda p, x, c, ps: jattn.attention_decode(
        p, x, c, spec=jcfg.spec(nm), cfg=jcfg, pos=ps))
    to, _ = attn.attention_chunk(tl["mixer"], _t(x)[None], (kl, vl),
                                 spec=spec, cfg=cfg, pos=_t(pos),
                                 block_table=table)
    _close(to[0], jo)
    p = pos + 8
    for t in range(3):
        xt = _x(rng, 2, 1, cfg.d_model) * 4
        jo, jc = jstep(jl["mixer"], jnp.asarray(xt), jc, jnp.asarray(p))
        to, _ = attn.attention_decode(tl["mixer"], _t(xt)[None], (kl, vl),
                                      spec=spec, cfg=cfg, pos=_t(p),
                                      block_table=table, kv_max_len=32)
        _close(to[0], jo)
        p = p + 1


@pytest.mark.parametrize("window,softcap", [(None, None), (5, 30.0)])
def test_flash_offset_route_plain_matches_the_chunk_softmax(window, softcap):
    """The flash kernel's plain version with per-row query offsets and
    key lengths (the route the chunk program takes on the card) against
    the chunk program's masked softmax over the same gathered rows."""
    rng = np.random.default_rng(11)
    B, C, S, H, KH, hd = 3, 6, 24, 4, 2, 16
    q = _t(_x(rng, 1, B, C, H, hd))
    k, v = (_t(_x(rng, 1, B, S, KH, hd)) for _ in range(2))
    pos = torch.tensor([0, 7, 18], dtype=torch.int32)
    positions = pos[:, None] + torch.arange(C, dtype=torch.int32)[None]
    mask = attn._chunk_mask(positions, S, window)
    want = attn._masked_ctx(q, k, v, mask, torch.float32, softcap)[0]
    got = flash_attention_plain(q[0], k[0], v[0], causal=True,
                                softcap=softcap, window=window,
                                q_offset=pos,
                                k_lengths=torch.clamp(pos + C, max=S))
    _close(got, want)


# ---------------------------------------------------------------------------
# whole models, trees, caches, capabilities
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_lm_prefill_chunks_and_decode_match_reference(arch):
    """Prefill of rows of 30 and 21 tokens right-padded to 32 (logits and
    the cache: rings per row); chunks of 8 into the port's paged cache of
    capacity 48 (rings for the windowed layers) against the reference's
    contiguous cache; four decode steps after them, across the rings'
    wrap."""
    jcfg, cfg, jparams, params = _model(arch)
    rng = np.random.default_rng(1)
    lens = np.asarray([30, 21], np.int32)
    toks = np.zeros((2, 32), np.int32)
    for i, L in enumerate(lens):
        toks[i, :L] = rng.integers(1, cfg.vocab_size, size=L)
    jl, jpre, _ = jax.jit(lambda p, t, ln: jdec.lm_forward(
        p, {"inputs": t, "lengths": ln}, jcfg, mode="prefill"))(
        jparams, toks, lens)
    tl, pre = decoder.lm_forward(params, {"inputs": _t(toks).long(),
                                          "lengths": _t(lens).long()}, cfg)
    _close(tl, jl, MODEL_TOL)
    for a, b in zip(jax.tree_util.tree_leaves(pre),
                    jax.tree_util.tree_leaves(jpre)):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b, MODEL_TOL)
    jc = jdec.init_cache(jcfg, 2, 48)
    kv = PagedKVCache(cfg, max_slots=2, max_seq_len=48, block_size=8,
                      device="cpu")
    for s in range(2):
        kv.allocate(s, int(lens[s]) + 4)
    table = kv.table()
    jchunk = jax.jit(lambda p, c, t, ps, cl: jdec.lm_chunk_step(
        p, c, t, ps, jcfg, chunk_lens=cl))
    for c in range(0, 32, 8):
        pos = np.full((2,), c, np.int32)
        cl = np.clip(lens - c, 0, 8).astype(np.int32)
        jlc, jc = jchunk(jparams, jc, toks[:, c:c + 8], pos, cl)
        tlc, _ = decoder.lm_chunk_step(
            params, kv.engine_cache(), _t(toks[:, c:c + 8]).long(), _t(pos),
            cfg, block_table=table, slots=torch.arange(2),
            chunk_lens=_t(cl).long())
        for b in range(2):
            _close(tlc[b, :cl[b]], np.asarray(jlc)[b, :cl[b]], MODEL_TOL)
    jstep = jax.jit(lambda p, c, t, ps: jdec.lm_decode_step(p, c, t, ps,
                                                            jcfg))
    teacher = rng.integers(1, cfg.vocab_size, size=(4, 2)).astype(np.int32)
    for t in range(4):
        pos = (lens + t).astype(np.int32)
        jld, jc = jstep(jparams, jc, teacher[t], pos)
        tld, _ = decoder.lm_decode_step(params, kv.engine_cache(),
                                        _t(teacher[t]).long(), _t(pos), cfg,
                                        block_table=table, kv_max_len=48)
        _close(tld, jld, MODEL_TOL)


_FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
           "vocab_size", "head_dim", "pattern_prefix", "pattern_unit",
           "pattern_repeat", "pattern_suffix", "norm", "norm_eps",
           "post_norm", "qk_norm", "final_logit_softcap",
           "embedding_multiplier", "tie_embeddings", "rope_theta",
           "local_rope_theta", "dtype")


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_param_trees_and_bridge_match_reference(arch):
    """Configs field by field (layer specs too), the full-size and the
    reduced ``init_lm`` tree by path, shape and dtype (nothing allocated
    at full size), the port's own init, and the bridge refusing a tree
    with a leaf missing."""
    for mine, theirs in ((get_config(arch), j_get_config(arch)),
                         (reduced_config(arch), j_reduced_config(arch))):
        assert mine.name == theirs.name
        for f in _FIELDS:
            assert getattr(mine, f) == getattr(theirs, f), f
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
    if cfg.norm == "layernorm":       # LayerNorm scales start at one
        assert torch.equal(mine["final_norm"]["scale"],
                           torch.ones(cfg.d_model))
    bad = _np(jparams)
    del bad["unit"][0]["ln2"]
    with pytest.raises(ValueError, match="keys"):
        from_jax_params(bad, cfg, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_kinds_and_capabilities_match_reference(arch):
    """The paged cache's leaf kinds (rings for windows shorter than the
    capacity, pools for the rest), pool bytes and ``all_pageable``
    against the reference's ``PagedKVCache`` at capacities below and
    above the window; ``arch_capabilities`` equal to the reference's,
    reasons included."""
    jcfg, cfg, jparams, _ = _model(arch)
    for cap in (12, 40):
        kv = PagedKVCache(cfg, max_slots=3, max_seq_len=cap, block_size=4,
                          device="cpu")
        jkv = JEngine(jcfg, jparams, max_slots=3, max_seq_len=cap,
                      block_size=4, prefix_cache=False).runner.kv
        assert kv.leaf_kinds() == jkv.leaf_kinds(), cap
        assert kv.all_pageable == jkv.all_pageable
        assert kv.pool_bytes() == jkv.utilization()["pool_bytes"]
    theirs = {k: (c.supported, c.reason)
              for k, c in j_arch_capabilities(jcfg).items()}
    assert {k: (c.supported, c.reason)
            for k, c in arch_capabilities(cfg).items()} == theirs


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_streams_match_reference(arch):
    """The JAX engine once (4 prompts of 17-30 tokens: one prefill
    bucket past the window), the port's engine on the paged cache (rings
    for the windowed layers), with chunked prefill (chunk 8), on the
    contiguous cache and pipelined with planned programs: identical
    greedy streams; windowed models keep the reference's fallbacks
    (no prefix cache, no int8 KV)."""
    jcfg, cfg, jparams, params = _model(arch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=(L,)).tolist()
               for L in (30, 17, 25, 22)]
    kw = dict(max_slots=4, max_seq_len=48)
    jeng = JEngine(jcfg, jparams, prefix_cache=False, **kw)
    jreqs = [jeng.submit(p, 8) for p in prompts]
    jeng.run()
    want = [r.output for r in jreqs]
    for knobs in ({}, {"prefill_chunk": 8}, {"paged": False},
                  {"pipeline_depth": 1, "preplan": True}):
        eng = Engine(cfg, params, device="cpu", **kw, **knobs)
        reqs = [eng.submit(p, 8) for p in prompts]
        eng.run()
        assert all(r.state is RequestState.DONE for r in reqs)
        assert [r.output for r in reqs] == want, knobs
    eng = Engine(cfg, params, device="cpu", kv_dtype="int8", **kw)
    jr = JEngine(jcfg, jparams, kv_dtype="int8", **kw).runner
    assert eng.runner.quant_fallbacks == jr.quant_fallbacks
    assert eng.runner.prefix_cache == jr.prefix_cache
    assert eng.runner.kv.leaf_kinds() == jr.kv.leaf_kinds()


def test_serve_cli_gemma3_reduced_on_cpu(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", "gemma3-4b", "--reduced", "--device", "cpu",
                       "--requests", "3", "--input-len", "20",
                       "--output-len", "4", "--slots", "2"]) == 0
    out = capsys.readouterr().out
    assert "finished 3/3 requests" in out and "'ring'" in out
