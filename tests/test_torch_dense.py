"""The paper's dense baselines through the port's GQA ``lm_*`` decoder, and
the contiguous cache with its decode kernel, against the JAX package on
the CPU: the plain ``decode_attention`` against the Pallas kernel
(interpret mode) and the jnp oracle, a GQA layer's contiguous decode
step, the whole reduced dense model in prefill, chunk and decode on the
paged and the contiguous cache, the reduced PT model on the contiguous
cache, the parameter tree and the weight bridge, the configs, the paged
cache's GQA pools, the engine's greedy token streams (dense paged and
contiguous, PT contiguous, falcon-mamba contiguous, dense with int8
weights and int8 KV), the contiguous cache's fallbacks and the serve
CLI.  One JAX ``init_lm`` / ``init_pt`` tree is loaded into both
packages; the models are ``reduced_config("dense-6b")`` (8 layers, d 64,
8 heads, 2 KV heads) and its PT form.

Tolerances: single ops fp32 2e-5, as tests/test_kernels.py; whole-model
logits 1e-4, as tests/test_torch_model.py; greedy streams identical."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.core import track as jtrack
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import decoder as jdec
from repro.models import layers as jlayers
from repro.serving.cache import batch_axes as j_batch_axes
from repro.serving.cache import insert_rows as j_insert_rows
from repro.serving.engine import Engine as JEngine
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import track
from repro_torch.kernels import ops, ref
from repro_torch.models import decoder, layers
from repro_torch.serving.cache import PagedKVCache, insert_rows
from repro_torch.serving.engine import Engine, RequestState
from repro_torch.weights import from_jax_params

OP_TOL = 2e-5
MODEL_TOL = 1e-4
ARCH = "dense-6b"


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


def _close_tree(t, j, tol):
    tl, jl = jax.tree_util.tree_leaves(t), jax.tree_util.tree_leaves(j)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b, tol)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = j_reduced_config(ARCH), reduced_config(ARCH)
    jparams = jax.jit(lambda k: jdec.init_lm(k, jcfg))(jax.random.PRNGKey(3))
    return jcfg, cfg, jparams, from_jax_params(_np(jparams), cfg,
                                               device="cpu")


@pytest.fixture(scope="module")
def pt_model():
    jcfg, cfg = j_reduced_config("pt-6b-d4"), reduced_config("pt-6b-d4")
    jparams = jax.jit(lambda k: jtrack.init_pt(k, jcfg))(
        jax.random.PRNGKey(4))
    return jcfg, cfg, jparams, from_jax_params(_np(jparams), cfg,
                                               device="cpu")


# ---------------------------------------------------------------------------
# (i) the contiguous-cache decode kernel's plain version
# ---------------------------------------------------------------------------

def _dense_inputs(B, S, KH, G, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KH * G, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KH, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KH, hd)).astype(np.float32)
    lengths = rng.integers(1, S + 1, size=(B,)).astype(np.int32)
    return q, k, v, lengths


_oracle = jax.jit(jref.decode_attention_ref)

# (B, S, KH, G, hd, block_s, max_len, int8 cache): G 1 and 4; the
# max_len cut to two tiles of 16 (a row longer than the cut sees only
# the cut); a cut of less than one tile; no cut; fp32 and int8 caches
_DENSE_CASES = [(3, 64, 2, 1, 16, 16, 20, False),
                (2, 64, 2, 4, 32, 16, 32, True),
                (4, 48, 1, 4, 8, 16, 5, False),
                (2, 32, 2, 4, 16, 512, None, True)]


@pytest.mark.parametrize("B,S,KH,G,hd,block_s,max_len,int8", _DENSE_CASES)
def test_decode_attention_plain_matches_pallas_and_oracle(
        B, S, KH, G, hd, block_s, max_len, int8):
    q, k, v, lengths = _dense_inputs(B, S, KH, G, hd, seed=B * S + G)
    scales = {}
    if int8:
        k8, v8 = (np.clip(np.round(x * 20), -127, 127).astype(np.int8)
                  for x in (k, v))
        ks, vs = (np.random.default_rng(G).uniform(0.01, 0.1, (B, S, KH, 1))
                  .astype(np.float32) for _ in range(2))
        k, v = k8, v8
        scales = dict(k_scale=ks, v_scale=vs)
    tq, tk, tv, tl = _t(q), _t(k), _t(v), _t(lengths)
    ts = {n: _t(a) for n, a in scales.items()}
    mine = ref.decode_attention_plain(tq, tk, tv, tl, block_s=block_s,
                                      max_len=max_len, **ts)
    assert mine.shape == (B, KH * G, hd) and mine.dtype == torch.float32
    want = jops.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        block_s=block_s, max_len=max_len,
        **{n: jnp.asarray(a) for n, a in scales.items()})
    _close(mine, want)
    # the oracle sees the cut as shorter rows, and the dequantized cache
    bs = min(block_s, S)
    cut = S if max_len is None else min(S, max(1, -(-max_len // bs)) * bs)
    kd, vd = ((k * scales["k_scale"], v * scales["v_scale"]) if int8
              else (k, v))
    _close(mine, _oracle(
        jnp.asarray(q), jnp.asarray(kd, jnp.float32),
        jnp.asarray(vd, jnp.float32), jnp.minimum(jnp.asarray(lengths), cut)))
    # on CPU tensors the wrapper is the plain version and counts nothing
    before = ops.launch_counts()
    assert torch.equal(ops.decode_attention(tq, tk, tv, tl, block_s=block_s,
                                            max_len=max_len, **ts), mine)
    assert ops.launch_counts() == before


def test_decode_attention_plain_takes_a_non_tiling_length():
    """The Pallas kernel needs S % block_s == 0; the port takes any S."""
    q, k, v, lengths = _dense_inputs(3, 37, 2, 4, 16, seed=7)
    mine = ref.decode_attention_plain(_t(q), _t(k), _t(v), _t(lengths),
                                      block_s=16, max_len=37)
    _close(mine, _oracle(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(lengths)))
    with pytest.raises(ValueError, match="int32"):
        ops.decode_attention(_t(q), _t(k), _t(v), _t(lengths).long())
    with pytest.raises(ValueError, match="int8"):
        ops.decode_attention(_t(q), _t(k), _t(v), _t(lengths),
                             k_scale=_t(k[..., :1]), v_scale=_t(v[..., :1]))


# ---------------------------------------------------------------------------
# (ii) one GQA layer of the lm_* decoder: prefill and contiguous decode
# ---------------------------------------------------------------------------

def test_gqa_layer_contiguous_decode_matches_reference(model):
    """Layer 0 of the dense model, prefill then one decode step against
    the contiguous cache, lanes: active, inactive (its row stays frozen)
    and inactive at pos == S (the reference drops that write)."""
    jcfg, cfg, jparams, params = model
    spec, jspec = cfg.spec("full"), jcfg.spec("full")
    lp = decoder._at(params["unit"][0], 0)
    jlp = jax.tree_util.tree_map(lambda l: l[0], jparams["unit"][0])
    rng = np.random.default_rng(11)
    B, S, d = 3, 16, cfg.d_model
    x = rng.standard_normal((B, 9, d)).astype(np.float32)
    pos9 = np.broadcast_to(np.arange(9, dtype=np.int32), (B, 9))
    jx, jc, _ = jax.jit(lambda p, x, ps: jlayers.layer_apply(
        p, x, cfg=jcfg, spec=jspec, mode="prefill", positions=ps))(
            jlp, x, pos9)
    tx, tc = layers.layer_apply(lp, _t(x), cfg=cfg, spec=spec,
                                mode="prefill", positions=_t(pos9))
    _close(tx, jx, MODEL_TOL)
    _close_tree(tc, jc, MODEL_TOL)
    # a full [B, S] cache holding random rows, decode one token
    kc, vc = (rng.standard_normal((B, S, cfg.n_kv_heads, cfg.head_dim))
              .astype(np.float32) for _ in range(2))
    xd = rng.standard_normal((B, 1, d)).astype(np.float32)
    pos = np.asarray([9, 4, S], np.int32)
    act = np.asarray([True, False, False])
    jo, (jk, jv), _ = jax.jit(lambda p, x, c, ps, a: jlayers.layer_apply(
        p, x, cfg=jcfg, spec=jspec, mode="decode", pos=ps, cache=c,
        active=a))(jlp, xd, (kc, vc), pos, act)
    cache = (_t(kc.copy()), _t(vc.copy()))
    to, tcache = layers.layer_apply(lp, _t(xd), cfg=cfg, spec=spec,
                                    mode="decode", pos=_t(pos), cache=cache,
                                    active=_t(act), kv_max_len=S)
    assert tcache[0] is cache[0]                       # written in place
    _close(to[0], jo[0], MODEL_TOL)                    # the active lane
    _close(tcache[0], jk, MODEL_TOL)
    _close(tcache[1], jv, MODEL_TOL)
    # the active lane's row at pos 9 is new; the other lanes keep theirs
    assert not np.array_equal(np.asarray(jk)[0], kc[0])
    np.testing.assert_array_equal(np.asarray(jk)[1:], kc[1:])
    np.testing.assert_array_equal(tcache[0][1:].numpy(), kc[1:])
    np.testing.assert_array_equal(tcache[1][1:].numpy(), vc[1:])


# ---------------------------------------------------------------------------
# (iii) the whole reduced dense model, paged and contiguous
# ---------------------------------------------------------------------------

def test_lm_prefill_and_contiguous_decode_match_reference(model):
    """Prefill at a bucket of 16 (rows of 13 and 9 tokens, right-padded),
    the rows into a contiguous cache of 32, then three teacher-forced
    decode steps with one lane frozen in the second."""
    jcfg, cfg, jparams, params = model
    rng = np.random.default_rng(5)
    lens = np.asarray([13, 9], np.int32)
    toks = np.zeros((2, 16), np.int32)
    for i, L in enumerate(lens):
        toks[i, :L] = rng.integers(1, cfg.vocab_size, size=(L,))
    jlogits, jpre, _ = jax.jit(lambda p, t: jdec.lm_forward(
        p, {"inputs": t}, jcfg, mode="prefill"))(jparams, toks)
    logits, pre = decoder.lm_forward(params, {"inputs": _t(toks).long()},
                                     cfg)
    _close(logits, jlogits, MODEL_TOL)
    _close_tree(pre, jpre, MODEL_TOL)
    jc = j_insert_rows(jdec.init_cache(jcfg, 3, 32), jpre,
                       j_batch_axes(jdec.init_cache, jcfg), [2, 0])
    tc = decoder.init_cache(cfg, 3, 32, device="cpu")
    insert_rows(tc, pre, [2, 0])
    _close_tree(tc, jc, MODEL_TOL)
    jstep = jax.jit(lambda p, c, t, ps, a: jdec.lm_decode_step(
        p, c, t, ps, jcfg, active=a))
    teacher = rng.integers(1, cfg.vocab_size, size=(3, 3)).astype(np.int32)
    for t in range(3):
        pos = np.asarray([lens[1] + t, 0, lens[0] + t], np.int32)
        act = np.asarray([True, False, t != 1])
        jl, jc = jstep(jparams, jc, teacher[t], pos, act)
        tl, tc = decoder.lm_decode_step(params, tc, _t(teacher[t]).long(),
                                        _t(pos), cfg, active=_t(act),
                                        kv_max_len=32)
        _close(tl[act], np.asarray(jl)[act], MODEL_TOL)
    _close_tree(tc, jc, MODEL_TOL)


def test_lm_paged_chunk_and_decode_match_reference(model):
    """Chunked prefill (chunk 8; the second row's last chunk holds 3 real
    tokens) then three decode steps on the port's paged cache (block 8),
    against the reference's own chunk and decode steps on its contiguous
    cache, which compute the same function; the port's contiguous decode
    after the same chunks lands on the same logits."""
    jcfg, cfg, jparams, params = model
    rng = np.random.default_rng(6)
    lens = np.asarray([16, 11], np.int32)
    toks = rng.integers(1, cfg.vocab_size, size=(2, 16)).astype(np.int32)
    toks[1, 11:] = 0
    jc = jdec.init_cache(jcfg, 2, 32)
    kv = PagedKVCache(cfg, max_slots=2, max_seq_len=32, block_size=8,
                      device="cpu")
    for slot in range(2):
        kv.allocate(slot, int(lens[slot]) + 3)
    table = kv.table()
    jchunk = jax.jit(lambda p, c, t, ps: jdec.lm_chunk_step(
        p, c, t, ps, jcfg))
    for start in (0, 8):
        pos = np.full((2,), start, np.int32)
        jl, jc = jchunk(jparams, jc, toks[:, start:start + 8], pos)
        tl, _ = decoder.lm_chunk_step(params, kv.engine_cache(),
                                      _t(toks[:, start:start + 8]).long(),
                                      _t(pos), cfg, block_table=table)
        _close(tl, jl, MODEL_TOL)
    jstep = jax.jit(lambda p, c, t, ps: jdec.lm_decode_step(p, c, t, ps,
                                                            jcfg))
    teacher = rng.integers(1, cfg.vocab_size, size=(3, 2)).astype(np.int32)
    for t in range(3):
        pos = lens + t
        jl, jc = jstep(jparams, jc, teacher[t], pos)
        tl, _ = decoder.lm_decode_step(params, kv.engine_cache(),
                                       _t(teacher[t]).long(), _t(pos), cfg,
                                       block_table=table, kv_max_len=32)
        _close(tl, jl, MODEL_TOL)
    # the paged pools gathered through the table are the reference rows
    from repro_torch.models.attention import pool_read
    k_leaf = kv.engine_cache()["unit"][0][0][0]
    _close(pool_read(k_leaf[None], table)[0][:, :19],
           np.asarray(jc["unit"][0][0])[0, :, :19], MODEL_TOL)


def test_pt_contiguous_decode_matches_reference(pt_model):
    """The reduced PT model: prefill, rows into the contiguous
    [R, D, n, B, S, KH, hd] cache, three decode steps with a frozen lane
    (tracks folded into the kernel's batch)."""
    jcfg, cfg, jparams, params = pt_model
    rng = np.random.default_rng(8)
    toks = rng.integers(1, cfg.vocab_size, size=(2, 16)).astype(np.int32)
    _, jpre, _ = jax.jit(lambda p, t: jtrack.pt_forward(
        p, {"inputs": t}, jcfg, mode="prefill"))(jparams, toks)
    _, pre = track.pt_forward(params, {"inputs": _t(toks).long()}, cfg)
    jc = j_insert_rows(jtrack.pt_init_cache(jcfg, 2, 24), jpre,
                       j_batch_axes(jtrack.pt_init_cache, jcfg), [1, 0])
    tc = track.pt_init_cache(cfg, 2, 24, device="cpu")
    insert_rows(tc, pre, [1, 0])
    jstep = jax.jit(lambda p, c, t, ps, a: jtrack.pt_decode_step(
        p, c, t, ps, jcfg, active=a))
    teacher = rng.integers(1, cfg.vocab_size, size=(3, 2)).astype(np.int32)
    for t in range(3):
        pos = np.full((2,), 16 + t, np.int32)
        act = np.asarray([True, t != 1])
        jl, jc = jstep(jparams, jc, teacher[t], pos, act)
        tl, tc = track.pt_decode_step(params, tc, _t(teacher[t]).long(),
                                      _t(pos), cfg, active=_t(act),
                                      kv_max_len=24)
        _close(tl[act], np.asarray(jl)[act], MODEL_TOL)
    _close_tree(tc, jc, MODEL_TOL)


# ---------------------------------------------------------------------------
# (iv) parameters, configs, the paged cache's GQA pools
# ---------------------------------------------------------------------------

_FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
           "d_ff", "vocab_size", "rope_theta", "tie_embeddings", "norm",
           "norm_eps", "dtype", "pattern_unit", "logits_fp32")


@pytest.mark.parametrize("arch", ["dense-6b", "dense-13b", "dense-30b",
                                  "tinyllama-1.1b"])
def test_configs_and_param_trees_match_reference(arch):
    for mine, theirs in ((get_config(arch), j_get_config(arch)),
                         (reduced_config(arch), j_reduced_config(arch))):
        assert mine.name == theirs.name
        for f in _FIELDS:
            assert getattr(mine, f) == getattr(theirs, f), f
        # the full-size tree by shape only: nothing is allocated
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


def test_init_lm_and_bridge(model):
    jcfg, cfg, jparams, params = model
    mine = decoder.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    for a, b in zip(jax.tree_util.tree_leaves(mine),
                    jax.tree_util.tree_leaves(params)):
        assert a.shape == b.shape and a.dtype == b.dtype
    wq = params["unit"][0]["mixer"]["wq"]
    assert wq.shape == (cfg.n_layers, cfg.d_model, cfg.n_heads,
                        cfg.head_dim)
    # the reference's init stds: wq ~ 1/sqrt(d), wo ~ 1/sqrt(H * hd)
    assert abs(mine["unit"][0]["mixer"]["wq"].std().item()
               * cfg.d_model ** 0.5 - 1) < 0.1
    bad = _np(jparams)
    bad["unit"][0]["mixer"]["wk"] = bad["unit"][0]["mixer"]["wk"][..., :1, :]
    with pytest.raises(ValueError, match="wk"):
        from_jax_params(bad, cfg, device="cpu")


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_paged_cache_lays_out_gqa_pools_as_the_reference(model, kv_dtype):
    jcfg, cfg, jparams, _ = model
    kv = PagedKVCache(cfg, max_slots=3, max_seq_len=40, block_size=8,
                      kv_dtype=kv_dtype, device="cpu")
    jkv = JEngine(jcfg, jparams, max_slots=3, max_seq_len=40, block_size=8,
                  prefix_cache=False, kv_dtype=kv_dtype).runner.kv
    k_leaf, v_leaf = kv.engine_cache()["unit"][0]
    assert tuple(k_leaf.pool.shape) == (cfg.n_layers, kv.num_blocks, 8,
                                        cfg.n_kv_heads, cfg.head_dim)
    assert (k_leaf.scale is None) == (kv_dtype is None)
    mine, theirs = kv.utilization(), jkv.utilization()
    for key in ("num_blocks", "leaf_kinds", "kv_dtype", "pool_bytes",
                "bytes_per_block"):
        assert mine[key] == theirs[key], key
    assert kv.leaf_kinds() == {"paged": 2} and kv.all_pageable
    assert kv.state_bytes() == 0


# ---------------------------------------------------------------------------
# (v) the engine against the JAX engine
# ---------------------------------------------------------------------------

def _engine_pair(jcfg, cfg, jparams, params, jknobs, knobs_list,
                 lengths=(5, 12, 9, 3)):
    """The JAX engine once (``jknobs``), the port's engine per knob set:
    2 slots for 4 requests, so both slots are reused (and every
    admission round prefills the same shape, one compile for JAX)."""
    rng = np.random.default_rng(len(knobs_list))
    prompts = [rng.integers(1, cfg.vocab_size, size=(L,)).tolist()
               for L in lengths]
    kw = dict(max_slots=2, max_seq_len=32)
    jeng = JEngine(jcfg, jparams, prefix_cache=False, **kw, **jknobs)
    jreqs = [jeng.submit(p, 6) for p in prompts]
    jeng.run()
    want = [r.output for r in jreqs]
    engines = []
    for knobs in knobs_list:
        eng = Engine(cfg, params, device="cpu", **kw, **knobs)
        reqs = [eng.submit(p, 6) for p in prompts]
        eng.run()
        assert all(r.state is RequestState.DONE for r in reqs)
        assert [r.output for r in reqs] == want, knobs
        engines.append(eng)
    return jeng, engines


def test_dense_streams_paged_and_contiguous_match_reference(model):
    """One JAX contiguous engine run is the reference for both of the
    port's caches (the reference holds its paged and contiguous streams
    identical); the port's paged and contiguous streams are identical."""
    jcfg, cfg, jparams, params = model
    jeng, (paged, contig) = _engine_pair(
        jcfg, cfg, jparams, params, {"paged": False},
        [{}, {"paged": False}])
    assert paged.runner.paged and not contig.runner.paged
    assert contig.runner.cache_stats() == jeng.runner.cache_stats()
    assert paged.runner.prefill_shapes == contig.runner.prefill_shapes
    assert paged.runner.kv.free_blocks == paged.runner.kv.num_blocks - 1
    paged.runner.kv.check_invariants()


def test_dense_int8_weights_and_kv_streams_match_reference(model):
    jcfg, cfg, jparams, params = model
    knobs = {"weight_dtype": "int8", "kv_dtype": "int8"}
    jeng, (eng,) = _engine_pair(jcfg, cfg, jparams, params, knobs, [knobs])
    r, jr = eng.runner, jeng.runner
    assert (r.kv_dtype, r.weight_dtype, r.n_quantized) == \
        (jr.kv_dtype, jr.weight_dtype, jr.n_quantized) == ("int8", "int8", 8)
    assert r.chunk_calls == jr.chunk_calls > 0          # int8 KV route
    assert r.kv.pool_bytes() == jr.kv.pool_bytes()


def test_pt_contiguous_streams_match_reference(pt_model):
    jcfg, cfg, jparams, params = pt_model
    jeng, (eng,) = _engine_pair(jcfg, cfg, jparams, params,
                                {"paged": False}, [{"paged": False}])
    assert eng.runner.cache_stats()["mode"] == "contiguous"
    assert eng.runner.kv is None


def test_falcon_mamba_contiguous_streams_match_reference():
    jcfg = j_reduced_config("falcon-mamba-7b")
    cfg = reduced_config("falcon-mamba-7b")
    jparams = jax.jit(lambda k: jdec.init_lm(k, jcfg))(jax.random.PRNGKey(5))
    params = from_jax_params(_np(jparams), cfg, device="cpu")
    _, (eng,) = _engine_pair(jcfg, cfg, jparams, params, {"paged": False},
                             [{"paged": False}], lengths=(5, 9, 5, 9))
    assert eng.runner.exact_prefill


def test_contiguous_fallbacks_report_reference_reasons(model):
    """Chunked prefill and int8 KV need the paged cache: on the
    contiguous cache both fall back as the reference's runner does; int8
    weights still apply."""
    jcfg, cfg, jparams, params = model
    knobs = dict(max_slots=2, max_seq_len=32, paged=False, prefill_chunk=4,
                 kv_dtype="int8", weight_dtype="int8")
    r = Engine(cfg, params, device="cpu", **knobs).runner
    jr = JEngine(jcfg, jparams, prefix_cache=False, **knobs).runner
    assert r.quant_fallbacks == jr.quant_fallbacks == [
        "kv_dtype=int8: needs the paged cache; serving fp KV"]
    assert r.prefill_chunk == jr.prefill_chunk == 0
    assert r.cache_stats() == jr.cache_stats()
    assert r.cache_stats()["mode"] == "contiguous"


def test_serve_cli_dense_contiguous_on_cpu(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--contiguous", "--requests", "3", "--input-len",
                       "8", "--output-len", "4", "--slots", "2"]) == 0
    out = capsys.readouterr().out
    assert "cache: contiguous" in out and "finished 3/3 requests" in out
