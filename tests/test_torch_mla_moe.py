"""deepseek-v2-236b and deepseek-v3-671b (MLA over latent pools,
capacity-routed MoE) in the port's ``lm_*`` decoder against the JAX
package on the CPU: ``moe_apply`` (both routers, ``norm_topk_prob`` on
and off, a capacity that drops pairs, a padded expert store against the
port's unpadded tree), ``mla_apply`` / ``mla_decode`` (contiguous rows
and latent pools, q_lora_rank 0 and > 0), flash's plain version at a
value width below the q/k width against the Pallas kernel (interpret),
whole reduced models (prefill logits and cache, decode steps), configs,
parameter trees and the weight bridge, leaf kinds and capabilities,
the engine's gates (exact prefill, chunked prefill refused, as
``tests/test_serving.py::test_moe_arch_uses_exact_prefill`` and
``::test_chunked_prefill_stays_off_for_moe``), greedy engine streams
against the JAX engine's (three requests, four slots: an idle lane;
paged and contiguous), a fork over latent blocks, and the serve CLI.
One JAX ``init_lm`` tree per model (``reduced_config``: 4 layers, a
dense prefix layer then 3 MoE layers, d 64, 4 heads, kv_lora 16, 8
experts top 2) is loaded into both packages; op-level inputs are drawn
with numpy.

Tolerances: single ops fp32 2e-5, as tests/test_kernels.py; whole-model
logits 1e-4, as tests/test_torch_model.py; greedy streams identical."""
import dataclasses
import functools
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.paged import PagedLeaf as JPagedLeaf
from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.models import decoder as jdec
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import arch_capabilities as j_arch_capabilities
from repro_torch.common.paged import PagedLeaf
from repro_torch.common.types import LayerSpec
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.models import decoder, mla, moe
from repro_torch.serving.cache import PagedKVCache
from repro_torch.serving.engine import Engine, RequestState, arch_capabilities
from repro_torch.weights import from_jax_params

OP_TOL = 2e-5
MODEL_TOL = 1e-4
V2, V3 = "deepseek-v2-236b", "deepseek-v3-671b"
ARCHS = (V2, V3)


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


def _t(a):
    return torch.from_numpy(np.array(a))


def _x(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _cfgs(arch, **moe_kw):
    """(JAX, port) reduced configs of ``arch`` with MoE fields replaced."""
    jcfg, cfg = j_reduced_config(arch), reduced_config(arch)
    if moe_kw:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, **moe_kw))
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe_kw))
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(JAX config, port config, JAX tree, port tree) of ``arch`` reduced."""
    jcfg, cfg = _cfgs(arch)
    jparams = jax.jit(lambda k: jdec.init_lm(k, jcfg))(jax.random.PRNGKey(5))
    return jcfg, cfg, jparams, from_jax_params(_np(jparams), cfg,
                                               device="cpu")


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

_MOE_CASES = {
    "v2 softmax": (V2, {}),
    "v3 sigmoid_bias, norm_topk": (V3, {}),
    "softmax, norm_topk": (V2, {"norm_topk_prob": True}),
    "sigmoid_bias, no norm_topk": (V3, {"norm_topk_prob": False}),
    "softmax, drops": (V2, {"capacity_factor": 0.5}),
    "sigmoid_bias, drops": (V3, {"capacity_factor": 0.5}),
    "padded store": (V2, {"n_experts_padded": 16}),
}


@pytest.mark.parametrize("case", list(_MOE_CASES))
def test_moe_apply_matches_reference(case):
    """``moe_apply`` on x [3, 7, d] (21 rows in one capacity pool)
    against the reference's single-process ``moe_apply`` on the same
    JAX-drawn tree (a nonzero e_bias for sigmoid_bias); the expert ids
    and kept pairs equal the reference's; where the capacity factor is
    0.5 the reference drops pairs and so does the port; a store padded
    to 16 experts gives the port's unpadded tree (the bridge's rule)
    the padded tree's output."""
    arch, kw = _MOE_CASES[case]
    jcfg, cfg = _cfgs(arch, **kw)
    d = cfg.d_model
    jp = jmoe.moe_init(jax.random.PRNGKey(3), jcfg, d)
    rng = np.random.default_rng(len(case))
    if "e_bias" in jp:
        jp["e_bias"] = jnp.asarray(_x(rng, jp["e_bias"].shape[0]) * 0.1)
    x = _x(rng, 3, 7, d)
    want, _ = jax.jit(lambda p, x: jmoe.moe_apply(p, x, cfg=jcfg))(jp, x)
    params = _moe_params(_np(jp), cfg)
    got = moe.moe_apply(params, _t(x), cfg=cfg)
    _close(got, want)
    x2 = jnp.asarray(x.reshape(-1, d))
    _, jidx, _ = jmoe._route(jp, x2, jcfg)
    cap = jmoe.capacity(21, jcfg)
    _, jkeep = jmoe._dispatch_indices(jidx, jmoe.e_store(jcfg), cap)
    assert moe.capacity(21, cfg) == cap
    _, idx, _ = moe._route(params, _t(x2), cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _, keep = moe._dispatch_indices(idx, cfg.moe.n_routed_experts, cap)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    if "capacity_factor" in kw:
        assert not np.asarray(jkeep).all()
    if "n_experts_padded" in kw:
        assert jp["w_gate"].shape[0] == 16
        assert params["w_gate"].shape[0] == cfg.moe.n_routed_experts


def _moe_params(jp, cfg):
    """One MoE MLP tree carried across by ``from_jax_params``'s rules
    (padded experts dropped): checked through a one-layer stand-in."""
    from repro_torch.weights import _EXPERT_AXIS
    n = cfg.moe.n_routed_experts
    out = {}
    for k, a in jp.items():
        ax = _EXPERT_AXIS.get(k)
        if ax is not None:
            a = np.take(a, np.arange(n), axis=ax)
        out[k] = torch.from_numpy(np.array(a))
    want = moe.moe_shapes(cfg, cfg.d_model)
    assert set(out) == set(want)
    for k, leaf in want.items():
        assert tuple(out[k].shape) == leaf.shape, k
    return out


def test_moe_drop_counters_count_the_pairs():
    """``track_drops`` counts every routed (token, expert) pair and the
    dropped ones under the call's phase; ``None`` stops counting."""
    jcfg, cfg = _cfgs(V2, capacity_factor=0.5)
    jp = jmoe.moe_init(jax.random.PRNGKey(3), jcfg, cfg.d_model)
    params = {k: _t(v) for k, v in _np(jp).items()}
    x = _t(_x(np.random.default_rng(0), 3, 7, cfg.d_model))
    moe.track_drops(torch.device("cpu"))
    try:
        moe.moe_apply(params, x, cfg=cfg)
        moe.moe_apply(params, x[:, :1], cfg=cfg, phase="decode")
        got = moe.drop_counts()
    finally:
        moe.track_drops(None)
    _, idx, _ = moe._route(params, x.reshape(21, -1), cfg)
    _, keep = moe._dispatch_indices(idx, 8, moe.capacity(21, cfg))
    assert got["prefill"] == {"routed": 42, "dropped": int((~keep).sum())}
    assert got["prefill"]["dropped"] > 0
    assert got["decode"]["routed"] == 6 and got["chunk"]["routed"] == 0
    assert moe.drop_counts() == {}


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def _mla_layer(arch):
    """Layer 0 (the dense prefix) of the reduced model: (JAX config, port
    config, JAX mixer params, port mixer params, spec)."""
    jcfg, cfg, jparams, params = _model(arch)
    return (jcfg, cfg, jparams["prefix"][0]["mixer"],
            params["prefix"][0]["mixer"], cfg.spec(cfg.pattern_prefix[0]))


@pytest.mark.parametrize("arch", ARCHS, ids=["q_lora 0", "q_lora 24"])
def test_mla_apply_and_decode_match_reference(arch):
    """Prefill of x [2, 9, d] (output and the latent cache) against the
    reference's ``mla_apply``; then one decode step at positions (9, 4)
    against ``mla_decode`` on contiguous rows of 16 (output, both latent
    rows) and on latent pools of block 4 through a shuffled table
    (output, the pools)."""
    jcfg, cfg, jl, tl, spec = _mla_layer(arch)
    assert (cfg.mla.q_lora_rank > 0) == (arch == V3)
    rng = np.random.default_rng(7)
    B, S, cap, bs = 2, 9, 16, 4
    x = _x(rng, B, S, cfg.d_model)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    jout, jcache = jax.jit(lambda p, x, ps: jmla.mla_apply(
        p, x, spec=spec, cfg=jcfg, positions=ps, return_cache=True))(
        jl, x, pos)
    out, cache = mla.mla_apply(tl, _t(x), spec=spec, cfg=cfg,
                               positions=_t(pos), return_cache=True)
    _close(out, jout)
    for a, b in zip(cache, jcache):
        _close(a, b)
    # decode: contiguous rows, a row at its end and one mid-way
    xd = _x(rng, B, 1, cfg.d_model)
    p_d = np.asarray([S, 4], np.int32)
    rows = [np.pad(np.asarray(c), ((0, 0), (0, cap - S), (0, 0)))
            for c in jcache]
    jdec_out, jrows = jax.jit(lambda p, x, c, ps: jmla.mla_decode(
        p, x, c, spec=spec, cfg=jcfg, pos=ps))(jl, xd, tuple(rows), p_d)
    trows = tuple(_t(r) for r in rows)
    dout, _ = mla.mla_decode(tl, _t(xd), trows, spec=spec, cfg=cfg,
                             pos=_t(p_d))
    _close(dout, jdec_out)
    for a, b in zip(trows, jrows):
        _close(a, b)
    # decode: latent pools through a shuffled table (block 0 is trash)
    nblk = cap // bs
    table = (1 + rng.permutation(B * nblk).reshape(B, nblk)).astype(np.int32)
    pools = []
    for r in rows:
        pool = np.zeros((B * nblk + 1, bs, r.shape[-1]), np.float32)
        pool[table.reshape(-1)] = r.reshape(B * nblk, bs, -1)
        pools.append(pool)
    jp_out, jpools = jax.jit(lambda p, x, c, ps, tb: jmla.mla_decode(
        p, x, c, spec=spec, cfg=jcfg, pos=ps, block_table=tb))(
        jl, xd, tuple(JPagedLeaf(jnp.asarray(p)) for p in pools), p_d, table)
    tpools = tuple(PagedLeaf(_t(p)) for p in pools)
    pout, _ = mla.mla_decode(tl, _t(xd), tpools, spec=spec, cfg=cfg,
                             pos=_t(p_d), block_table=_t(table),
                             kv_max_len=10)
    _close(pout, jp_out)
    for a, b in zip(tpools, jpools):
        _close(a.pool, b.pool)
    with pytest.raises(NotImplementedError, match="3.5"):
        mla.mla_chunk()


@pytest.mark.parametrize("causal,softcap", [(True, None), (False, 20.0)])
def test_flash_plain_value_width_matches_pallas_interpret(causal, softcap):
    """flash's plain version at q/k width 24 and value width 16 (MLA's
    narrower V), 4 heads, S 64, against the Pallas kernel in interpret
    mode on the same inputs (heads expanded: the Pallas contract); the
    wrapper on CPU tensors gives the plain version and refuses a value
    width above the q/k width."""
    rng = np.random.default_rng(9)
    q, k = (_x(rng, 2, 64, 4, 24) for _ in range(2))
    v = _x(rng, 2, 64, 4, 16)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal, softcap=softcap, block_q=32, block_k=32,
                   interpret=True)
    got = flash_attention_plain(_t(q), _t(k), _t(v), causal=causal,
                                softcap=softcap)
    assert tuple(got.shape) == (2, 64, 4, 16)
    _close(got, want)
    assert torch.equal(flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                       softcap=softcap), got)
    with pytest.raises(ValueError, match="exceeds"):
        flash_attention(_t(q[..., :16]), _t(v), _t(k))


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_model_prefill_and_decode_match_reference(arch):
    """Prefill logits and latent cache of two rows of 12 tokens against
    the reference's ``lm_forward``; three decode steps of teacher tokens
    into the port's latent pools (the prefill rows inserted) against
    ``lm_decode_step`` on the reference's contiguous cache."""
    jcfg, cfg, jparams, params = _model(arch)
    rng = np.random.default_rng(4)
    B, S, cap = 2, 12, 24
    toks = rng.integers(1, cfg.vocab_size, size=(B, S)).astype(np.int32)
    jl, jcache, _ = jax.jit(lambda p, t: jdec.lm_forward(
        p, {"inputs": t}, jcfg, mode="prefill"))(jparams, toks)
    tl, cache = decoder.lm_forward(params, {"inputs": _t(toks).long()}, cfg)
    _close(tl, jl, MODEL_TOL)
    for a, b in zip(jax.tree_util.tree_leaves(cache),
                    jax.tree_util.tree_leaves(jcache)):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b, MODEL_TOL)
    jc = jax.tree_util.tree_map(
        lambda a: jnp.pad(a, [(0, 0)] * (a.ndim - 2) + [(0, cap - S), (0, 0)]),
        jcache)
    kv = PagedKVCache(cfg, max_slots=B, max_seq_len=cap, block_size=8,
                      device="cpu")
    for s in range(B):
        kv.allocate(s, cap)
    kv.insert_prefill(cache, range(B), kv.table())
    jstep = jax.jit(lambda p, c, t, ps: jdec.lm_decode_step(p, c, t, ps,
                                                            jcfg))
    teacher = rng.integers(1, cfg.vocab_size, size=(3, B)).astype(np.int32)
    for k in range(3):
        p_k = np.full((B,), S + k, np.int32)
        jld, jc = jstep(jparams, jc, teacher[k], p_k)
        tld, _ = decoder.lm_decode_step(params, kv.engine_cache(),
                                        _t(teacher[k]).long(), _t(p_k), cfg,
                                        block_table=kv.table(),
                                        kv_max_len=S + k + 1)
        _close(tld, jld, MODEL_TOL)


def test_bridge_drops_a_padded_expert_store():
    """deepseek-v2 reduced with its 8 experts stored padded to 16 (as the
    full config pads 160 to 256): the reference's tree of the padded
    config, its padded rows and router columns filled with noise, goes
    through the bridge to the unpadded tree, equal to the real experts'
    rows; the padded tree's MoE output is the reference's (the op-level
    "padded store" case)."""
    jcfg, cfg, jparams, params = _model(V2)
    rng = np.random.default_rng(2)

    def pad(node, key):
        ax = {"router": -1, "w_gate": -3, "w_up": -3, "w_down": -3}.get(key)
        if ax is None:
            return node
        extra = list(node.shape)
        extra[ax] = 8
        return np.concatenate([node, _x(rng, *extra)], axis=ax)

    tree = _np(jparams)
    for layer in tree["unit"]:
        layer["mlp"] = {k: pad(v, k) for k, v in layer["mlp"].items()}
    assert tree["unit"][0]["mlp"]["w_gate"].shape[1] == 16
    padded_cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                     n_experts_padded=16))
    got = from_jax_params(tree, padded_cfg, device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(params)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="want"):
        bad = _np(jparams)
        bad["unit"][0]["mlp"]["router"] = bad["unit"][0]["mlp"]["router"][
            :, :4]
        from_jax_params(bad, cfg, device="cpu")


_FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
           "vocab_size", "head_dim", "pattern_prefix", "pattern_unit",
           "pattern_repeat", "pattern_suffix", "norm", "norm_eps",
           "post_norm", "qk_norm", "final_logit_softcap",
           "embedding_multiplier", "tie_embeddings", "rope_theta",
           "local_rope_theta", "mrope_sections", "input_kind", "dtype")


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_param_trees_and_bridge_match_reference(arch):
    """Configs field by field (layer specs, the MoE and MLA sub-configs
    too), the full-size and reduced ``init_lm`` trees by path, shape and
    dtype (nothing allocated at full size; the full v2 tree's experts
    without the reference's padding to 256), the port's own init (expert
    stacks drawn one matrix at a time), and the bridge refusing a tree
    with a leaf missing."""
    for mine, theirs in ((get_config(arch), j_get_config(arch)),
                         (reduced_config(arch), j_reduced_config(arch))):
        assert mine.name == theirs.name
        for f in _FIELDS:
            assert getattr(mine, f) == getattr(theirs, f), f
        assert asdict(mine.moe) == asdict(theirs.moe)
        assert asdict(mine.mla) == asdict(theirs.mla)
        for nm, s in theirs.layer_specs.items():
            assert mine.spec(nm) == LayerSpec(**{
                f: getattr(s, f) for f in LayerSpec.__dataclass_fields__}), nm
        jtree = jax.eval_shape(lambda: jdec.init_lm(jax.random.PRNGKey(0),
                                                    theirs))
        specs = decoder.lm_param_specs(mine)
        jl, sl = (jax.tree_util.tree_leaves_with_path(x)
                  for x in (jtree, specs))
        assert [p for p, _ in jl] == [p for p, _ in sl]
        E, Es = theirs.moe.n_routed_experts, jmoe.e_store(theirs)
        for (path, j), (_, s) in zip(jl, sl):
            key = jax.tree_util.keystr(path)
            shape = tuple(j.shape)
            if Es > E and "'mlp'" in key and any(
                    w in key for w in ("router", "w_gate", "w_up",
                                       "w_down", "e_bias")):
                shape = tuple(E if n == Es else n for n in shape)
            assert shape == tuple(s.shape), key
            want = torch.float32 if j.dtype == jnp.float32 else torch.bfloat16
            assert s.dtype(decoder.model_dtype(mine)) == want, key
    jcfg, cfg, jparams, params = _model(arch)
    mine = decoder.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    for a, b in zip(jax.tree_util.tree_leaves(mine),
                    jax.tree_util.tree_leaves(params)):
        assert a.shape == b.shape and a.dtype == b.dtype
    w = mine["unit"][0]["mlp"]["w_gate"]
    assert 0.5 < float(w.std() * cfg.d_model ** 0.5) < 2.0
    assert not torch.equal(w[0, 0], w[0, 1])
    bad = _np(jparams)
    del bad["unit"][0]["mlp"]["w_up"]
    with pytest.raises(ValueError, match="keys"):
        from_jax_params(bad, cfg, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_kinds_capabilities_and_engine_gates_match_reference(arch):
    """Every MLA layer's latents are pools (no KV-head axis), pool bytes
    as the reference's ``PagedKVCache``; ``arch_capabilities`` equal to
    the reference's, reasons included (paged and fork on; chunked
    prefill, prefix cache, speculation and int8 KV off); the runner
    prefills at exact length and refuses chunked prefill and int8 KV
    with the reference's reasons."""
    jcfg, cfg, jparams, params = _model(arch)
    kv = PagedKVCache(cfg, max_slots=3, max_seq_len=20, block_size=4,
                      device="cpu")
    jeng = JEngine(jcfg, jparams, max_slots=3, max_seq_len=20,
                   block_size=4, prefill_chunk=4, kv_dtype="int8")
    jkv = jeng.runner.kv
    assert kv.leaf_kinds() == jkv.leaf_kinds() == {"paged": 4}
    assert kv.all_pageable and kv.state_bytes() == 0
    assert kv.pool_bytes() == jkv.utilization()["pool_bytes"]
    m = cfg.mla
    # block 4 x fp32 x every layer's (r + rope) latents
    assert kv.bytes_per_block() == (4 * 4 * cfg.n_layers
                                    * (m.kv_lora_rank + m.qk_rope_head_dim))
    theirs = {k: (c.supported, c.reason)
              for k, c in j_arch_capabilities(jcfg).items()}
    assert {k: (c.supported, c.reason)
            for k, c in arch_capabilities(cfg).items()} == theirs
    assert theirs["paged"][0] and theirs["fork"][0]
    assert not any(theirs[k][0] for k in ("chunked_prefill", "prefix_cache",
                                          "speculative", "int8_kv"))
    eng = Engine(cfg, params, device="cpu", max_slots=3, max_seq_len=20,
                 block_size=4, prefill_chunk=4, kv_dtype="int8")
    r = eng.runner
    assert r.exact_prefill and jeng.runner.exact_prefill
    assert r.bucket_for(7) == 7 == jeng.runner.bucket_for(7)
    assert r.prefill_chunk == 0 == jeng.runner.prefill_chunk
    assert r.kv_dtype is None and not r.prefix_cache
    assert r.quant_fallbacks == jeng.runner.quant_fallbacks


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _prompts(cfg):
    v = cfg.vocab_size
    return [[(7 * i + 3 * L) % v for i in range(L)] for L in (5, 9, 12)]


_NEW = (6, 4, 5)


@functools.lru_cache(maxsize=None)
def _jax_streams(arch):
    """The JAX engine's greedy streams of three requests on four slots
    (an idle lane throughout), capacity 32, block 4, paged."""
    jcfg, cfg, jparams, _ = _model(arch)
    eng = JEngine(jcfg, jparams, max_slots=4, max_seq_len=32, block_size=4,
                  prefix_cache=False)
    reqs = [eng.submit(p, n) for p, n in zip(_prompts(cfg), _NEW)]
    eng.run()
    return [r.output for r in reqs]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_engine_streams_match_reference(arch, paged):
    """The port's engine, paged and contiguous, against the JAX engine's
    greedy streams (three requests of 5, 9 and 12 tokens on four slots,
    so one lane idles and lanes finish at different steps while the
    others decode): the port's paged and contiguous streams both equal
    the reference's paged ones, so each other; every request finishes;
    the whole-prompt prefill ran at exact lengths."""
    _, cfg, _, params = _model(arch)
    eng = Engine(cfg, params, device="cpu", max_slots=4, max_seq_len=32,
                 block_size=4, paged=paged)
    assert eng.runner.paged == paged
    reqs = [eng.submit(p, n) for p, n in zip(_prompts(cfg), _NEW)]
    eng.run()
    assert all(r.state is RequestState.DONE for r in reqs)
    got = [r.output for r in reqs]
    assert got == _jax_streams(arch)
    assert [len(o) for o in got] == list(_NEW)
    assert {s[1] for s in eng.runner.prefill_shapes} <= {5, 9, 12}


def test_fork_over_latent_blocks():
    """deepseek-v3 reduced, paged, block 4: a request of 9 prompt tokens
    forked after two steps (11 positions written: two full blocks and a
    partial one) into two greedy children; the children share the
    parent's latent blocks, copy the partial one on their first write,
    and emit the parent's stream; the block accounting stays
    consistent."""
    _, cfg, _, params = _model(V3)
    eng = Engine(cfg, params, device="cpu", max_slots=3, max_seq_len=32,
                 block_size=4)
    assert not eng.runner.prefix_cache
    req = eng.submit(_prompts(cfg)[1], 7)
    for _ in range(2):
        eng.step()
    kids = eng.fork(req, 2)
    eng.run()
    kv = eng.runner.kv
    assert kv.cow_copies >= 2
    kv.check_invariants()
    assert all(k.state is RequestState.DONE for k in kids)
    assert [k.output for k in kids] == [req.output] * 2


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_reduced_on_cpu(arch, capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--requests", "3", "--input-len", "12",
                       "--output-len", "3", "--slots", "2"]) == 0
    out = capsys.readouterr().out
    assert "finished 3/3 requests" in out and "'paged': 4" in out
