"""falcon-mamba through the port's dense ``lm_*`` decoder against the JAX
package on the CPU: the plain ``ssm_scan`` against the Pallas kernel
(interpret mode) and the jnp oracle, the Mamba ops, one bf16 layer, the
whole model in prefill, chunk and decode, the parameter tree and the
weight bridge, the capability table, the cache's state leaves, the
engine's greedy token streams and the serve CLI, all on
``reduced_config("falcon-mamba-7b")`` (4 layers, d 64, d_inner 128,
d_state 4) with one JAX ``init_lm`` tree loaded into both packages.

Tolerances: the scan fp32 1e-4 and bf16 inputs 5e-2, as the reference's
own sweep (tests/test_kernels.py); single ops fp32 2e-5, as
tests/test_kernels.py; whole-model logits 1e-4, as
tests/test_torch_model.py; the bf16 layer 2e-2."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.launch.steps import model_fns as j_model_fns
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import decoder as jdec
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import arch_capabilities as j_arch_capabilities
from repro_torch.configs import reduced_config
from repro_torch.kernels import ops, ref
from repro_torch.launch.steps import model_fns
from repro_torch.models import decoder, layers, ssm
from repro_torch.serving.cache import PagedKVCache
from repro_torch.serving.engine import (Engine, RequestState,
                                        arch_capabilities)
from repro_torch.weights import from_jax_params

OP_TOL = 2e-5
MODEL_TOL = 1e-4
BF16_TOL = 2e-2
ARCH = "falcon-mamba-7b"
REPO = Path(__file__).resolve().parents[1]


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


def _load(dtype="float32"):
    jcfg = j_reduced_config(ARCH).replace(dtype=dtype)
    cfg = reduced_config(ARCH).replace(dtype=dtype)
    jparams = jax.jit(lambda k: jdec.init_lm(k, jcfg))(jax.random.PRNGKey(2))
    return jcfg, cfg, jparams, from_jax_params(_np(jparams), cfg,
                                               device="cpu")


@pytest.fixture(scope="module")
def model():
    return _load()


def _unit_layer(tree, r=0):
    return jax.tree_util.tree_map(lambda l: l[r], tree["unit"][0])


# ---------------------------------------------------------------------------
# (i) the scan: plain version against the Pallas kernel and the oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,di,ds", [(2, 64, 32, 4), (2, 128, 64, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_scan_plain_matches_pallas_and_oracle(B, S, di, ds, dtype):
    rng = np.random.default_rng(0)
    a = 1 / (1 + np.exp(-rng.standard_normal((B, S, di, ds))))
    b = rng.standard_normal((B, S, di, ds))
    h0 = rng.standard_normal((B, di, ds)).astype(np.float32)
    ja, jb = (jnp.asarray(x, jnp.float32).astype(dtype) for x in (a, b))
    ta, tb = (torch.from_numpy(x.astype(np.float32)).to(getattr(torch, dtype))
              for x in (a, b))
    h, hl = ref.ssm_scan_plain(ta, tb, torch.from_numpy(h0))
    assert h.dtype == hl.dtype == torch.float32
    tol = 1e-4 if dtype == "float32" else 5e-2
    jh, jhl = jops.ssm_scan(ja, jb, jnp.asarray(h0), chunk=32,
                            block_d=min(di, 32))
    rh, rhl = jax.jit(jref.ssm_scan_ref)(ja, jb, jnp.asarray(h0))
    for want, want_last in ((jh, jhl), (rh, rhl)):
        _close(h, want, tol)
        _close(hl, want_last, tol)


def test_ssm_scan_plain_takes_any_length_and_leaves_h0_alone():
    h0 = torch.randn(2, 3, 5)
    h, hl = ref.ssm_scan_plain(torch.rand(2, 0, 3, 5), torch.rand(2, 0, 3, 5),
                               h0)
    assert h.shape == (2, 0, 3, 5) and torch.equal(hl, h0)
    assert hl.data_ptr() != h0.data_ptr()
    a, b = torch.rand(2, 7, 3, 5), torch.randn(2, 7, 3, 5)
    h, hl = ref.ssm_scan_plain(a, b, h0)
    want = h0
    for t in range(7):
        want = a[:, t] * want + b[:, t]
    assert torch.equal(hl, want) and torch.equal(h[:, -1], want)
    with pytest.raises(ValueError):
        ref.ssm_scan_plain(a, b[:, :3], h0)


# ---------------------------------------------------------------------------
# (ii) the Mamba ops and one bf16 layer
# ---------------------------------------------------------------------------

def _mixer(model):
    jcfg, cfg, jparams, params = model
    return (_unit_layer(jparams)["mixer"],
            decoder._at(params["unit"][0], 0)["mixer"])


def test_ssm_apply_matches_reference(model):
    jcfg, cfg, _, _ = model
    jp, tp = _mixer(model)
    s = cfg.ssm
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    h0 = rng.standard_normal((2, s.d_inner, s.d_state)).astype(np.float32)
    jout, jc = jax.jit(lambda p, x, h: jssm.ssm_apply(
        p, x, cfg=jcfg, return_cache=True, h0=h))(jp, x, h0)
    out, c = ssm.ssm_apply(tp, torch.from_numpy(x), cfg=cfg,
                           return_cache=True, h0=torch.from_numpy(h0))
    _close(out, jout)
    _close_tree(c, jc, OP_TOL)
    # a prompt shorter than the conv window pads the window on the left
    jout, jc = jax.jit(lambda p, x: jssm.ssm_apply(
        p, x, cfg=jcfg, return_cache=True))(jp, x[:, :2])
    out, c = ssm.ssm_apply(tp, torch.from_numpy(x[:, :2]), cfg=cfg,
                           return_cache=True)
    _close(out, jout)
    _close_tree(c, jc, OP_TOL)


def _state(cfg, B, rng):
    s = cfg.ssm
    return (rng.standard_normal((B, s.d_conv - 1, s.d_inner)
                                ).astype(np.float32),
            rng.standard_normal((B, s.d_inner, s.d_state)).astype(np.float32))


def test_ssm_chunk_with_padded_tail_matches_reference(model):
    jcfg, cfg, _, _ = model
    jp, tp = _mixer(model)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 8, cfg.d_model)).astype(np.float32)
    cache = _state(cfg, 3, rng)
    lens = np.asarray([8, 5, 1], np.int32)
    for cl in (None, lens):
        jout, jc = jax.jit(lambda p, x, c, cl: jssm.ssm_chunk(
            p, x, c, cfg=jcfg, chunk_lens=cl))(jp, x, cache, cl)
        out, c = ssm.ssm_chunk(
            tp, torch.from_numpy(x), tuple(map(torch.from_numpy, cache)),
            cfg=cfg, chunk_lens=None if cl is None else torch.from_numpy(cl))
        _close(out, jout)
        _close_tree(c, jc, OP_TOL)


def test_ssm_decode_with_active_matches_reference(model):
    jcfg, cfg, _, _ = model
    jp, tp = _mixer(model)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    cache = _state(cfg, 3, rng)
    active = np.asarray([True, False, True])
    jout, jc = jax.jit(lambda p, x, c, a: jssm.ssm_decode(
        p, x, c, cfg=jcfg, active=a))(jp, x, cache, active)
    out, c = ssm.ssm_decode(tp, torch.from_numpy(x),
                            tuple(map(torch.from_numpy, cache)), cfg=cfg,
                            active=torch.from_numpy(active))
    _close(out, jout)
    _close_tree(c, jc, OP_TOL)
    # the inactive lane's state is exactly what it was
    assert np.array_equal(c[0][1].numpy(), cache[0][1])
    assert np.array_equal(c[1][1].numpy(), cache[1][1])


def test_bf16_layer_matches_reference_bf16_layer():
    """bf16 activations and projections, fp32 conv / dt / state: the
    reference promotes differently in prefill and decode, and the port
    writes each cast out; a prefill then two decode steps of one layer."""
    jcfg, cfg, jparams, params = _load("bfloat16")
    spec = cfg.spec("m")
    jlp = _unit_layer(jparams)
    tlp = decoder._at(params["unit"][0], 0)
    assert tlp["mixer"]["in_proj"].dtype == torch.bfloat16
    assert tlp["mixer"]["dt_w"].dtype == torch.float32
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.standard_normal((2, 9, cfg.d_model)),
                    jnp.float32).astype(jnp.bfloat16)
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
    jout, jc, _ = jax.jit(lambda p, x: jlayers.layer_apply(
        p, x, cfg=jcfg, spec=jcfg.spec("m"), mode="prefill"))(jlp, x)
    out, c = layers.layer_apply(tlp, tx, cfg=cfg, spec=spec, mode="prefill")
    assert out.dtype == torch.bfloat16 and c[0].dtype == torch.bfloat16
    _close(out, jout.astype(jnp.float32), BF16_TOL)
    _close_tree(c, jax.tree_util.tree_map(
        lambda l: l.astype(jnp.float32), jc), BF16_TOL)
    step = jax.jit(lambda p, x, c: jlayers.layer_apply(
        p, x, cfg=jcfg, spec=jcfg.spec("m"), mode="decode", cache=c))
    for t in range(2):
        xt = x[:, t:t + 1]
        jout, jc, _ = step(jlp, xt, jc)
        out, c = layers.layer_apply(tlp, tx[:, t:t + 1], cfg=cfg, spec=spec,
                                    mode="decode", cache=c)
        _close(out, jout.astype(jnp.float32), BF16_TOL)
    _close_tree(c, jax.tree_util.tree_map(
        lambda l: l.astype(jnp.float32), jc), BF16_TOL)


# ---------------------------------------------------------------------------
# (iii) the whole model: prefill, chained chunks, decode
# ---------------------------------------------------------------------------

def test_lm_forward_chunk_and_decode_steps_match_reference(model):
    jcfg, cfg, jparams, params = model
    rng = np.random.default_rng(5)
    toks = rng.integers(1, cfg.vocab_size, size=(2, 13)).astype(np.int32)
    jlogits, jcache, _ = jax.jit(lambda p, t: jdec.lm_forward(
        p, {"inputs": t}, jcfg, mode="prefill"))(jparams, toks)
    logits, cache = decoder.lm_forward(params,
                                       {"inputs": torch.from_numpy(toks)},
                                       cfg)
    _close(logits, jlogits, MODEL_TOL)
    _close_tree(cache, jcache, MODEL_TOL)

    # chunked route: chunk 8; row 1 holds 11 tokens, so its second chunk
    # is padded past 3
    C, lens = 8, np.asarray([13, 11], np.int32)
    jc = jdec.init_cache(jcfg, 2, 32)
    tc = decoder.init_cache(cfg, 2, 32, device="cpu")
    jstep = jax.jit(lambda p, c, t, pos, cl: jdec.lm_chunk_step(
        p, c, t, pos, jcfg, chunk_lens=cl))
    for start in (0, C):
        chunk = np.zeros((2, C), np.int32)
        chunk[:, :min(C, 13 - start)] = toks[:, start:start + C]
        cl = np.clip(lens - start, 0, C).astype(np.int32)
        pos = np.full((2,), start, np.int32)
        jl, jc = jstep(jparams, jc, chunk, pos, cl)
        tl, tc = decoder.lm_chunk_step(params, tc, torch.from_numpy(chunk),
                                       torch.from_numpy(pos), cfg,
                                       chunk_lens=torch.from_numpy(cl))
        _close(tl, jl, MODEL_TOL)
    _close_tree(tc, jc, MODEL_TOL)
    # consecutive chunks compose to the whole-prompt recurrence (row 0)
    for a, b in zip(jax.tree_util.tree_leaves(tc),
                    jax.tree_util.tree_leaves(cache)):
        _close(a[:, :1], np.asarray(b)[:, :1], MODEL_TOL)

    # teacher-forced decode with one lane frozen at the second step
    jdecode = jax.jit(lambda p, c, t, pos, a: jdec.lm_decode_step(
        p, c, t, pos, jcfg, active=a))
    teacher = rng.integers(1, cfg.vocab_size, size=(3, 2)).astype(np.int32)
    for t in range(3):
        act = np.asarray([True, t != 1])
        pos = (lens + t).astype(np.int32)
        jl, jc = jdecode(jparams, jc, teacher[t], pos, act)
        tl, tc = decoder.lm_decode_step(
            params, tc, torch.from_numpy(teacher[t]), torch.from_numpy(pos),
            cfg, active=torch.from_numpy(act))
        _close(tl, jl, MODEL_TOL)
    _close_tree(tc, jc, MODEL_TOL)


# ---------------------------------------------------------------------------
# (iv) parameters, capabilities, cache layout
# ---------------------------------------------------------------------------

def test_init_lm_tree_matches_reference_and_bridge_checks(model):
    jcfg, cfg, jparams, params = model
    mine = decoder.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")

    def sig(tree):
        return sorted((jax.tree_util.keystr(p), tuple(l.shape),
                       str(l.dtype).replace("torch.", ""))
                      for p, l in jax.tree_util.tree_flatten_with_path(
                          tree)[0])

    want = sig(jparams)
    assert len(want) == 13          # embed, head, final norm, ln1, 9 mixer
    assert sig(mine) == sig(params) == want
    m = mine["unit"][0]["mixer"]
    torch.testing.assert_close(m["A_log"], torch.from_numpy(
        np.asarray(jparams["unit"][0]["mixer"]["A_log"])))
    for k in ("D", "dt_bias", "conv_b"):
        assert torch.equal(m[k], torch.from_numpy(
            np.asarray(jparams["unit"][0]["mixer"][k])))
    assert torch.all(mine["final_norm"]["scale"] == 0)
    # bridged values are the reference's, bit for bit
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(jparams)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    bad = _np(jparams)
    bad["unit"][0]["mixer"]["dt_w"] = bad["unit"][0]["mixer"]["dt_w"].astype(
        np.float16)
    with pytest.raises(ValueError, match="dt_w"):
        from_jax_params(bad, cfg, device="cpu")
    with pytest.raises(ValueError, match="unit"):
        from_jax_params(dict(_np(jparams), unit=()), cfg, device="cpu")


@pytest.mark.parametrize("arch", [ARCH, "pt-6b-d4"])
def test_arch_capabilities_and_model_fns_match_reference(arch):
    mine = arch_capabilities(reduced_config(arch))
    theirs = j_arch_capabilities(j_reduced_config(arch))
    assert {k: (v.supported, v.reason) for k, v in mine.items()} == \
        {k: (v.supported, v.reason) for k, v in theirs.items()}
    fns, jfns = model_fns(reduced_config(arch)), j_model_fns(
        j_reduced_config(arch))
    # the reference's PT init_cache is a lambda
    keys = ("init", "forward", "decode", "chunk") + (
        ("init_cache",) if arch == ARCH else ())
    assert [fns[k].__name__ for k in keys] == \
        [jfns[k].__name__ for k in keys]


def test_cache_state_leaves_meter_virtual_blocks(model):
    _, cfg, _, _ = model
    kv = PagedKVCache(cfg, max_slots=2, max_seq_len=32, block_size=8,
                      device="cpu")
    assert kv.leaf_kinds() == {"state": 2}
    assert not kv.any_pageable and not kv.all_pageable
    assert kv.pool_bytes() == 0 and kv.bytes_per_block() == 0
    s = cfg.ssm
    assert kv.state_bytes() == cfg.n_layers * 2 * (
        (s.d_conv - 1) * s.d_inner * 4 + s.d_inner * s.d_state * 4)
    kv.allocate(0, 20)
    assert kv.free_blocks == kv.num_blocks - 1 - 3
    assert not kv.can_allocate(32 * 2)
    conv, h = kv.engine_cache()["unit"][0]
    conv.fill_(1.0)
    h.fill_(2.0)
    kv.reset_slots([1])
    assert torch.all(conv[:, 1] == 0) and torch.all(h[:, 1] == 0)
    assert torch.all(conv[:, 0] == 1) and torch.all(h[:, 0] == 2)
    kv.free_slot(0)
    assert kv.free_blocks == kv.num_blocks - 1
    kv.check_invariants()
    with pytest.raises(ValueError, match="int8"):
        PagedKVCache(cfg, max_slots=2, max_seq_len=32, kv_dtype="int8",
                     device="cpu")


# ---------------------------------------------------------------------------
# (v) the engine against the JAX engine
# ---------------------------------------------------------------------------

def _prompts(cfg, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, size=(L,)).tolist()
            for L in lengths]


# arm -> (engine knobs, prompt lengths, slots, reference overrides)
_ARMS = {
    # exact-length prefill: one prefill group per distinct length
    "exact": ({}, (5, 9, 5, 3), 4, {}),
    # L < C, L = kC, L % C != 0; the reference's Pallas scan route
    "chunk4_pallas": ({"prefill_chunk": 4}, (3, 8, 10), 3,
                      {"use_pallas": True}),
    # more requests than slots: a reused slot's state rows must be reset
    "chunk4_reuse": ({"prefill_chunk": 4}, (10, 6, 9, 7, 5), 2, {}),
    # int8 head only; int8 KV falls back (state rows are not blocks)
    "w8_kv8": ({"weight_dtype": "int8", "kv_dtype": "int8"}, (6, 4, 6), 2,
               {}),
}


@pytest.mark.parametrize("arm", list(_ARMS))
def test_engine_greedy_streams_match_reference(model, arm):
    jcfg, cfg, jparams, params = model
    knobs, lengths, slots, jover = _ARMS[arm]
    prompts = _prompts(cfg, lengths, seed=len(lengths))
    kw = dict(max_slots=slots, max_seq_len=32, **knobs)
    eng = Engine(cfg, params, device="cpu", **kw)
    reqs = [eng.submit(p, 5) for p in prompts]
    eng.run()
    jeng = JEngine(jcfg.replace(**jover), jparams, prefix_cache=False, **kw)
    jreqs = [jeng.submit(p, 5) for p in prompts]
    jeng.run()
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    assert all(r.state is RequestState.DONE for r in reqs)
    r, jr = eng.runner, jeng.runner
    assert r.exact_prefill and jr.exact_prefill
    assert r.quant_fallbacks == jr.quant_fallbacks
    assert (r.kv_dtype, r.weight_dtype, r.n_quantized) == \
        (jr.kv_dtype, jr.weight_dtype, jr.n_quantized)
    assert r.kv.leaf_kinds() == jr.kv.leaf_kinds() == {"state": 2}
    st, jst = r.cache_stats(), jr.cache_stats()
    for key in ("kv_dtype", "weight_dtype", "quantized_weight_leaves",
                "pool_bytes", "bytes_per_block", "num_blocks", "leaf_kinds"):
        assert st[key] == jst[key], key
    chunked = "prefill_chunk" in knobs
    assert (r.chunk_calls, r.prefill_calls) == \
        (jr.chunk_calls, jr.prefill_calls)
    assert (r.chunk_calls > 0) == chunked
    if not chunked:
        # one group per distinct length, never a padded bucket
        assert {b for _, b in r.prefill_shapes} == set(lengths)
    if arm == "w8_kv8":
        assert r.n_quantized == 1 and r.weight_dtype == "int8"
        assert r.quant_fallbacks == [
            "kv_dtype=int8: recurrent state is a per-slot row, not a "
            "content-addressable block; serving fp KV"]
    assert r.kv.free_blocks == r.kv.num_blocks - 1
    r.kv.check_invariants()


def test_chunked_admission_resets_reused_slot_state(model):
    """The row a finished request leaves behind is zeroed when a chunked
    admission takes its slot: the new request's stream equals a fresh
    engine's."""
    _, cfg, _, params = model
    first, second = _prompts(cfg, (9, 7), seed=9)
    eng = Engine(cfg, params, device="cpu", max_slots=1, max_seq_len=32,
                 prefill_chunk=4)
    eng.generate([first], 4)
    assert torch.any(eng.runner.kv.engine_cache()["unit"][0][1] != 0)
    out = eng.generate([second], 4)
    fresh = Engine(cfg, params, device="cpu", max_slots=1, max_seq_len=32,
                   prefill_chunk=4).generate([second], 4)
    assert out == fresh


# ---------------------------------------------------------------------------
# (vi) the serve CLI
# ---------------------------------------------------------------------------

def test_serve_cli_falcon_mamba_chunked_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--requests", "3", "--input-len",
         "12", "--output-len", "4", "--slots", "2", "--prefill-chunk", "8"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "finished 3/3 requests" in out.stdout
    assert "leaves {'state': 2}, pool 0.0 MB" in out.stdout
    assert "chunk calls 4" in out.stdout


# ---------------------------------------------------------------------------
# (vii) the scan's selective route: its plain version, the counters
# ---------------------------------------------------------------------------

def _selective_np(B, S, di, ds, seed):
    """numpy inputs of the selective route: dt > 0 (a softplus), x, A =
    -(1 .. ds), x_dbl holding B_t and C_t, h0."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, di)) / 2 + 0.5413))
    return [a.astype(np.float32) for a in (
        dt, rng.standard_normal((B, S, di)),
        -np.broadcast_to(np.arange(1, ds + 1), (di, ds)),
        rng.standard_normal((B, S, 3 + 2 * ds)) / 2,
        rng.standard_normal((B, di, ds)))]


_LENS = [None, [9, 4, 0]]


@pytest.mark.parametrize("lens", _LENS)
def test_selective_scan_plain_is_bitwise_the_unfused_composition(lens):
    """``selective_scan_plain`` (and the CPU wrapper) is the composition
    ``ssm_apply`` / ``ssm_chunk`` ran before the route existed, step for
    step: a = exp(dt A) in place, b = (dt x) B_t, the chunk mask, the
    plain scan, the einsum; bitwise, with and without ``lens``."""
    dt, x, A, x_dbl, h0 = map(torch.from_numpy, _selective_np(3, 9, 6, 4, 7))
    Bt, Ct = x_dbl[..., 3:7], x_dbl[..., 7:]
    ln = None if lens is None else torch.tensor(lens)
    a = (dt[..., None] * A[None, None]).exp_()
    b = (dt * x)[..., None] * Bt.float()[:, :, None, :]
    if ln is not None:
        pad = (torch.arange(9)[None] >= ln[:, None])[..., None, None]
        a.masked_fill_(pad, 1.0)
        b.masked_fill_(pad, 0.0)
    h, want_last = ref.ssm_scan_plain(a, b, h0)
    want = torch.einsum("bsiz,bsz->bsi", h, Ct.float())
    for fn in (ref.selective_scan_plain, ops.selective_scan):
        y, hl = fn(dt, x, A, Bt, Ct, h0, ln)
        assert torch.equal(y, want) and torch.equal(hl, want_last)
    if ln is not None:                  # a row of 0 keeps h0 exactly
        assert torch.equal(want_last[2], h0[2])


@pytest.mark.parametrize("lens", _LENS)
def test_selective_scan_plain_matches_reference_chunk_pieces(lens):
    """y and h_last of the plain selective route against the reference
    ``ssm_chunk``'s lines from x_dbl to its einsum (jnp discretisation,
    ``jnp.where`` mask, its chunked associative scan) on shared numpy
    inputs, at the single-op tolerance (2e-5)."""
    S, ds = 16, 4
    dt, x, A, x_dbl, h0 = _selective_np(2, S, 8, ds, 8)
    ln = None if lens is None else np.asarray([S, 5], np.int32)
    Bt, Ct = x_dbl[..., 3:3 + ds], x_dbl[..., 3 + ds:]

    def pieces(dt, x, A, Bt, Ct, h0, ln):
        a = jnp.exp(dt[..., None] * A[None, None])
        b = (dt * x)[..., None] * Bt[:, :, None, :]
        if ln is not None:
            valid = jnp.arange(S, dtype=jnp.int32)[None] < ln[:, None]
            a = jnp.where(valid[..., None, None], a, 1.0)
            b = jnp.where(valid[..., None, None], b, 0.0)
        h, h_last = jssm._chunked_linear_scan(a, b, h0, 8)
        return jnp.einsum("bsiz,bsz->bsi", h, Ct), h_last

    jy, jhl = jax.jit(pieces)(dt, x, A, Bt, Ct, h0, ln)
    t = torch.from_numpy
    y, hl = ref.selective_scan_plain(t(dt), t(x), t(A), t(Bt), t(Ct), t(h0),
                                     None if ln is None else t(ln))
    _close(y, jy)
    _close(hl, jhl)


def test_scan_routes_are_counters_and_the_cpu_counts_nothing():
    """``ssm_scan.routes`` (``scan``, ``selective``) are counters beside
    ``ssm_scan.launches``: listed by ``counters()``, set and zeroed with
    the others; the CPU's plain versions count no launch or route; the
    selective wrapper refuses shapes that do not fit."""
    from repro_torch.kernels import ssm_scan as sk
    assert sk.ROUTES == ("scan", "selective")
    assert set(sk.ssm_scan.routes) == set(sk.ROUTES)
    keys = set(ops.counters())
    assert {"ssm_scan", "ssm_scan/scan", "ssm_scan/selective"} <= keys
    before = ops.counters()
    dt, x, A, x_dbl, h0 = map(torch.from_numpy, _selective_np(2, 5, 4, 2, 9))
    ops.selective_scan(dt, x, A, x_dbl[..., 3:5], x_dbl[..., 5:], h0)
    ops.ssm_scan(torch.rand(2, 5, 4, 2), torch.rand(2, 5, 4, 2), h0)
    assert ops.counters() == before
    try:
        ops.set_counters({"ssm_scan/selective": 4, "ssm_scan/scan": 0,
                          "ssm_scan": 4})
        ops.add_counters({"ssm_scan/scan": 2, "ssm_scan": 2})
        assert (sk.ssm_scan.launches, sk.ssm_scan.routes) == (
            6, {"scan": 2, "selective": 4})
        ops.reset_launch_counts()
        assert not any(sk.ssm_scan.routes.values())
        assert sk.ssm_scan.launches == 0
    finally:
        ops.set_counters(before)
    with pytest.raises(ValueError):
        ops.selective_scan(dt, x, A[:3], x_dbl[..., 3:5], x_dbl[..., 5:], h0)
    with pytest.raises(ValueError):
        ops.selective_scan(dt, x, A, x_dbl[..., 3:6], x_dbl[..., 5:], h0)
    with pytest.raises(ValueError):
        ops.selective_scan(dt, x, A, x_dbl[..., 3:5], x_dbl[..., 5:], h0,
                           torch.tensor([1, 2, 3]))
