"""The port's quantized and chunked serving path against the JAX package on
the CPU: int8 primitives and weight-tree quantization, the plain
versions of the W8A16 matmul and of int8 paged decode against the Pallas
kernels (interpret mode) and jnp oracles, the chunk program, int8 pool
accounting, and the engine's greedy token streams, all on
``reduced_pt(4)`` = ``reduced_config("pt-6b-d4")`` in fp32 with one JAX
``init_pt`` tree loaded into both packages.

Tolerances: quantized payloads exact and scales within 1 ulp (the same
amax / 127 and round-half-to-even in both); single ops fp32 2e-5, as
tests/test_kernels.py; whole-model logits 1e-4, as
tests/test_torch_model.py; the one bf16 layer against the reference's
fp32 layer 2e-2 (bf16 activations; the reference cannot run that layer
in bf16, see ``test_bf16_int8_layer_tracks_reference_fp32_layer``)."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import quant as jquant
from repro.common.paged import PagedLeaf as JPagedLeaf
from repro.configs import reduced_config as j_reduced_config
from repro.core import track as jtrack
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.serving.engine import Engine as JEngine
from repro_torch.common import quant
from repro_torch.common.paged import PagedLeaf
from repro_torch.configs import reduced_config
from repro_torch.core import track
from repro_torch.kernels import ops, ref
from repro_torch.models import attention, layers
from repro_torch.serving.cache import PagedKVCache
from repro_torch.serving.engine import Engine, RequestState
from repro_torch.weights import from_jax_params

OP_TOL = 2e-5
MODEL_TOL = 1e-4
BF16_TOL = 2e-2
ARCH = "pt-6b-d4"
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs on several pytest-xdist workers at once: one
    intra-op thread keeps torch's idle pool threads off the cores the
    other workers use (the shapes here are too small to gain from more)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(t, j, tol=OP_TOL):
    np.testing.assert_allclose(np.asarray(t.detach().float()),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


def _np(tree):
    """JAX tree -> numpy leaves, QuantTensors as (payload, scale)."""
    return jax.tree_util.tree_map(
        lambda l: ((np.asarray(l.payload), np.asarray(l.scale))
                   if isinstance(l, jquant.QuantTensor) else np.asarray(l)),
        tree, is_leaf=lambda l: isinstance(l, jquant.QuantTensor))


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = j_reduced_config(ARCH), reduced_config(ARCH)
    jparams = jax.jit(lambda k: jtrack.init_pt(k, jcfg))(
        jax.random.PRNGKey(0))
    params = from_jax_params(_np(jparams), cfg, device="cpu")
    jq, _ = jquant.quantize_params(jparams)
    return jcfg, cfg, jparams, params, jq


def _layer(tree, r, j):
    return jax.tree_util.tree_map(lambda l: l[r, j], tree)


# ---------------------------------------------------------------------------
# (i) primitives and weight-tree quantization
# ---------------------------------------------------------------------------

def _same_quant(qt, jqt):
    np.testing.assert_array_equal(qt.payload.numpy(), np.asarray(jqt.payload))
    np.testing.assert_array_max_ulp(qt.scale.numpy(), np.asarray(jqt.scale),
                                    maxulp=1)


@pytest.mark.parametrize("shape,axes", [((6, 40), -1), ((3, 4, 16, 32),
                                                         (-3, -2)),
                                        ((2, 24, 5, 8), (-3,))])
def test_quantize_and_rows_match_reference(shape, axes):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32) * 3
    x[0] = 0.0                                  # the zero-row guard
    # exact .5 multiples of a step: round half to even in both
    x[1, ..., :4] = np.float32(2.5) * np.abs(x[1]).max() / 127
    _same_quant(quant.quantize(torch.from_numpy(x), axes),
                jquant.quantize(jnp.asarray(x), axes))
    p, s = quant.quantize_rows(torch.from_numpy(x))
    jp, js = jquant.quantize_rows(jnp.asarray(x))
    _same_quant(quant.QuantTensor(p, s), jquant.QuantTensor(jp, js))
    _close(quant.dequantize_rows(p, s), jquant.dequantize_rows(jp, js))
    assert torch.all(quant.dequantize(quant.quantize(
        torch.zeros(3, 4))) == 0)


def test_quantize_params_matches_reference(model):
    """Same leaves selected, payloads equal, scales within 1 ulp; the
    weight bridge carries the reference's quantized tree across as the
    same QuantTensors; slicing a stacked QuantTensor moves both parts."""
    _, cfg, jparams, params, jq = model
    mine, n = quant.quantize_params(params)
    _, jn = jquant.quantize_params(jparams)
    assert n == jn == 8
    bridged = from_jax_params(_np(jq), cfg, device="cpu")
    flat = jax.tree_util.tree_leaves_with_path(
        jq, is_leaf=lambda l: isinstance(l, jquant.QuantTensor))
    for path, jleaf in flat:
        node, other = mine, bridged
        for k in path:
            node, other = node[k.key], other[k.key]
        assert quant.is_quantized(node) == isinstance(jleaf,
                                                      jquant.QuantTensor)
        if quant.is_quantized(node):
            _same_quant(node, jleaf)
            assert torch.equal(other.payload, node.payload)
            assert torch.equal(other.scale,
                               torch.from_numpy(np.array(jleaf.scale)))
        else:
            assert torch.equal(node, other)
    wq = mine["blocks"]["mixer"]["wq"]
    assert tuple(wq.scale.shape) == tuple(wq.shape[:3]) + (1,) + \
        tuple(wq.shape[4:])
    part = wq[1, 2]
    assert torch.equal(part.payload, wq.payload[1, 2])
    assert torch.equal(part.scale, wq.scale[1, 2])
    tree = _np(jq)
    tree["blocks"]["mlp"]["wo"] = (tree["blocks"]["mlp"]["wo"][0],
                                   tree["blocks"]["mlp"]["wo"][1][..., :1])
    with pytest.raises(ValueError, match="wo"):
        from_jax_params(tree, cfg, device="cpu")


# ---------------------------------------------------------------------------
# (ii) the W8A16 matmul's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,M,K,N", [(2, 8, 48, 40), (1, 5, 32, 100),
                                     (3, 33, 24, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_matmul_plain_matches_pallas_and_oracle(n, M, K, N, dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((n, M, K)).astype(np.float32)
    w = rng.standard_normal((n, K, N)).astype(np.float32)
    jq = jquant.quantize(jnp.asarray(w), axes=-2)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    xj = jnp.asarray(x).astype(jdt)
    xt = torch.from_numpy(x).to(tdt)
    wt = torch.from_numpy(np.array(jq.payload))
    st = torch.from_numpy(np.array(jq.scale))
    out = ref.int8_matmul_plain(xt, wt, st)
    assert out.dtype == torch.float32 and tuple(out.shape) == (n, M, N)
    tol = OP_TOL if dtype == "float32" else BF16_TOL
    for i in range(n):
        kern = jops.int8_matmul(xj[i], jq.payload[i], jq.scale[i])
        _close(out[i], kern, tol)
        oracle = xj[i].astype(jnp.float32) @ jquant.dequantize(jq)[i]
        _close(out[i], oracle, tol)
    # the wrapper runs the plain version on the CPU and counts nothing
    before = ops.launch_counts()
    assert torch.equal(ops.int8_matmul(xt, wt, st), out)
    assert ops.launch_counts() == before
    with pytest.raises(ValueError):
        ops.int8_matmul(xt, wt.float(), st)
    with pytest.raises(ValueError):
        ops.int8_matmul(xt, wt, st[:, :, :-1])


# ---------------------------------------------------------------------------
# (iii) int8 paged decode's plain version
# ---------------------------------------------------------------------------

def _int8_pools(n, B, KH, G, hd, bs, nmax, seed=7):
    rng = np.random.default_rng(seed)
    N = B * nmax + 3
    q = rng.standard_normal((n, B, KH * G, hd)).astype(np.float32)
    pools = [jquant.quantize_rows(jnp.asarray(
        rng.standard_normal((n, N, bs, KH, hd)).astype(np.float32) * 2))
        for _ in range(2)]
    table = (rng.permutation(N - 1)[:B * nmax].reshape(B, nmax) + 1
             ).astype(np.int32)
    lengths = np.asarray([1 + (13 * i + 6) % (nmax * bs) for i in range(B)],
                         np.int32)
    return q, pools, table, lengths


@pytest.mark.parametrize("n,B,KH,G,hd,bs,nmax", [(3, 3, 1, 4, 32, 8, 5),
                                                 (2, 4, 2, 2, 16, 4, 6)])
def test_int8_paged_decode_plain_matches_pallas(n, B, KH, G, hd, bs, nmax):
    """Ragged lengths, a shuffled shared pool, and a ``max_len`` cut:
    at the longest row it changes nothing, below it it drops the columns
    past ceil(max_len / bs) blocks, as the Pallas grid does."""
    q, ((kp, ks), (vp, vs)), table, lengths = _int8_pools(n, B, KH, G, hd,
                                                          bs, nmax)
    tq = torch.from_numpy(q)
    tk, tv = (torch.from_numpy(np.array(a)) for a in (kp, vp))
    tks, tvs = (torch.from_numpy(np.array(a)) for a in (ks, vs))
    tt, lt = torch.from_numpy(table), torch.from_numpy(lengths)
    tj, lj = jnp.asarray(table), jnp.asarray(lengths)
    before = ops.launch_counts()
    for ml in (None, int(lengths.max()), bs + 1):
        mine = ref.paged_decode_attention_plain(
            tq, tk, tv, tt, lt, max_len=ml, k_scale=tks, v_scale=tvs)
        want = jax.vmap(lambda q, k, v, a, b: jops.paged_decode_attention(
            q, k, v, tj, lj, max_len=ml, k_scale=a, v_scale=b))(
            jnp.asarray(q), kp, vp, ks, vs)
        _close(mine, want)
        assert torch.equal(ops.paged_decode_attention(
            tq, tk, tv, tt, lt, max_len=ml, k_scale=tks, v_scale=tvs), mine)
    assert ops.launch_counts() == before
    with pytest.raises(ValueError, match="scale"):
        ops.paged_decode_attention(tq, tk, tv, tt, lt, k_scale=tks)
    with pytest.raises(ValueError, match="int8"):
        ops.paged_decode_attention_int8(tq, tk.float(), tv.float(), tks, tvs,
                                        tt, lt)


# ---------------------------------------------------------------------------
# (iv) the chunk program
# ---------------------------------------------------------------------------

def _pools(shape, rng, int8):
    kv = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    if not int8:
        return [(a, None) for a in kv]
    return [tuple(np.asarray(t) for t in jquant.quantize_rows(jnp.asarray(a)))
            for a in kv]


def _leaves(pools, cls, conv):
    return tuple(cls(conv(p), None if s is None else conv(s))
                 for p, s in pools)


@pytest.mark.parametrize("int8", [False, True])
def test_attention_chunk_matches_reference(model, int8):
    """A 5-token chunk at ragged positions against shared pools, int8
    weights with int8 pools: written pools and outputs match the
    reference's paged attention_chunk."""
    jcfg, cfg, _, params, jq = model
    spec, jspec = cfg.spec("full"), jcfg.spec("full")
    rng = np.random.default_rng(3)
    n, B, C, N, bs = cfg.pt.n_tracks, 3, 5, 12, 4
    shape = (n, N, bs, cfg.n_kv_heads, cfg.head_dim)
    pools = _pools(shape, rng, int8)
    table = np.asarray([[4, 7, 2, 0], [9, 1, 3, 5], [0, 0, 0, 0]], np.int32)
    pos = np.asarray([6, 2, 0], np.int32)
    x = rng.standard_normal((n, B, C, cfg.d_model)).astype(np.float32)
    src = jq if int8 else model[2]
    lj = _layer(src["blocks"], 1, 2)["mixer"]
    mine = _leaves(pools, PagedLeaf, lambda a: torch.from_numpy(a.copy()))
    pt = from_jax_params(_np(src), cfg, device="cpu")
    out, _ = attention.attention_chunk(
        _layer(pt["blocks"], 1, 2)["mixer"], torch.from_numpy(x), mine,
        spec=spec, cfg=cfg, pos=torch.from_numpy(pos),
        block_table=torch.from_numpy(table))

    def one(p, h, k, ks, v, vs):
        return jattn.attention_chunk(
            p, h, (JPagedLeaf(k, ks), JPagedLeaf(v, vs)), spec=jspec,
            cfg=jcfg, pos=jnp.asarray(pos), block_table=jnp.asarray(table))

    (kp, ks), (vp, vs) = pools
    jout, (jk, jv) = jax.jit(jax.vmap(one))(lj, jnp.asarray(x), kp, ks, vp,
                                            vs)
    _close(out, jout, MODEL_TOL)
    live = list(range(1, N))                 # trash block 0 is scratch
    for leaf, jleaf in zip(mine, (jk, jv)):
        got = leaf.pool[:, live].float()
        want = np.asarray(jleaf.pool)[:, live].astype(np.float32)
        if int8:
            got = got * leaf.scale[:, live]
            want = want * np.asarray(jleaf.scale)[:, live]
        _close(got, want, MODEL_TOL)


@pytest.mark.parametrize("int8", [False, True])
def test_pt_chunk_step_matches_reference(model, int8):
    """Whole model, two chunks back to back into the same pools (the
    second attends to the first): logits of every row."""
    jcfg, cfg, jparams, params, jq = model
    rng = np.random.default_rng(5)
    B, C, bs, N = 2, 6, 4, 10
    shape = track.pt_cache_shape(cfg, N, bs)
    pools = _pools(shape, rng, int8)
    table = np.asarray([[3, 7, 1, 8], [2, 5, 9, 4]], np.int32)
    pt = from_jax_params(_np(jq), cfg, device="cpu") if int8 else params
    tc = {"blocks": _leaves(pools, PagedLeaf,
                            lambda a: torch.from_numpy(a.copy())), "tail": ()}
    jc = {"blocks": _leaves(pools, JPagedLeaf, jnp.asarray), "tail": ()}
    jstep = jax.jit(lambda p, c, t, pos: jtrack.pt_chunk_step(
        p, c, t, pos, jcfg, block_table=jnp.asarray(table)))
    pos = np.asarray([0, 3], np.int32)
    for _ in range(2):
        toks = rng.integers(1, cfg.vocab_size, size=(B, C)).astype(np.int32)
        lg, tc = track.pt_chunk_step(pt, tc, torch.from_numpy(toks),
                                     torch.from_numpy(pos), cfg,
                                     block_table=torch.from_numpy(table))
        jlg, jc = jstep(jq if int8 else jparams, jc, jnp.asarray(toks),
                        jnp.asarray(pos))
        _close(lg, jlg, MODEL_TOL)
        pos = pos + C
    # the head on the hidden rows is the logits of those rows
    h = track.pt_chunk_hidden(pt, tc, torch.from_numpy(toks),
                              torch.from_numpy(pos - C), cfg,
                              block_table=torch.from_numpy(table))
    from repro_torch.models.decoder import _head
    _close(_head(pt, h[:, -1], cfg), lg[:, -1], MODEL_TOL)


# ---------------------------------------------------------------------------
# (v) bf16 activations with int8 weights
# ---------------------------------------------------------------------------

def test_bf16_int8_layer_tracks_reference_fp32_layer(model):
    """The reference cannot serve a bf16 model with int8 weights: its
    ``dq`` returns fp32, the attention einsums promote to fp32 and the
    scan carry changes type (ROADMAP §3).  The port keeps every int8
    projection in the activation dtype, so one bf16 layer on the same
    quantized weights is held against the reference's fp32 layer, at
    the bf16 tolerance."""
    jcfg, cfg, _, _, jq = model
    bcfg = cfg.replace(dtype="bfloat16")
    spec, jspec = bcfg.spec("full"), jcfg.spec("full")
    lj = _layer(jq["blocks"], 0, 1)
    pt = _layer(from_jax_params(_np(jq), cfg, device="cpu")["blocks"], 0, 1)
    rng = np.random.default_rng(6)
    n, B, S = cfg.pt.n_tracks, 2, 8
    # the same input in both: bf16 values, held in fp32 by the reference
    xb = torch.from_numpy(rng.standard_normal(
        (n, B, S, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    x = xb.float().numpy()
    positions = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    out, (k, _) = layers.layer_apply(
        pt, xb, cfg=bcfg, spec=spec,
        mode="prefill", positions=torch.from_numpy(positions))
    assert out.dtype == torch.bfloat16 and k.dtype == torch.bfloat16
    jout, (jk, _), _ = jax.jit(jax.vmap(lambda p, h: jlayers.layer_apply(
        p, h, cfg=jcfg, spec=jspec, mode="prefill",
        positions=jnp.asarray(positions))))(lj, jnp.asarray(x))
    _close(out, jout, BF16_TOL)
    _close(k, jk, BF16_TOL)


# ---------------------------------------------------------------------------
# (vi) int8 pool bytes
# ---------------------------------------------------------------------------

def test_int8_pool_bytes_shrink_by_payload_plus_scale():
    cfg = reduced_config(ARCH)
    kw = dict(max_slots=3, max_seq_len=40, block_size=8, device="cpu")
    fp, q = PagedKVCache(cfg, **kw), PagedKVCache(cfg, kv_dtype="int8", **kw)
    hd = cfg.head_dim
    assert q.num_blocks == fp.num_blocks
    assert q.data[0].dtype == torch.int8
    assert tuple(q.scales[0].shape) == tuple(q.data[0].shape[:-1]) + (1,)
    assert q.pool_bytes() * 4 * hd == fp.pool_bytes() * (hd + 4)
    u = q.utilization()
    assert u["kv_dtype"] == "int8" and fp.utilization()["kv_dtype"] == \
        "float32"
    assert u["bytes_per_block"] * q.num_blocks == q.pool_bytes()
    with pytest.raises(ValueError, match="kv_dtype"):
        PagedKVCache(cfg, kv_dtype="fp8", **kw)


# ---------------------------------------------------------------------------
# (vii) the engine
# ---------------------------------------------------------------------------

def _workload(cfg):
    rng = np.random.default_rng(2)
    return [(rng.integers(1, cfg.vocab_size, size=(L,)).tolist(), m)
            for L, m in ((5, 6), (19, 4), (11, 5))]


@pytest.mark.parametrize("knobs", [
    {"weight_dtype": "int8"}, {"kv_dtype": "int8"},
    {"weight_dtype": "int8", "kv_dtype": "int8"}, {"prefill_chunk": 8},
    {"weight_dtype": "int8", "kv_dtype": "int8", "prefill_chunk": 8}],
    ids=["w8", "kv8", "w8kv8", "chunk8", "w8kv8chunk8"])
def test_engine_greedy_streams_match_reference(model, knobs):
    """More requests than slots, two prompt buckets, prompts longer than
    one chunk: the port's engine and the JAX engine (prefix cache off)
    emit identical streams."""
    jcfg, cfg, jparams, params, _ = model
    kw = dict(max_slots=2, max_seq_len=32, **knobs)
    eng = Engine(cfg, params, device="cpu", **kw)
    reqs = [eng.submit(p, m) for p, m in _workload(cfg)]
    eng.run()
    jeng = JEngine(jcfg, jparams, prefix_cache=False, **kw)
    jreqs = [jeng.submit(p, m) for p, m in _workload(cfg)]
    jeng.run()
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    assert all(r.state is RequestState.DONE for r in reqs)
    r = eng.runner
    assert r.quant_fallbacks == jeng.runner.quant_fallbacks == []
    assert r.kv_dtype == jeng.runner.kv_dtype
    assert r.weight_dtype == jeng.runner.weight_dtype
    st, jst = r.cache_stats(), jeng.runner.cache_stats()
    for key in ("kv_dtype", "weight_dtype", "quantized_weight_leaves",
                "pool_bytes", "bytes_per_block", "num_blocks"):
        assert st[key] == jst[key], key
    # int8 KV or chunked prefill: every prompt went through the chunk
    # program, never the bucketed prefill
    chunked = knobs.get("kv_dtype") == "int8" or "prefill_chunk" in knobs
    assert (r.prefill_calls == 0) == chunked
    assert (r.chunk_calls > 0) == chunked
    assert r.kv.free_blocks == r.kv.num_blocks - 1
    r.kv.check_invariants()


# ---------------------------------------------------------------------------
# (viii) the serve CLI
# ---------------------------------------------------------------------------

def test_serve_cli_int8_chunked_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--requests", "3", "--input-len",
         "12", "--output-len", "4", "--slots", "2", "--weight-dtype", "int8",
         "--kv-dtype", "int8", "--prefill-chunk", "8"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "finished 3/3 requests" in out.stdout
    assert "quantized: kv=int8 weights=int8 (8 leaves)" in out.stdout
    assert "chunk calls" in out.stdout
