"""The port's model against the JAX package on the CPU: one parameter
tree from the reference ``init_pt`` (fixed key) loaded into both
packages, the same numpy inputs, ``reduced_config("pt-6b-d4")`` (8
layers, 4 tracks, d 32, fp32).

Tolerances: single ops 2e-5 (fp32, as tests/test_kernels.py); whole-model
logits 1e-4 — eight layers of fp32 matmuls, softmaxes and track means
summed in a different order by XLA and by PyTorch drift by a few 1e-6,
and 1e-4 is the loosest tolerance the port allows itself in fp32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.paged import PagedLeaf as JPagedLeaf
from repro.common.paged import token_to_pool as j_token_to_pool
from repro.configs import reduced_config as j_reduced_config
from repro.core import track as jtrack
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import mlp as jmlp
from repro.models import norms as jnorms
from repro.models import rope as jrope
from repro_torch.common.paged import PagedLeaf, token_to_pool
from repro_torch.configs import reduced_config
from repro_torch.core import track
from repro_torch.models import attention, layers, mlp, norms, rope
from repro_torch.weights import from_jax_params

OP_TOL = 2e-5
MODEL_TOL = 1e-4
ARCH = "pt-6b-d4"


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


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def model():
    jcfg = j_reduced_config(ARCH)
    cfg = reduced_config(ARCH)
    jparams = jax.jit(lambda k: jtrack.init_pt(k, jcfg))(
        jax.random.PRNGKey(0))
    # the reference draws norm scales as zeros; perturb them (in both
    # packages) so the (1 + scale) weight is exercised
    rng = np.random.default_rng(0)
    tree = _np_tree(jparams)
    for ln in ("ln1", "ln2"):
        s = tree["blocks"][ln]["scale"]
        tree["blocks"][ln]["scale"] = (
            rng.standard_normal(s.shape).astype(np.float32) * 0.1)
    tree["final_norm"]["scale"] = (
        rng.standard_normal(tree["final_norm"]["scale"].shape)
        .astype(np.float32) * 0.1)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    params = from_jax_params(tree, cfg, device="cpu")
    return jcfg, cfg, jparams, params, tree


def _layer(tree, r, j):
    return jax.tree_util.tree_map(lambda l: l[r, j], tree)


def _t(tree):
    """Port layer params (dict of [n, ...] tensors) from the JAX layer."""
    return jax.tree_util.tree_map(
        lambda l: torch.from_numpy(np.array(l)), tree)


def test_weight_bridge_keeps_every_leaf(model):
    jcfg, cfg, jparams, params, _ = model
    jl = jax.tree_util.tree_leaves_with_path(jparams)
    for path, leaf in jl:
        node = params
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape
        assert np.array_equal(node.numpy(), np.asarray(leaf)), path
    assert params["tail"] == ()


def test_weight_bridge_bf16_and_shape_checks(model):
    cfg = reduced_config(ARCH).replace(dtype="bfloat16")
    # the reference's bf16 tree: weights cast to jnp.bfloat16 (numpy
    # leaves of the ml_dtypes bfloat16 type), norm scales kept in fp32
    tree = jax.tree_util.tree_map_with_path(
        lambda path, a: a if "scale" in jax.tree_util.keystr(path)
        else np.asarray(jnp.asarray(a).astype(jnp.bfloat16)), model[4])
    params = from_jax_params(tree, cfg, device="cpu")
    wq = params["blocks"]["mixer"]["wq"]
    assert wq.dtype == torch.bfloat16
    assert np.array_equal(wq.view(torch.int16).numpy(),
                          tree["blocks"]["mixer"]["wq"].view(np.int16))
    assert params["blocks"]["ln1"]["scale"].dtype == torch.float32
    tree["blocks"]["mixer"]["wo"] = tree["blocks"]["mixer"]["wo"][..., :-1]
    with pytest.raises(ValueError, match="wo"):
        from_jax_params(tree, cfg, device="cpu")


def test_rmsnorm_rope_mlp_match_reference(model):
    jcfg, cfg, jparams, params, _ = model
    rng = np.random.default_rng(1)
    n, d = cfg.pt.n_tracks, cfg.d_model
    x = rng.standard_normal((n, 2, 5, d)).astype(np.float32)
    lj = _layer(jparams["blocks"], 1, 2)
    lt = _t(lj)
    out = norms.rmsnorm(lt["ln1"], torch.from_numpy(x), eps=cfg.norm_eps)
    want = jax.jit(jax.vmap(
        lambda p, h: jnorms.rmsnorm(p, h, eps=jcfg.norm_eps)))(
        lj["ln1"], jnp.asarray(x))
    _close(out, want)

    pos = rng.integers(0, 600, size=(2, 5)).astype(np.int32)
    xh = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    cos, sin = rope.rope_cos_sin(torch.from_numpy(pos), 8, cfg.rope_theta)
    jcos, jsin = jrope.rope_cos_sin(jnp.asarray(pos), 8, jcfg.rope_theta)
    _close(cos, jcos)
    _close(rope.apply_rope(torch.from_numpy(xh), cos, sin),
           jrope.apply_rope(jnp.asarray(xh), jcos, jsin))
    assert torch.equal(rope.positions_default(2, 4, 3),
                       torch.from_numpy(np.array(
                           jrope.positions_default(2, 4, 3))))

    _close(mlp.mlp_apply(lt["mlp"], torch.from_numpy(x)),
           jax.jit(jax.vmap(lambda p, h: jmlp.mlp_apply(p, h, "swiglu")))(
               lj["mlp"], jnp.asarray(x)))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_attention_apply_matches_reference(model, use_pallas):
    """Prefill attention over all tracks; the reference runs the jnp
    blockwise path or the Pallas flash kernel (interpret mode)."""
    jcfg, cfg, jparams, params, _ = model
    jcfg = jcfg.replace(use_pallas=use_pallas)
    spec, jspec = cfg.spec("full"), jcfg.spec("full")
    rng = np.random.default_rng(2)
    n, B, S = cfg.pt.n_tracks, 2, 16
    x = rng.standard_normal((n, B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32) + 3, (B, S)).copy()
    lj = _layer(jparams["blocks"], 0, 1)["mixer"]
    out, (k, v) = attention.attention_apply(
        _t(lj), torch.from_numpy(x), spec=spec, cfg=cfg,
        positions=torch.from_numpy(pos), return_cache=True)
    jout, (jk, jv) = jax.jit(jax.vmap(lambda p, h: jattn.attention_apply(
        p, h, spec=jspec, cfg=jcfg, positions=jnp.asarray(pos),
        return_cache=True)))(lj, jnp.asarray(x))
    _close(out, jout)
    _close(k, jk)
    _close(v, jv)


def _pools(cfg, N, bs, rng):
    shape = (cfg.pt.n_tracks, N, bs, cfg.n_kv_heads, cfg.head_dim)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def test_token_to_pool_matches_reference():
    table = np.asarray([[3, 1, 0], [2, 5, 4]], np.int32)
    pos = np.asarray([[0, 5, 9, 15, 16, 40], [1, 8, 23, 31, 47, 48]],
                     np.int32)
    got = token_to_pool(torch.from_numpy(table), torch.from_numpy(pos), 8)
    want = j_token_to_pool(jnp.asarray(table), jnp.asarray(pos), 8)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_paged_decode_matches_reference(model):
    """Write-before-read decode against shared pools: the new K/V rows
    land through the table (the idle lane's zeroed row sends its write
    to trash block 0), then attention reads lengths = pos + 1."""
    jcfg, cfg, jparams, params, _ = model
    spec, jspec = cfg.spec("full"), jcfg.spec("full")
    rng = np.random.default_rng(3)
    n, B, N, bs = cfg.pt.n_tracks, 3, 10, 4
    kp, vp = _pools(cfg, N, bs, rng)
    table = np.asarray([[4, 7, 2], [9, 1, 3], [0, 0, 0]], np.int32)
    pos = np.asarray([9, 5, 2], np.int32)
    x = rng.standard_normal((n, B, 1, cfg.d_model)).astype(np.float32)
    lj = _layer(jparams["blocks"], 1, 3)["mixer"]
    kt, vt = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    out, _ = attention.attention_decode(
        _t(lj), torch.from_numpy(x), (PagedLeaf(kt), PagedLeaf(vt)),
        spec=spec, cfg=cfg, pos=torch.from_numpy(pos),
        block_table=torch.from_numpy(table), kv_max_len=12)

    def one(p, h, k, v):
        return jattn.attention_decode(
            p, h, (JPagedLeaf(k), JPagedLeaf(v)), spec=jspec, cfg=jcfg,
            pos=jnp.asarray(pos), block_table=jnp.asarray(table))

    jout, (jk, jvv) = jax.jit(jax.vmap(one))(
        lj, jnp.asarray(x), jnp.asarray(kp), jnp.asarray(vp))
    _close(out, jout)
    live = [b for b in range(1, N)]            # trash block 0 is scratch
    _close(kt[:, live], np.asarray(jk.pool)[:, live])
    _close(vt[:, live], np.asarray(jvv.pool)[:, live])


def test_layer_apply_prefill_and_decode_match_reference(model):
    jcfg, cfg, jparams, params, _ = model
    spec, jspec = cfg.spec("full"), jcfg.spec("full")
    rng = np.random.default_rng(4)
    n, B, S = cfg.pt.n_tracks, 2, 8
    lj = _layer(jparams["blocks"], 0, 0)
    x = rng.standard_normal((n, B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    out, (k, _) = layers.layer_apply(_t(lj), torch.from_numpy(x), cfg=cfg,
                                     spec=spec, mode="prefill",
                                     positions=torch.from_numpy(pos))
    jout, (jk, _), _ = jax.jit(jax.vmap(lambda p, h: jlayers.layer_apply(
        p, h, cfg=jcfg, spec=jspec, mode="prefill",
        positions=jnp.asarray(pos))))(lj, jnp.asarray(x))
    _close(out, jout)
    _close(k, jk)

    kp, vp = _pools(cfg, 6, 4, rng)
    table = np.asarray([[2, 5, 1], [3, 4, 0]], np.int32)
    dpos = np.asarray([6, 3], np.int32)
    xd = rng.standard_normal((n, B, 1, cfg.d_model)).astype(np.float32)
    out, _ = layers.layer_apply(
        _t(lj), torch.from_numpy(xd), cfg=cfg, spec=spec, mode="decode",
        pos=torch.from_numpy(dpos),
        cache=(PagedLeaf(torch.from_numpy(kp.copy())),
               PagedLeaf(torch.from_numpy(vp.copy()))),
        block_table=torch.from_numpy(table))
    jout, _, _ = jax.jit(jax.vmap(lambda p, h, k, v: jlayers.layer_apply(
        p, h, cfg=jcfg, spec=jspec, mode="decode", pos=jnp.asarray(dpos),
        cache=(JPagedLeaf(k), JPagedLeaf(v)),
        block_table=jnp.asarray(table))))(lj, jnp.asarray(xd),
                                          jnp.asarray(kp), jnp.asarray(vp))
    _close(out, jout)


def _scatter_prefill(pool, rows, table, bs):
    """numpy paged insert: rows [R, D, n, B, S, KH, hd] through table."""
    R, D, n, N, _, KH, hd = pool.shape
    B, S = rows.shape[3:5]
    pos = np.broadcast_to(np.arange(S), (B, S))
    idx = np.asarray(j_token_to_pool(jnp.asarray(table), jnp.asarray(pos),
                                     bs)).reshape(-1)
    flat = pool.reshape(R, D, n, N * bs, KH, hd)
    flat[:, :, :, idx] = rows.reshape(R, D, n, B * S, KH, hd)
    return flat.reshape(pool.shape)


def test_pt_forward_and_decode_steps_match_reference(model):
    """Whole model: prefill logits and K/V, then three teacher-forced
    paged decode steps from the same pools and block table."""
    jcfg, cfg, jparams, params, _ = model
    rng = np.random.default_rng(5)
    B, S, bs = 2, 12, 4
    toks = rng.integers(1, cfg.vocab_size, size=(B, S)).astype(np.int32)
    logits, cache = track.pt_forward(params,
                                     {"inputs": torch.from_numpy(toks)}, cfg)
    jlogits, jcache, _ = jax.jit(lambda p, t: jtrack.pt_forward(
        p, {"inputs": t}, jcfg, mode="prefill"))(jparams, jnp.asarray(toks))
    _close(logits, jlogits, MODEL_TOL)
    _close(cache["blocks"][0], jcache["blocks"][0], MODEL_TOL)
    _close(cache["blocks"][1], jcache["blocks"][1], MODEL_TOL)

    nmax, N = 5, 12
    table = np.asarray([[3, 7, 1, 10, 0], [2, 5, 9, 4, 0]], np.int32)
    shape = track.pt_cache_shape(cfg, N, bs)
    pools = [_scatter_prefill(np.zeros(shape, np.float32),
                              np.asarray(jc), table, bs)
             for jc in jcache["blocks"]]
    tcache = {"blocks": tuple(PagedLeaf(torch.from_numpy(p.copy()))
                              for p in pools), "tail": ()}
    jc = {"blocks": tuple(JPagedLeaf(jnp.asarray(p)) for p in pools),
          "tail": ()}
    lengths = np.asarray([S, S - 3], np.int32)     # ragged rows
    jstep = jax.jit(lambda p, c, tok, pos: jtrack.pt_decode_step(
        p, c, tok, pos, jcfg, block_table=jnp.asarray(table),
        kv_max_len=16))
    for t in range(3):
        tok = rng.integers(1, cfg.vocab_size, size=(B,)).astype(np.int32)
        pos = lengths + t
        lg, tcache = track.pt_decode_step(
            params, tcache, torch.from_numpy(tok), torch.from_numpy(pos),
            cfg, block_table=torch.from_numpy(table), kv_max_len=16)
        jlg, jc = jstep(jparams, jc, jnp.asarray(tok), jnp.asarray(pos))
        _close(lg, jlg, MODEL_TOL)
    live = list(range(1, N))
    _close(tcache["blocks"][0].pool[:, :, :, live],
           np.asarray(jc["blocks"][0].pool)[:, :, :, live], MODEL_TOL)


def test_fuse_accumulates_bf16_mean_in_fp32():
    """A bf16 track mean matches jnp.mean, which sums in fp32."""
    cfg = reduced_config(ARCH)
    rng = np.random.default_rng(6)
    h = rng.standard_normal((4, 2, 3, 32)).astype(np.float32) * 50
    got = track._fuse(torch.from_numpy(h).to(torch.bfloat16), cfg)
    want = jnp.mean(jnp.asarray(h).astype(jnp.bfloat16), axis=0)
    assert np.array_equal(got.view(torch.int16).numpy(),
                          np.asarray(want).view(np.int16))


def test_sync_accounting_matches_reference():
    for L, D in ((32, 4), (40, 8), (48, 2), (10, 4)):
        assert track.pt_sync_points(L, D) == jtrack.pt_sync_points(L, D)
        assert track.sync_reduction(L, D) == jtrack.sync_reduction(L, D)
    for name in ("pt-6b-d4", "pt-13b-d8", "pt-30b-d2"):
        from repro.configs import get_config as jget
        from repro_torch.configs import get_config
        a, b = get_config(name), jget(name)
        for c in (a, b):
            assert c.name == a.name
        assert (a.n_layers, a.d_model, a.n_heads, a.n_kv_heads, a.head_dim,
                a.d_ff, a.vocab_size, a.rope_theta, a.pt.n_tracks,
                a.pt.block_depth) == \
            (b.n_layers, b.d_model, b.n_heads, b.n_kv_heads, b.head_dim,
             b.d_ff, b.vocab_size, b.rope_theta, b.pt.n_tracks,
             b.pt.block_depth)


# ---------------------------------------------------------------------------
# the fused norms against the unfused layer loop they replaced
# ---------------------------------------------------------------------------

def _unfused(params, cfg, tokens, mode, cache=None, pos=None):
    """Logits of the sequence the port ran before its norms took in the
    residual adds and the track fusion: whole layers (``layer_apply``:
    norm, mixer, add, norm, MLP, add), in a PT model each block's input
    spread to the tracks by a contiguous copy and ``_fuse`` (fp32 mean,
    cast back) at its end, then ``_head`` (final norm, LM head).  tokens
    [B] (decode) or [B, S]; caches updated in place."""
    from repro_torch.models import decoder as dec
    tok = tokens[:, None] if mode == "decode" else tokens
    h = dec._embed(params, tok, cfg)
    kw = (dict(positions=rope.positions_default(*tok.shape, device="cpu"))
          if mode == "prefill" else dict(pos=pos))
    if cfg.pt is not None:
        R, D = cfg.n_layers // cfg.pt.block_depth, cfg.pt.block_depth
        spec = cfg.spec(cfg.pattern_unit[0])
        for r in range(R):
            hh = h[None].expand(cfg.pt.n_tracks, *h.shape).contiguous()
            for j in range(D):
                lc = (None if cache is None else
                      tuple(c[r, j] for c in cache["blocks"]))
                hh, _ = layers.layer_apply(track._layer(params["blocks"], r,
                                                        j), hh, cfg=cfg,
                                           spec=spec, mode=mode, cache=lc,
                                           **kw)
            h = track._fuse(hh, cfg)
    else:
        for group, i, r, nm in dec._layers(cfg):
            lp, lc = ((params[group][i], None if cache is None
                       else cache[group][i]) if r is None else
                      (dec._at(params["unit"][i], r), None if cache is None
                       else dec._at(cache["unit"][i], r)))
            h, _ = layers.layer_apply(lp, h, cfg=cfg, spec=cfg.spec(nm),
                                      mode=mode, cache=lc, **kw)
    return dec._head(params, h[:, 0] if mode == "decode" else h, cfg)


@pytest.mark.parametrize("arch", ["pt-6b-d4", "dense-6b", "falcon-mamba-7b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_norm_loop_equals_the_unfused_loop_bitwise(arch, dtype):
    """Reduced PT, dense ``lm_*`` and falcon-mamba models: prefill, two
    decode steps and a chunk of 3 on the contiguous cache give the same
    logits bit for bit, and leave the same cache bytes, whether the
    residual adds and the fusion run inside the norms (the model entry
    points) or as the ops they replaced (``_unfused``); so the greedy
    streams are those of before too."""
    from repro_torch.launch.steps import model_fns
    cfg = reduced_config(arch).replace(dtype=dtype)
    fns = model_fns(cfg)
    params = fns["init"](torch.Generator().manual_seed(0), cfg, "cpu")
    rng = np.random.default_rng(7)

    def perturb(tree):           # norm scales are drawn as zeros
        for k, v in tree.items():
            if isinstance(v, dict):
                perturb(v)
            elif isinstance(v, tuple):
                for u in v:
                    perturb(u)
            elif k == "scale":
                v.copy_(torch.from_numpy(rng.standard_normal(
                    tuple(v.shape)).astype(np.float32) * 0.1))

    perturb(params)
    B, S = 2, 5
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (B, S)))
    got, _ = fns["forward"](params, {"inputs": toks}, cfg)
    assert torch.equal(got, _unfused(params, cfg, toks, "prefill"))
    new = fns["init_cache"](cfg, B, 8, "cpu")
    old = jax.tree_util.tree_map(torch.clone, new)
    for p in range(2):
        tok = torch.from_numpy(rng.integers(1, cfg.vocab_size, (B,)))
        pos = torch.full((B,), p, dtype=torch.int32)
        got, _ = fns["decode"](params, new, tok, pos, cfg)
        assert torch.equal(got, _unfused(params, cfg, tok, "decode", old,
                                         pos)), p
    chunk = torch.from_numpy(rng.integers(1, cfg.vocab_size, (B, 3)))
    pos = torch.full((B,), 2, dtype=torch.int32)
    got, _ = fns["chunk"](params, new, chunk, pos, cfg)
    assert torch.equal(got, _unfused(params, cfg, chunk, "chunk", old, pos))
    for a, b in zip(jax.tree_util.tree_leaves(new),
                    jax.tree_util.tree_leaves(old)):
        assert torch.equal(a, b)
