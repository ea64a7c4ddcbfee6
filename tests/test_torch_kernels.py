"""The port's kernels: plain PyTorch versions against the JAX package's
Pallas kernels (interpret mode) and pure-jnp oracles, on the same numpy
inputs, with the tolerances of tests/test_kernels.py (fp32 2e-5, bf16
2e-2).  The wrappers run the plain versions for CPU tensors; the CUDA
kernels themselves are held against the plain versions on the card
(``tests/test_torch_gpu.py`` and ``chip_smoke.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import decode_attention as da

_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs on several pytest-xdist workers at once: one
    intra-op thread keeps torch's idle pool threads off the cores the
    other workers use (the shapes here are too small to gain from more)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(a: np.ndarray, dtype: str):
    """One fp32 numpy array as a JAX array and a torch tensor of dtype
    (both round to nearest even, so bf16 inputs are bit-identical)."""
    return (jnp.asarray(a).astype(_JDT[dtype]),
            torch.from_numpy(a).to(_TDT[dtype]))


def _close(t: torch.Tensor, j, dtype: str) -> None:
    tol = _TOL[dtype]
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("shape,per_track", [((3, 2, 5, 32), True),
                                             ((4, 48), False),
                                             ((2, 6, 1408), True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_pallas(shape, per_track, dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32) * 3
    d = shape[-1]
    scale = rng.standard_normal((shape[0], d) if per_track else (d,)
                                ).astype(np.float32) * 0.2
    xj, xt = _pair(x, dtype)
    out = ref.rmsnorm_plain(xt, torch.from_numpy(scale))
    if per_track:                   # one Pallas call per track
        for i in range(shape[0]):
            _close(out[i], jops.rmsnorm(xj[i], jnp.asarray(scale[i]),
                                        block_rows=4), dtype)
            _close(out[i], jref.rmsnorm_ref(xj[i], jnp.asarray(scale[i])),
                   dtype)
    else:
        _close(out, jops.rmsnorm(xj, jnp.asarray(scale), block_rows=4), dtype)


# (route, x shape, per-track scale, x a fused row broadcast to every
# track): the residual add before a norm, and a track-block boundary under
# the next layer's per-track scales or the final norm's one row
_NORM_ROUTES = [("add_norm", (3, 2, 5, 32), True, False),
                ("add_norm", (4, 48), False, False),
                ("add_norm", (3, 2, 5, 32), True, True),
                ("fuse_norm", (4, 2, 3, 32), True, False),
                ("fuse_norm", (4, 2, 3, 32), False, False),
                ("fuse_norm", (2, 6, 1408), True, True)]


def _route_inputs(shape, per_track, bcast, seed=0):
    """x (fp32 numpy, [n, ...] or one row broadcast over n), delta and
    the scale rows of one route's call."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape[1:] if bcast else shape).astype(
        np.float32) * 3
    x = np.broadcast_to(x, shape) if bcast else x
    delta = rng.standard_normal(shape).astype(np.float32) * 2
    d = shape[-1]
    scale = rng.standard_normal((shape[0], d) if per_track else (d,)
                                ).astype(np.float32) * 0.2
    return x, delta, scale


def _torch_x(x: np.ndarray, dtype: str) -> torch.Tensor:
    """x as a torch tensor; a broadcast numpy row stays a broadcast view
    (track stride 0), as the PT model hands its fused rows over."""
    if x.strides[0] == 0:
        return torch.from_numpy(np.array(x[0])).to(
            _TDT[dtype])[None].expand(x.shape)
    return torch.from_numpy(np.ascontiguousarray(x)).to(_TDT[dtype])


@pytest.mark.parametrize("route,shape,per_track,bcast", _NORM_ROUTES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_add_and_fuse_rmsnorm_plain_match_jax(route, shape, per_track,
                                              bcast, dtype):
    """The routes' plain versions against the JAX composition they fold:
    jnp ``x + h`` then ``repro.models.norms.rmsnorm``; and
    ``repro.core.track._fuse`` of ``x + h`` then ``rmsnorm`` under each
    track's scale row (or the final [d])."""
    from repro.configs import reduced_config as j_reduced_config
    from repro.core import track as jtrack
    from repro.models import norms as jnorms
    from repro.runtime.parallel import Parallelism
    x, delta, scale = _route_inputs(shape, per_track, bcast)
    xj = jnp.asarray(np.ascontiguousarray(x)).astype(_JDT[dtype])
    dj, dt = _pair(delta, dtype)
    xn = xj + dj
    s = torch.from_numpy(scale)

    def jnorm(v, i=None):
        row = scale if i is None else scale[i]
        return jnorms.rmsnorm({"scale": jnp.asarray(row)}, v)

    if route == "add_norm":
        got_x, y = ref.add_rmsnorm_plain(_torch_x(x, dtype), dt, s)
        _close(got_x, xn, dtype)
        want = ([jnorm(xn[i], i) for i in range(shape[0])] if per_track
                else [jnorm(xn)])
    else:
        f, y = ref.fuse_rmsnorm_plain(_torch_x(x, dtype), dt, s)
        fj = jtrack._fuse(xn, j_reduced_config("pt-6b-d4"), Parallelism())
        _close(f, fj, dtype)
        want = ([jnorm(fj, i) for i in range(shape[0])] if per_track
                else [jnorm(fj)])
    for i, w in enumerate(want):
        _close(y[i] if len(want) > 1 else y, w, dtype)


@pytest.mark.parametrize("route,shape,per_track,bcast", _NORM_ROUTES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_routes_equal_the_unfused_sequence_bitwise(
        route, shape, per_track, bcast, dtype):
    """On the CPU each route is the sequence of PyTorch ops it replaces,
    bit for bit: a fused row spread by a contiguous copy, the residual add
    in the activation dtype, the track mean accumulated in fp32 and cast
    back, then ``rmsnorm_plain``; the wrappers count no launch."""
    from repro_torch.kernels import rmsnorm as rn
    x, delta, scale = _route_inputs(shape, per_track, bcast, seed=3)
    xt, dt = _torch_x(x, dtype), torch.from_numpy(delta).to(_TDT[dtype])
    s = torch.from_numpy(scale)
    xn = xt.contiguous() + dt
    before = (ops.launch_counts(), dict(rn.rmsnorm.routes))
    if route == "add_norm":
        got = ops.add_rmsnorm(xt, dt, s)
        want = (xn, ref.rmsnorm_plain(xn, s))
    else:
        got = ops.fuse_rmsnorm(xt, dt, s)
        f = torch.mean(xn, dim=0, dtype=torch.float32).to(xn.dtype)
        spread = f[None].expand(xn.shape).contiguous()
        want = (f, ref.rmsnorm_plain(spread if per_track else f, s))
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)
    assert (ops.launch_counts(), rn.rmsnorm.routes) == before


# (d, element bytes) -> (threads per CTA, vectors per thread): the serve
# widths of pt-6b-d4 (d 1408) and dense-6b / falcon-mamba (d 4096) in
# bf16 and fp32, and small rows
_NORM_PLANS = [((1408, 2), (192, 1)), ((4096, 2), (512, 1)),
               ((1408, 4), (352, 1)), ((4096, 4), (512, 2)),
               ((32, 4), (32, 1)), ((8192, 2), (512, 2))]


@pytest.mark.parametrize("args,want", _NORM_PLANS)
def test_rmsnorm_launch_plan(args, want):
    from repro_torch.kernels import rmsnorm as rn
    assert rn.launch_plan(*args) == want
    threads, vpt = want
    d, size = args
    assert threads % 32 == 0 and threads <= 512 and vpt in (1, 2)
    assert threads * vpt * 16 >= d * size > (threads * vpt - 32) * 16


def test_rmsnorm_routes_refuse_what_the_kernel_cannot_take():
    from repro_torch.kernels import rmsnorm as rn
    x, d = torch.randn(2, 3, 16), torch.randn(2, 3, 16)
    s = torch.zeros(2, 16)
    for bad in ((36, 2), (16384, 2), (0, 4), (4100, 4)):
        with pytest.raises(ValueError):
            rn.launch_plan(*bad)
    with pytest.raises(ValueError, match="delta"):
        ops.add_rmsnorm(x, d.transpose(1, 2).contiguous().transpose(1, 2),
                        s)
    with pytest.raises(ValueError, match="delta"):
        ops.fuse_rmsnorm(x, d[:, :2], s)
    with pytest.raises(ValueError, match="contiguous"):
        ops.add_rmsnorm(torch.randn(2, 3, 32)[..., :16], d, s)
    with pytest.raises(ValueError):
        ops.fuse_rmsnorm(x, d, torch.zeros(3, 16))
    with pytest.raises(ValueError, match="fusion_op"):
        ops.fuse_rmsnorm(x, d, s, fusion_op="max")
    with pytest.raises(ValueError):
        ops.add_rmsnorm(x, d, torch.zeros(3, 16))


@pytest.mark.parametrize("B,S,H,KH,hd,dtype,causal", [
    (2, 64, 4, 1, 32, "float32", True), (2, 64, 4, 1, 32, "bfloat16", False),
    (1, 96, 4, 2, 64, "float32", False), (1, 96, 4, 2, 64, "bfloat16", True)])
def test_flash_plain_matches_pallas(B, S, H, KH, hd, dtype, causal):
    """GQA by head index: the port reads K/V [B,S,KH,hd]; the Pallas
    kernel gets the expanded copy (h -> h // G), as attention.py builds."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KH, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KH, hd)).astype(np.float32)
    G = H // KH
    qj, qt = _pair(q, dtype)
    kj, kt = _pair(np.repeat(k, G, axis=2), dtype)
    vj, vt = _pair(np.repeat(v, G, axis=2), dtype)
    out = ref.flash_attention_plain(qt, _pair(k, dtype)[1],
                                    _pair(v, dtype)[1], causal=causal)
    _close(out, jops.flash_attention(qj, kj, vj, causal=causal, block_q=32,
                                     block_k=32), dtype)
    _close(out, jref.flash_attention_ref(qj, kj, vj, causal=causal), dtype)


def test_flash_plain_softcap_matches_pallas():
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, 64, 2, 32)).astype(np.float32) * 4
               for _ in range(3))
    out = ref.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=True,
                                    softcap=30.0)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, softcap=30.0,
                                block_q=32, block_k=32)
    _close(out, want, "float32")


def _paged_inputs(n, B, KH, G, hd, bs, nmax, seed=7):
    """Shared pool with shuffled per-row tables and ragged lengths."""
    rng = np.random.default_rng(seed)
    N = B * nmax + 3                        # spare blocks + trash block 0
    q = rng.standard_normal((n, B, KH * G, hd)).astype(np.float32)
    kp = rng.standard_normal((n, N, bs, KH, hd)).astype(np.float32)
    vp = rng.standard_normal((n, N, bs, KH, hd)).astype(np.float32)
    table = (rng.permutation(N - 1)[:B * nmax].reshape(B, nmax) + 1
             ).astype(np.int32)
    lengths = np.asarray([1 + (11 * i + 5) % (nmax * bs) for i in range(B)],
                         np.int32)
    return q, kp, vp, table, lengths


@pytest.mark.parametrize("n,B,KH,G,hd,bs,nmax,dtype", [
    (3, 1, 1, 4, 64, 8, 8, "float32"), (3, 1, 1, 4, 64, 8, 8, "bfloat16"),
    (1, 3, 4, 1, 128, 32, 2, "bfloat16"), (4, 2, 1, 2, 8, 16, 3, "float32")])
def test_paged_decode_plain_matches_pallas(n, B, KH, G, hd, bs, nmax, dtype):
    """Leading track dim: the port covers all tracks in one call, the
    Pallas kernel runs per track with the shared table.  A ``max_len``
    cut at the longest live row changes nothing."""
    q, kp, vp, table, lengths = _paged_inputs(n, B, KH, G, hd, bs, nmax)
    qj, qt = _pair(q, dtype)
    kj, kt = _pair(kp, dtype)
    vj, vt = _pair(vp, dtype)
    tt, lt = torch.from_numpy(table), torch.from_numpy(lengths)
    ml = int(lengths.max())
    out = ref.paged_decode_attention_plain(qt, kt, vt, tt, lt)
    cut = ref.paged_decode_attention_plain(qt, kt, vt, tt, lt, max_len=ml)
    tj, lj = jnp.asarray(table), jnp.asarray(lengths)
    kernel = jax.vmap(lambda q, k, v: jops.paged_decode_attention(
        q, k, v, tj, lj, max_len=ml))(qj, kj, vj)
    oracle = jax.jit(jax.vmap(lambda q, k, v: jref.paged_decode_attention_ref(
        q, k, v, tj, lj)))(qj, kj, vj)
    for mine in (out, cut):
        _close(mine, kernel, dtype)
        _close(mine, oracle, dtype)


def test_paged_decode_max_len_cut_drops_columns_past_it():
    """A ``max_len`` below a row's length sweeps only the first
    ceil(max_len / bs) blocks, as the Pallas grid does."""
    q, kp, vp, table, _ = _paged_inputs(1, 2, 1, 2, 16, 8, 4)
    lengths = np.asarray([30, 20], np.int32)
    out = ref.paged_decode_attention_plain(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), torch.from_numpy(lengths), max_len=9)
    want = jops.paged_decode_attention(
        jnp.asarray(q[0]), jnp.asarray(kp[0]), jnp.asarray(vp[0]),
        jnp.asarray(table), jnp.asarray(lengths), max_len=9)
    _close(out[0], want, "float32")


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_decode_plain_stores_zeros_for_an_empty_row(layout):
    """A row with no live token stores zeros, as the Pallas kernels (and
    the CUDA kernel) do; the other rows are untouched."""
    q, kp, vp, table, _ = _paged_inputs(1, 3, 1, 2, 16, 8, 4)
    lengths = np.asarray([0, 5, 30], np.int32)
    if layout == "paged":
        out = ref.paged_decode_attention_plain(
            *(torch.from_numpy(a) for a in (q, kp, vp, table, lengths)))[0]
        want = jops.paged_decode_attention(
            jnp.asarray(q[0]), jnp.asarray(kp[0]), jnp.asarray(vp[0]),
            jnp.asarray(table), jnp.asarray(lengths))
    else:
        k, v = kp[0, 1:4], vp[0, 1:4]              # [B 3, S 8, KH 1, hd]
        out = ref.decode_attention_plain(
            *(torch.from_numpy(a) for a in (q[0], k, v, lengths)))
        want = jops.decode_attention(jnp.asarray(q[0]), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(lengths),
                                     block_s=8)
    assert not out[0].any()
    _close(out, want, "float32")


# (sweep, base, page): the serve shapes (592 paged / 584 contiguous swept
# tokens over 64 base blocks), short and long contexts, batches of one,
# a page size of 32, a sweep past one split per SM-pair's worth
@pytest.mark.parametrize("sweep,base,page", [
    (592, 64, 16), (584, 64, None), (64, 8, 16), (4096, 8, 16),
    (4096, 64, 16), (16, 18, 16), (72, 8, None), (100_000, 1, 8),
    (37, 3, None), (640, 18, 32)])
def test_split_plan_covers_each_swept_token_once(sweep, base, page):
    """The decode kernel's split of the swept tokens over blocks: each
    token in exactly one split, no split empty, paged splits whole pages
    (at most the kernel's page cache), between 1 and the kernel's split
    bound, made from host ints alone; the same sweep gives the same plan
    on either layout, and a card with more SMs never fewer splits."""
    n, c = da.split_plan(sweep, base, page)
    assert type(n) is int and type(c) is int
    assert 1 <= n <= da._MAX_SPLITS and c >= 1
    covered = [t for s in range(n) for t in range(s * c, min((s + 1) * c,
                                                            sweep))]
    assert covered == list(range(sweep))
    assert (n - 1) * c < sweep
    if page is not None:
        assert c % page == 0 and c // page <= da._MAX_PAGES
        assert da.split_plan(sweep, base, None) == (n, c)
    assert da.split_plan(sweep, base, page) == (n, c)
    assert da.split_plan(sweep, base, page, sms=2 * da.H100_SMS)[0] >= n


def test_split_plan_refuses_what_the_kernel_cannot_hold():
    """Past the split bound in pages of the kernel's page cache, and for
    an empty sweep, the planner raises instead of planning."""
    with pytest.raises(ValueError, match="splits"):
        da.split_plan(da._MAX_SPLITS * da._MAX_PAGES * 4 + 1, 1, 4)
    with pytest.raises(ValueError):
        da.split_plan(0, 8, 16)


def test_wrappers_run_plain_on_cpu_without_counting():
    q, kp, vp, table, lengths = _paged_inputs(2, 2, 1, 2, 16, 8, 3)
    args = [torch.from_numpy(a) for a in (q, kp, vp, table, lengths)]
    x = torch.randn(2, 3, 16)
    s = torch.zeros(2, 16)
    fq, fk = torch.randn(2, 16, 2, 8), torch.randn(2, 16, 1, 8)
    before = ops.launch_counts()
    assert set(before) == {"paged_decode_attention", "flash_attention",
                           "rmsnorm", "paged_decode_attention_int8",
                           "int8_matmul", "ssm_scan", "decode_attention",
                           "decode_attention_int8"}
    assert all(isinstance(v, int) for v in before.values())
    assert torch.equal(ops.paged_decode_attention(*args, max_len=16),
                       ref.paged_decode_attention_plain(*args, max_len=16))
    assert torch.equal(ops.flash_attention(fq, fk, fk),
                       ref.flash_attention_plain(fq, fk, fk))
    assert torch.equal(ops.rmsnorm(x, s), ref.rmsnorm_plain(x, s))
    a, b, h0 = torch.rand(2, 5, 3, 4), torch.randn(2, 5, 3, 4), x[:, :3, :4]
    for got, want in zip(ops.ssm_scan(a, b, h0), ref.ssm_scan_plain(a, b, h0)):
        assert torch.equal(got, want)
    dk = args[1][0, 1:3].contiguous()
    assert torch.equal(ops.decode_attention(args[0][0], dk, dk, args[4]),
                       ref.decode_attention_plain(args[0][0], dk, dk,
                                                  args[4]))
    # a launch count moves only where a kernel launched, never on the CPU
    assert ops.launch_counts() == before


# (M, K, N, dtype, aligned) -> the W8A16 route: bf16 prefill rows on wgmma
# + TMA where the 16-byte strides and bases allow it, the decode rows (M <=
# 16) on the register-staged kernels, fp32 decode rows (the LM head)
# streaming when N % 16 == 0 and w is aligned
_ROUTES = [((4096, 1408, 3968, "bfloat16", True), "wgmma_tma"),
           ((17, 72, 16, "bfloat16", True), "wgmma_tma"),
           ((16, 1408, 3968, "bfloat16", True), "mma_m16"),
           ((4096, 1404, 3968, "bfloat16", True), "mma_m64"),
           ((4096, 1408, 136, "bfloat16", True), "mma_m64"),
           ((4096, 1408, 3968, "bfloat16", False), "mma_m64"),
           ((8, 1408, 100352, "float32", True), "fma_rows"),
           ((8, 1408, 100344, "float32", True), "fma_m16"),
           ((8, 1408, 100352, "float32", False), "fma_m16"),
           ((17, 1408, 100352, "float32", True), "fma_m64")]


@pytest.mark.parametrize("args,want", _ROUTES)
def test_int8_matmul_route_by_shape_and_alignment(args, want):
    from repro_torch.kernels import quant_matmul as qm
    M, K, N, dtype, aligned = args
    assert qm.route(M, K, N, _TDT[dtype], aligned) == want
    assert want in qm.ROUTES and set(qm.int8_matmul.routes) == set(qm.ROUTES)


def test_int8_matmul_route_refuses_other_dtypes():
    from repro_torch.kernels import quant_matmul as qm
    with pytest.raises(ValueError):
        qm.route(8, 16, 16, torch.float16, True)


# (dtype, hd, aligned[, dv]) -> the flash route: bf16 at hd 64 / 128 /
# 256 / 288 / 320 (v as wide) or MLA's q/k 192 with v 128, 16-byte bases,
# on wgmma + TMA, everything else on the CUDA cores
_FLASH_ROUTES = [(("bfloat16", 128, True), "wgmma_tma"),
                 (("bfloat16", 64, True), "wgmma_tma"),
                 (("bfloat16", 128, False), "cuda_core"),
                 (("bfloat16", 96, True), "cuda_core"),
                 (("bfloat16", 8, True), "cuda_core"),
                 (("float32", 128, True), "cuda_core"),
                 (("float32", 64, False), "cuda_core"),
                 (("bfloat16", 192, True, 128), "wgmma_tma"),
                 (("bfloat16", 192, True), "cuda_core"),
                 (("bfloat16", 192, False, 128), "cuda_core"),
                 (("float32", 192, True, 128), "cuda_core"),
                 (("bfloat16", 128, True, 64), "cuda_core"),
                 (("bfloat16", 256, True), "wgmma_tma"),
                 (("bfloat16", 288, True), "wgmma_tma"),
                 (("bfloat16", 320, True), "wgmma_tma"),
                 (("bfloat16", 256, False), "cuda_core"),
                 (("bfloat16", 288, False), "cuda_core"),
                 (("bfloat16", 320, False), "cuda_core"),
                 (("float32", 320, True), "cuda_core"),
                 (("bfloat16", 224, True), "cuda_core"),
                 (("bfloat16", 320, True, 256), "cuda_core")]


@pytest.mark.parametrize("args,want", _FLASH_ROUTES)
def test_flash_attention_route_by_dtype_hd_and_alignment(args, want):
    from repro_torch.kernels import flash_attention as fa
    dtype, hd, aligned, *dv = args
    assert fa.route(_TDT[dtype], hd, aligned, *dv) == want
    assert set(fa.flash_attention.routes) == set(fa.ROUTES)
    with pytest.raises(ValueError):
        fa.route(torch.float16, hd, aligned)


def test_reset_launch_counts_zeroes_the_route_counts():
    """``reset_launch_counts`` zeroes every launch count and the route
    counters (set by hand here: the CPU launches nothing), and
    ``launch_counts`` keeps its key set."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssm_scan as sk
    keys = set(ops.launch_counts())
    saved = (ops.launch_counts(), dict(fa.flash_attention.routes),
             dict(qm.int8_matmul.routes), dict(rn.rmsnorm.routes),
             dict(sk.ssm_scan.routes))
    try:
        for fn in ops.KERNELS.values():
            fn.launches = 3
        fa.flash_attention.routes["wgmma_tma"] = 2
        qm.int8_matmul.routes["mma_m16"] = 5
        rn.rmsnorm.routes["fuse_norm"] = 4
        sk.ssm_scan.routes["selective"] = 6
        ops.reset_launch_counts()
        assert set(ops.launch_counts()) == keys
        assert not any(ops.launch_counts().values())
        assert not any(fa.flash_attention.routes.values())
        assert not any(qm.int8_matmul.routes.values())
        assert not any(rn.rmsnorm.routes.values())
        assert not any(sk.ssm_scan.routes.values())
    finally:
        for name, n in saved[0].items():
            ops.KERNELS[name].launches = n
        fa.flash_attention.routes.update(saved[1])
        qm.int8_matmul.routes.update(saved[2])
        rn.rmsnorm.routes.update(saved[3])
        sk.ssm_scan.routes.update(saved[4])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_matmul_out_dtype_on_cpu(dtype):
    """bf16 out is the fp32 output rounded once (what the caller's cast
    did); the CPU runs the plain version and counts no launch or route."""
    from repro_torch.common import quant
    from repro_torch.kernels import quant_matmul as qm
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((2, 5, 24)).astype(np.float32)
                         ).to(_TDT[dtype])
    qt = quant.quantize(torch.from_numpy(
        rng.standard_normal((2, 24, 40)).astype(np.float32)), axes=-2)
    before, routes = ops.launch_counts(), dict(qm.int8_matmul.routes)
    full = ops.int8_matmul(x, qt.payload, qt.scale)
    half = ops.int8_matmul(x, qt.payload, qt.scale, out_dtype=torch.bfloat16)
    assert full.dtype == torch.float32 and half.dtype == torch.bfloat16
    assert torch.equal(half, full.to(torch.bfloat16))
    assert torch.equal(half, ref.int8_matmul_plain(
        x, qt.payload, qt.scale, out_dtype=torch.bfloat16))
    # the projection helper writes the activation dtype directly
    got = quant.matmul(x, qt)
    assert got.dtype == x.dtype and torch.equal(got, full.to(x.dtype))
    assert ops.launch_counts() == before
    assert qm.int8_matmul.routes == routes
    with pytest.raises(ValueError):
        ops.int8_matmul(x, qt.payload, qt.scale, out_dtype=torch.float16)


def test_wrappers_refuse_what_no_kernel_takes():
    q, kp, vp, table, lengths = (torch.from_numpy(a) for a in
                                 _paged_inputs(1, 2, 1, 2, 16, 8, 3))
    with pytest.raises(ValueError, match="int32"):
        ops.paged_decode_attention(q, kp, vp, table.long(), lengths)
    with pytest.raises(ValueError):
        ops.paged_decode_attention(q[:, :1], kp, vp, table, lengths)
    with pytest.raises(ValueError):
        ops.flash_attention(torch.randn(1, 8, 3, 8), torch.randn(1, 8, 2, 8),
                            torch.randn(1, 8, 2, 8))
    with pytest.raises(ValueError):
        ops.rmsnorm(torch.randn(3, 4, 8), torch.zeros(2, 8))
    # a device that is neither the CPU nor CUDA is refused, not served
    # by the plain version
    meta = torch.empty(1, 8, 2, 8, device="meta")
    with pytest.raises(ValueError, match="device"):
        ops.flash_attention(meta, meta[:, :, :1], meta[:, :, :1])


def test_kernel_sources_build_into_ignored_hashed_dir():
    """Each CUDA source builds into build/kernels under a content hash;
    the directory is git-ignored, so a checkout builds it itself."""
    for src in build.SOURCES:
        assert (build.CSRC / src).is_file()
        t = build._target(src)
        assert t.parent == build.BUILD_DIR and len(t.stem.split("-")[-1]) == 16
    assert "build/" in (build.BUILD_DIR.parents[1] / ".gitignore").read_text()
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)


def test_kernel_build_without_nvcc_raises(monkeypatch):
    """No fallback when the toolkit is missing: the build raises."""
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(build.Path, "is_file", lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc_path()
