"""On the card: each hand-written kernel against its plain PyTorch version
(tolerance fp32 2e-5, bf16 2e-2, as tests/test_kernels.py; the W8A16
matmul in fp32 1e-4, for its long fp32 sums; the scan as the reference's
sweep), the launch counts the wrappers keep, and int8 quantization
bitwise equal to the CPU's.  The W8A16 matmul also on each route (the
wgmma + TMA prefill route at pt-6b-d4's five prefill products and ragged
M, N and K, the shapes TMA cannot take, the fp32 decode-row route at
the LM head), with bf16 output bitwise the fp32 output's cast, bitwise
repeatable, one device kernel per call.  The split-KV decode kernels
also at rows of no, one, one split's and one split + 1 live tokens, one
split and many, the vector and the scalar path, bitwise repeatable with
their ticket counters back at zero, one device kernel per call, and
bitwise equal across every sweep bound from 64 to the capacity that
covers the same live tokens (the split size follows the capacity).  The
sampler's threefry keys and bits on the card bitwise the CPU's.  Flash
prefill on each route (wgmma + TMA for bf16 at hd 64 / 128, the CUDA
cores otherwise) at the serve layouts and ragged S, Sq != Sk, an
unaligned view, bitwise repeatable, one device kernel per call.  RMSNorm
on each route (``norm``, ``add_norm``, ``fuse_norm``; a fused row
broadcast to the tracks among the inputs), bitwise repeatable; a track
rank's ``fuse_norm`` (no delta, k < n scale rows) bitwise the full
launch's rows, and a rank's decode launches (``plan_scale`` W, W 2 and
4) bitwise the same tracks' rows of the full launch, and pt-6b-d4 at
full width (8 layers) on 2 and 4 track ranks of the one card bitwise one
process.  The contiguous decode
kernel at the speculative drafter's shapes, and a reduced speculative
engine run, card against CPU.  The step programs' CUDA graphs (reduced
configs): a replayed decode or spec step bitwise equal to the eager step
(logits, packed result, cache bytes, launch counts), capture leaving
every live cache byte, and a decode launch that would grow the ticket
counters under capture raising.
Imports no JAX, so it runs on a GPU machine without it:

  PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

Without a GPU every test here skips (the kernels have no CPU mode)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops, ref

_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


def _sms(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _edge_lengths(lengths, sweep, base, page, sms):
    """Rows 0-3 (of batches of 5 or more) get no, one, exactly one
    split's and one split + 1 live tokens under the kernel's plan for
    the whole sweep; the rest stay ragged."""
    if len(lengths) >= 5:
        c = da.split_plan(sweep, base, page, sms)[1]
        lengths[:4] = np.minimum([0, 1, c, c + 1], sweep)
    return lengths


def _paged_inputs(n, B, KH, G, hd, bs, nmax, rng, sms=132):
    N = B * nmax + 3
    table = (rng.permutation(N - 1)[:B * nmax].reshape(B, nmax) + 1
             ).astype(np.int32)
    lengths = np.asarray([1 + (11 * i + 5) % (nmax * bs) for i in range(B)],
                         np.int32)
    lengths = _edge_lengths(lengths, nmax * bs, n * B * KH, bs, sms)
    return (rng.standard_normal((n, B, KH * G, hd)).astype(np.float32),
            rng.standard_normal((n, N, bs, KH, hd)).astype(np.float32),
            rng.standard_normal((n, N, bs, KH, hd)).astype(np.float32),
            table, lengths)


# (n, B, KH, G, hd, bs, nmax): the serve shapes' G 4 at hd 128 over many
# splits, G 2 at the reduced models' hd 8, G 2 at hd 64 (block 8), G 1 at
# hd 64, G 8 at hd 256 (the scalar path in fp32)
_PAGED_SHAPES = [(3, 4, 1, 4, 128, 16, 6), (4, 2, 1, 2, 8, 16, 3),
                 (2, 3, 2, 2, 64, 8, 5), (3, 6, 1, 4, 128, 16, 40),
                 (2, 5, 2, 1, 64, 8, 24), (1, 5, 1, 8, 256, 16, 12),
                 (4, 5, 1, 2, 8, 16, 30)]


def _paged_cuts(lengths, bs):
    """max_len: none, the longest row, one block (one split) and a cut
    inside the rows."""
    return (None, int(lengths.max()), 8, max(bs + 1, int(lengths.max()) // 2))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", _PAGED_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_kernel_matches_plain(shape, dtype):
    dev, tol = _cuda(), _TOL[dtype]
    rng = np.random.default_rng(0)
    q, kp, vp, table, lengths = _paged_inputs(*shape, rng, _sms(dev))
    cast = lambda a: torch.from_numpy(a).to(dev, _TDT[dtype])   # noqa: E731
    args = (cast(q), cast(kp), cast(vp), torch.from_numpy(table).to(dev),
            torch.from_numpy(lengths).to(dev))
    before = ops.launch_counts()["paged_decode_attention"]
    cuts = _paged_cuts(lengths, shape[5])
    for max_len in cuts:
        torch.testing.assert_close(
            ops.paged_decode_attention(*args, max_len=max_len),
            ref.paged_decode_attention_plain(*args, max_len=max_len),
            rtol=tol, atol=tol)
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_decode_attention"] == \
        before + len(cuts)


def _flash_inputs(dev, dtype, B, Sq, Sk, H, KH, hd, seed=1):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .to(dev, _TDT[dtype])
                 for s in ((B, Sq, H, hd), (B, Sk, KH, hd), (B, Sk, KH, hd)))


def _flash_routed(q, k, v, **kw):
    """One call, and the route the launch was counted under."""
    from repro_torch.kernels import flash_attention as fa
    before = dict(fa.flash_attention.routes)
    out = ops.flash_attention(q, k, v, **kw)
    moved = [r for r in fa.ROUTES if fa.flash_attention.routes[r] != before[r]]
    assert len(moved) == 1, moved
    return out, moved[0]


# (B, S, H, KH, hd): the reduced shapes, then the serve layouts at small B
# (pt-6b-d4: H / KH 4 / 1, dense-6b: 32 / 8, both hd 128; 4 / 1 at hd 64)
# at S below one tile, ragged, one tile, one past it, two tiles and more
_FLASH_SHAPES = [(3, 100, 4, 1, 64), (2, 64, 2, 2, 8), (1, 130, 4, 2, 128),
                 (2, 200, 4, 1, 128), (2, 16, 4, 1, 128), (2, 128, 4, 1, 128),
                 (2, 513, 4, 1, 128), (1, 512, 32, 8, 128),
                 (1, 100, 32, 8, 128), (1, 130, 32, 8, 128),
                 (2, 16, 4, 1, 64), (2, 200, 4, 1, 64), (1, 513, 4, 1, 64),
                 (2, 512, 4, 1, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KH,hd", _FLASH_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_matches_plain(B, S, H, KH, hd, dtype):
    """Causal, full and softcapped, each on the route ``route`` names:
    bf16 at hd 64 / 128 on wgmma_tma, the rest on the CUDA cores."""
    from repro_torch.kernels import flash_attention as fa
    dev, tol = _cuda(), _TOL[dtype]
    q, k, v = _flash_inputs(dev, dtype, B, S, S, H, KH, hd)
    want_route = fa.route(_TDT[dtype], hd, True)
    fast = dtype == "bfloat16" and hd in (64, 128)
    assert want_route == ("wgmma_tma" if fast else "cuda_core")
    before = ops.launch_counts()["flash_attention"]
    for causal, softcap in ((True, None), (False, None), (True, 5.0)):
        out, r = _flash_routed(q, k, v, causal=causal, softcap=softcap)
        assert r == want_route
        torch.testing.assert_close(
            out, ref.flash_attention_plain(q, k, v, causal=causal,
                                           softcap=softcap),
            rtol=tol, atol=tol)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 3


@pytest.mark.gpu
@pytest.mark.parametrize("Sq,Sk,hd", [(100, 300, 128), (300, 100, 128),
                                      (16, 513, 64), (130, 7, 128)])
@pytest.mark.parametrize("softcap", [None, 5.0])
def test_flash_attention_wgmma_route_takes_sq_unlike_sk(Sq, Sk, hd, softcap):
    """Full attention with Sq != Sk on the wgmma route (Sk below one key
    tile too), and causal at Sq != Sk (row i sees columns j <= i)."""
    dev = _cuda()
    q, k, v = _flash_inputs(dev, "bfloat16", 2, Sq, Sk, 8, 2, hd, seed=3)
    for causal in (False, True):
        out, r = _flash_routed(q, k, v, causal=causal, softcap=softcap)
        assert r == "wgmma_tma"
        torch.testing.assert_close(
            out, ref.flash_attention_plain(q, k, v, causal=causal,
                                           softcap=softcap),
            rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_flash_attention_unaligned_view_takes_the_cuda_core_route(which):
    """A bf16 operand one element into its storage (2-byte aligned) rules
    out TMA: the CUDA-core route runs, named by ``flash_attention.routes``."""
    dev = _cuda()
    q, k, v = _flash_inputs(dev, "bfloat16", 2, 200, 200, 4, 1, 128, seed=4)
    args = {"q": q, "k": k, "v": v}
    t = args[which]
    args[which] = torch.cat([t.new_zeros(1), t.reshape(-1)])[1:].view(t.shape)
    assert args[which].data_ptr() % 16
    out, r = _flash_routed(args["q"], args["k"], args["v"], causal=True)
    assert r == "cuda_core"
    torch.testing.assert_close(out, ref.flash_attention_plain(
        args["q"], args["k"], args["v"], causal=True), rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
def test_flash_attention_wgmma_route_is_bitwise_repeatable():
    """Two calls on the same inputs give the same bits (each output tile
    is one block's, summed in a fixed order), with another shape between."""
    dev = _cuda()
    q, k, v = _flash_inputs(dev, "bfloat16", 8, 512, 512, 32, 8, 128, seed=5)
    first = ops.flash_attention(q, k, v, causal=True)
    other = _flash_inputs(dev, "bfloat16", 2, 100, 100, 4, 1, 64, seed=6)
    ops.flash_attention(*other, causal=False, softcap=5.0)
    second = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["norm", "add_norm", "fuse_norm"])
@pytest.mark.parametrize("shape,per_track,bcast", [
    ((8, 2, 5, 1408), True, False), ((7, 32), False, False),
    ((8, 8, 1, 1408), True, True), ((4, 3, 4096), False, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel_matches_plain(route, shape, per_track, bcast, dtype):
    """Each route of csrc/rmsnorm.cu against its plain version: per-track
    and shared scale rows, x a fused row broadcast to every track (stride
    0), d 32 / 1408 / 4096; bitwise repeatable, one launch counted under
    ``rmsnorm`` and its route."""
    from repro_torch.kernels import rmsnorm as rn
    dev, tol = _cuda(), _TOL[dtype]
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal(
        shape[1:] if bcast else shape).astype(np.float32) * 3
    ).to(dev, _TDT[dtype])
    x = x[None].expand(shape) if bcast else x
    delta = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                             ).to(dev, _TDT[dtype])
    s = torch.from_numpy(rng.standard_normal(
        (shape[0], shape[-1]) if per_track else (shape[-1],)
    ).astype(np.float32) * 0.2).to(dev)
    call = {"norm": lambda: (ops.rmsnorm(x, s),),
            "add_norm": lambda: ops.add_rmsnorm(x, delta, s),
            "fuse_norm": lambda: ops.fuse_rmsnorm(x, delta, s)}[route]
    want = {"norm": lambda: (ref.rmsnorm_plain(x, s),),
            "add_norm": lambda: ref.add_rmsnorm_plain(x, delta, s),
            "fuse_norm": lambda: ref.fuse_rmsnorm_plain(x, delta, s)}[route]
    before = (ops.launch_counts()["rmsnorm"], rn.rmsnorm.routes[route])
    got = call()
    for g, w in zip(got, want()):
        assert g.shape == w.shape and g.is_contiguous()
        torch.testing.assert_close(g, w, rtol=tol, atol=tol)
    torch.cuda.synchronize()
    assert (ops.launch_counts()["rmsnorm"], rn.rmsnorm.routes[route]) == \
        (before[0] + 1, before[1] + 1)
    for g, again in zip(got, call()):
        assert torch.equal(g, again)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,bcast", [((8, 8, 1, 1408), False),
                                         ((8, 2, 5, 1408), True),
                                         ((4, 7, 32), False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fuse_norm_of_a_ranks_gathered_rows_is_bitwise_the_full_launch(
        shape, bcast, dtype):
    """A track rank's boundary (core/track.py ``_boundary``): x + delta
    added first (PyTorch, in x's dtype), the ``fuse_norm`` route with no
    delta under k < n scale rows gives f and the k rows of y bitwise as
    the route with delta under all n rows does; each against its plain
    version; one launch each."""
    from repro_torch.kernels import rmsnorm as rn
    dev, tol = _cuda(), _TOL[dtype]
    rng = np.random.default_rng(4)
    n = shape[0]
    x = torch.from_numpy(rng.standard_normal(
        shape[1:] if bcast else shape).astype(np.float32) * 3
    ).to(dev, _TDT[dtype])
    x = x[None].expand(shape) if bcast else x
    delta = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                             ).to(dev, _TDT[dtype])
    s = torch.from_numpy(rng.standard_normal((n, shape[-1])).astype(
        np.float32) * 0.2).to(dev)
    f, y = ops.fuse_rmsnorm(x, delta, s)
    gathered = x + delta
    for a, b in ((0, n // 2), (n // 2, n), (1, 2)):
        before = rn.rmsnorm.routes["fuse_norm"]
        fr, yr = ops.fuse_rmsnorm(gathered, None, s[a:b].contiguous())
        assert rn.rmsnorm.routes["fuse_norm"] == before + 1
        assert yr.shape == (b - a,) + tuple(shape[1:])
        assert torch.equal(fr, f) and torch.equal(yr, y[a:b])
        pf, py = ref.fuse_rmsnorm_plain(gathered, None, s[a:b])
        torch.testing.assert_close(fr, pf, rtol=tol, atol=tol)
        torch.testing.assert_close(yr, py, rtol=tol, atol=tol)
    fl, yl = ops.fuse_rmsnorm(gathered, None, s[0])      # the final norm
    assert torch.equal(fl, f) and yl.shape == tuple(shape[1:])


@pytest.mark.gpu
@pytest.mark.parametrize("n,M,K,N", [(2, 8, 1408, 520), (3, 8, 37, 100),
                                     (1, 70, 200, 136), (2, 33, 72, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_matmul_kernel_matches_plain(n, M, K, N, dtype):
    """Decode (M <= 16) and prefill tiles, N and K off the 64-wide
    tiles, and K / N that rule out the 16-byte loads (37, 100)."""
    from repro_torch.common.quant import quantize
    # fp32: sums of up to 1408 products of |x q| ~ 50 taken in another
    # order than cuBLAS's differ by ~1e-4 after the scale
    dev, tol = _cuda(), {"float32": 1e-4, "bfloat16": 2e-2}[dtype]
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((n, M, K)).astype(np.float32)
                         ).to(dev, _TDT[dtype])
    qt = quantize(torch.from_numpy(
        rng.standard_normal((n, K, N)).astype(np.float32)).to(dev), axes=-2)
    before = ops.launch_counts()["int8_matmul"]
    out = ops.int8_matmul(x, qt.payload, qt.scale)
    assert out.dtype == torch.float32
    torch.testing.assert_close(
        out, ref.int8_matmul_plain(x, qt.payload, qt.scale),
        rtol=tol, atol=tol)
    torch.cuda.synchronize()
    assert ops.launch_counts()["int8_matmul"] == before + 1


def _int8_operands(dev, n, M, K, N, dtype, seed):
    """x [n, M, K] and a quantized weight whose rows and columns all
    differ (a wrong operand layout or descriptor shows as a mismatch)."""
    from repro_torch.common.quant import quantize
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, M, K)).astype(np.float32)
                         ).to(dev, _TDT[dtype])
    qt = quantize(torch.from_numpy(
        rng.standard_normal((n, K, N)).astype(np.float32)).to(dev), axes=-2)
    return x, qt.payload, qt.scale


def _routed(x, w, s, out_dtype=torch.float32):
    """One call, and the route its launch was counted under."""
    from repro_torch.kernels import quant_matmul as qm
    before = dict(qm.int8_matmul.routes)
    out = ops.int8_matmul(x, w, s, out_dtype=out_dtype)
    torch.cuda.synchronize()
    moved = [r for r, c in qm.int8_matmul.routes.items() if c != before[r]]
    assert len(moved) == 1 and \
        qm.int8_matmul.routes[moved[0]] == before[moved[0]] + 1, moved
    return out, moved[0]


# pt-6b-d4's five prefill products (K, N) at M = 8 prompts x 512 rows; the
# same with M off the 256-row tile; N off the 128-column tile; K off the
# 64-deep stage, and with an odd stage count (the kernel adds a stage of
# zeros past K)
_PREFILL = [(4096, 1408, 512), (4096, 1408, 128), (4096, 512, 1408),
            (4096, 1408, 3968), (4096, 3968, 1408), (130, 1408, 3968),
            (4000, 3968, 1408), (130, 512, 144), (4000, 3968, 144),
            (17, 72, 16), (300, 136, 272), (257, 8, 48)]


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", _PREFILL)
def test_int8_matmul_wgmma_route_matches_plain(M, K, N):
    """The wgmma + TMA route at the prefill shapes and ragged edges: fp32
    out within bf16's 2e-2 of the plain version, bf16 out bitwise the
    fp32 output's cast, a second call bitwise the first."""
    dev = _cuda()
    x, w, s = _int8_operands(dev, 8, M, K, N, "bfloat16", M + K + N)
    out, r = _routed(x, w, s)
    assert r == "wgmma_tma" and out.dtype == torch.float32
    torch.testing.assert_close(out, ref.int8_matmul_plain(x, w, s),
                               rtol=2e-2, atol=2e-2)
    out16, r16 = _routed(x, w, s, torch.bfloat16)
    assert r16 == "wgmma_tma" and out16.dtype == torch.bfloat16
    assert torch.equal(out16, out.to(torch.bfloat16))
    assert torch.equal(_routed(x, w, s)[0], out)


@pytest.mark.gpu
@pytest.mark.parametrize("K,N,offset,want", [(1404, 512, 0, "mma_m64"),
                                             (1408, 136, 0, "mma_m64"),
                                             (1408, 520, 0, "mma_m64"),
                                             (1408, 512, 1, "mma_m64")])
def test_int8_matmul_prefill_shapes_tma_cannot_take(K, N, offset, want):
    """K % 8, N % 16 and a base off 16 bytes rule out TMA: the
    register-staged route runs, named by ``int8_matmul.routes``."""
    dev = _cuda()
    x, w, s = _int8_operands(dev, 2, 300, K, N, "bfloat16", 5)
    if offset:          # x one element into its storage: 2-byte aligned
        x = torch.cat([x.new_zeros(1), x.reshape(-1)])[offset:].view(x.shape)
        assert x.data_ptr() % 16
    out, r = _routed(x, w, s)
    assert r == want
    torch.testing.assert_close(out, ref.int8_matmul_plain(x, w, s),
                               rtol=2e-2, atol=2e-2)
    out16, _ = _routed(x, w, s, torch.bfloat16)
    assert torch.equal(out16, out.to(torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("n,M,K,N", [(1, 8, 1408, 100352), (2, 13, 200, 1040),
                                     (1, 3, 4096, 64)])
def test_int8_matmul_fp32_rows_route_matches_plain(n, M, K, N):
    """fp32 x at the decode rows (the int8 LM head at M = 8, and 16-row
    and ragged-K cases) on the streaming route, at 1e-4."""
    dev = _cuda()
    x, w, s = _int8_operands(dev, n, M, K, N, "float32", 7)
    out, r = _routed(x, w, s)
    assert r == "fma_rows"
    torch.testing.assert_close(out, ref.int8_matmul_plain(x, w, s),
                               rtol=1e-4, atol=1e-4)
    out16, _ = _routed(x, w, s, torch.bfloat16)
    assert torch.equal(out16, out.to(torch.bfloat16))
    assert torch.equal(_routed(x, w, s)[0], out)


@pytest.mark.gpu
def test_int8_matmul_decode_route_bitwise():
    """The bf16 decode route (x [8, 8, 1408] @ [8, 1408, 3968]): two calls
    bitwise equal, bf16 out bitwise the fp32 output's cast."""
    dev = _cuda()
    x, w, s = _int8_operands(dev, 8, 8, 1408, 3968, "bfloat16", 9)
    out, r = _routed(x, w, s)
    assert r == "mma_m16"
    torch.testing.assert_close(out, ref.int8_matmul_plain(x, w, s),
                               rtol=2e-2, atol=2e-2)
    assert torch.equal(_routed(x, w, s)[0], out)
    assert torch.equal(_routed(x, w, s, torch.bfloat16)[0],
                       out.to(torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("n,M,K,N,dtype", [(8, 4096, 1408, 3968, "bfloat16"),
                                           (8, 8, 1408, 3968, "bfloat16"),
                                           (1, 8, 1408, 100352, "float32")])
def test_int8_matmul_launches_one_device_kernel_per_call(n, M, K, N, dtype):
    """bf16 out is written by the kernel itself: the profiler sees one
    device kernel per call, no cast or copy after it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    dev = _cuda()
    x, w, s = _int8_operands(dev, n, M, K, N, dtype, 11)
    ops.int8_matmul(x, w, s, out_dtype=torch.bfloat16)      # build: warm
    torch.cuda.synchronize()
    for _ in range(3):          # a window the tracer returned empty is retaken
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            ops.int8_matmul(x, w, s, out_dtype=torch.bfloat16)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if names:
            break
    assert len(names) == 1 and "int8_matmul" in names[0], names


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KH", [(64, 512, 4, 1), (8, 512, 32, 8)])
def test_flash_attention_launches_one_device_kernel_per_call(B, S, H, KH):
    """At the serve shapes (pt-6b-d4, dense-6b) the profiler sees one
    device kernel per call (no memset, copy or cast), on the wgmma route.
    It stays after the W8A16 one-kernel tests: placed with the other
    flash tests, so that the process's first profiler session was this
    one, it left the later profiler sessions of a whole-file run without
    device events (cause unknown: every profiler test passes alone and
    all of them pass together)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    dev = _cuda()
    q, k, v = _flash_inputs(dev, "bfloat16", B, S, S, H, KH, 128, seed=7)
    ops.flash_attention(q, k, v)                 # build, attributes: warm
    torch.cuda.synchronize()
    for _ in range(3):          # a window the tracer returned empty is retaken
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, r = _flash_routed(q, k, v)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if names:
            break
    assert r == "wgmma_tma"
    assert len(names) == 1 and "flash_attention_wgmma" in names[0], names


@pytest.mark.gpu
@pytest.mark.parametrize("shape", _PAGED_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_paged_decode_kernel_matches_plain(shape, dtype):
    """int8 pools with their fp32 scale pools, ragged lengths over a
    shuffled table, with and without a ``max_len`` cut (hd 8 int8 rows
    take the scalar path)."""
    from repro_torch.common.quant import quantize_rows
    dev, tol = _cuda(), _TOL[dtype]
    rng = np.random.default_rng(4)
    q, kp, vp, table, lengths = _paged_inputs(*shape, rng, _sms(dev))
    (k8, ks), (v8, vs) = (quantize_rows(torch.from_numpy(a).to(dev))
                          for a in (kp, vp))
    args = (torch.from_numpy(q).to(dev, _TDT[dtype]), k8, v8,
            torch.from_numpy(table).to(dev), torch.from_numpy(lengths).to(dev))
    before = ops.launch_counts()
    cuts = _paged_cuts(lengths, shape[5])
    for max_len in cuts:
        torch.testing.assert_close(
            ops.paged_decode_attention(*args, max_len=max_len, k_scale=ks,
                                       v_scale=vs),
            ref.paged_decode_attention_plain(*args, max_len=max_len,
                                             k_scale=ks, v_scale=vs),
            rtol=tol, atol=tol)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["paged_decode_attention_int8"] == \
        before["paged_decode_attention_int8"] + len(cuts)
    assert after["paged_decode_attention"] == before["paged_decode_attention"]


@pytest.mark.gpu
def test_quantize_on_the_card_matches_the_cpu_bitwise():
    """int8 weights and KV rows quantize to the same payloads and scales
    on the card as on the CPU (and so as the reference)."""
    from repro_torch.common.quant import quantize
    dev = _cuda()
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (4000, 64)).astype(np.float32) * 3)
    for axes in (-1, -2):
        a, b = quantize(x.to(dev), axes), quantize(x, axes)
        assert torch.equal(a.payload.cpu(), b.payload)
        assert torch.equal(a.scale.cpu(), b.scale)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,di,ds", [(2, 64, 32, 4), (3, 37, 48, 16),
                                       (2, 128, 64, 1), (1, 5, 7, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_scan_kernel_matches_plain(B, S, di, ds, dtype):
    """The reference sweep's shapes, a ragged S, d_state 1 and an odd
    feature count (the scalar path), nonzero h0; tolerances as the
    reference sweep (fp32 1e-4, bf16 inputs 5e-2)."""
    dev = _cuda()
    tol = 1e-4 if dtype == "float32" else 5e-2
    rng = np.random.default_rng(6)
    a = torch.from_numpy(1 / (1 + np.exp(-rng.standard_normal(
        (B, S, di, ds)))).astype(np.float32)).to(dev, _TDT[dtype])
    b = torch.from_numpy(rng.standard_normal((B, S, di, ds)).astype(
        np.float32)).to(dev, _TDT[dtype])
    h0 = torch.from_numpy(rng.standard_normal((B, di, ds)).astype(
        np.float32)).to(dev)
    before = ops.launch_counts()["ssm_scan"]
    h, hl = ops.ssm_scan(a, b, h0)
    want, want_last = ref.ssm_scan_plain(a, b, h0)
    assert h.dtype == hl.dtype == torch.float32
    torch.testing.assert_close(h, want, rtol=tol, atol=tol)
    torch.testing.assert_close(hl, want_last, rtol=tol, atol=tol)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssm_scan"] == before + 1


def _dense_inputs(B, S, KH, G, hd, rng, sms=132):
    lengths = np.asarray([1 + (13 * i + 7) % S for i in range(B)], np.int32)
    lengths = _edge_lengths(lengths, S, B * KH, None, sms)
    return (rng.standard_normal((B, KH * G, hd)).astype(np.float32),
            rng.standard_normal((B, S, KH, hd)).astype(np.float32),
            rng.standard_normal((B, S, KH, hd)).astype(np.float32), lengths)


# (B, S, KH, G, hd): G 4 at hd 128 (dense-6b), G 1 with an S no tile
# divides, G 8, hd 256; then many splits at G 4 / hd 128, G 1 / hd 64,
# G 8 / hd 8
_DENSE_SHAPES = [(3, 72, 2, 4, 128), (5, 37, 1, 1, 64), (2, 100, 2, 8, 16),
                 (2, 40, 1, 2, 256), (6, 700, 2, 4, 128), (5, 300, 1, 1, 64),
                 (5, 260, 1, 8, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", _DENSE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_contiguous_decode_kernel_matches_plain(shape, dtype):
    """The contiguous-cache decode kernel against its plain version, with
    no cut, a cut at the longest row and cuts shorter than some rows (in
    tiles of 16 and of 512 columns)."""
    dev, tol = _cuda(), _TOL[dtype]
    rng = np.random.default_rng(7)
    q, k, v, lengths = _dense_inputs(*shape, rng, _sms(dev))
    cast = lambda a: torch.from_numpy(a).to(dev, _TDT[dtype])   # noqa: E731
    args = (cast(q), cast(k), cast(v), torch.from_numpy(lengths).to(dev))
    before = ops.launch_counts()
    cuts = ((512, None), (16, int(lengths.max())), (16, 9), (512, 3),
            (16, max(17, int(lengths.max()) // 2)))
    for block_s, max_len in cuts:
        torch.testing.assert_close(
            ops.decode_attention(*args, block_s=block_s, max_len=max_len),
            ref.decode_attention_plain(*args, block_s=block_s,
                                       max_len=max_len),
            rtol=tol, atol=tol)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["decode_attention"] == before["decode_attention"] + len(cuts)
    assert after["paged_decode_attention"] == before["paged_decode_attention"]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", _DENSE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_contiguous_decode_kernel_matches_plain(shape, dtype):
    """int8 caches with their fp32 per-token-per-head scales."""
    from repro_torch.common.quant import quantize_rows
    dev, tol = _cuda(), _TOL[dtype]
    rng = np.random.default_rng(8)
    q, k, v, lengths = _dense_inputs(*shape, rng, _sms(dev))
    (k8, ks), (v8, vs) = (quantize_rows(torch.from_numpy(a).to(dev))
                          for a in (k, v))
    args = (torch.from_numpy(q).to(dev, _TDT[dtype]), k8, v8,
            torch.from_numpy(lengths).to(dev))
    before = ops.launch_counts()
    cuts = (None, int(lengths.max()), 9, max(17, int(lengths.max()) // 2))
    for max_len in cuts:
        torch.testing.assert_close(
            ops.decode_attention(*args, block_s=16, max_len=max_len,
                                 k_scale=ks, v_scale=vs),
            ref.decode_attention_plain(*args, block_s=16, max_len=max_len,
                                       k_scale=ks, v_scale=vs),
            rtol=tol, atol=tol)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["decode_attention_int8"] == \
        before["decode_attention_int8"] + len(cuts)
    assert after["decode_attention"] == before["decode_attention"]


def _decode_calls(dev, dtype, int8):
    """A multi-split call of each layout (the serve shapes' G 4, hd 128),
    and a call of another shape (one split, other counters)."""
    from repro_torch.common.quant import quantize_rows
    rng = np.random.default_rng(10)
    t = lambda a: torch.from_numpy(a).to(dev)            # noqa: E731
    q, kp, vp, table, lengths = _paged_inputs(3, 6, 1, 4, 128, 16, 40, rng,
                                              _sms(dev))
    dq, dk, dv, dl = _dense_inputs(6, 700, 2, 4, 128, rng, _sms(dev))
    if int8:
        (kp, kps), (vp, vps) = (quantize_rows(t(a)) for a in (kp, vp))
        (dk, dks), (dv, dvs) = (quantize_rows(t(a)) for a in (dk, dv))
    else:
        kp, vp, dk, dv = (t(a).to(_TDT[dtype]) for a in (kp, vp, dk, dv))
        kps = vps = dks = dvs = None
    paged = (t(q).to(_TDT[dtype]), kp, vp, t(table), t(lengths))
    dense = (t(dq).to(_TDT[dtype]), dk, dv, t(dl))
    return [lambda: ops.paged_decode_attention(*paged, k_scale=kps,
                                               v_scale=vps),
            lambda: ops.decode_attention(*dense, k_scale=dks, v_scale=dvs),
            lambda: ops.paged_decode_attention(*paged, max_len=8,
                                               k_scale=kps, v_scale=vps)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,int8", [("float32", False),
                                        ("bfloat16", False),
                                        ("bfloat16", True)])
def test_decode_kernels_are_bitwise_repeatable(dtype, int8):
    """Two calls on the same inputs give the same bits (the splits merge
    in split order, no float atomics), with calls of another shape in
    between; every launch leaves the ticket counters at zero."""
    dev = _cuda()
    paged, dense, short = _decode_calls(dev, dtype, int8)
    assert da.split_plan(16 * 40, 3 * 6, 16, _sms(dev))[0] > 1
    first = (paged(), dense())
    short()
    second = (dense(), paged())
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[1])
    assert torch.equal(first[1], second[0])
    assert not da._COUNTERS[dev].any()


# (layout, capacity, base shape): pt-6b-d4's paged cache (8 tracks x 8
# slots, G 4, hd 128, block 16) at the serve capacities; dense-6b's
# contiguous one (8 slots x 8 KV heads); the drafter's (32 rows, G 4 on 1
# KV head)
_SWEEP_CASES = [("paged", 592), ("paged", 1104), ("contiguous", 1096),
                ("drafter", 584)]


@pytest.mark.gpu
@pytest.mark.parametrize("layout,capacity", _SWEEP_CASES)
@pytest.mark.parametrize("many", [False, True], ids=["one_split",
                                                     "many_splits"])
@pytest.mark.parametrize("int8", [False, True])
def test_decode_kernels_bitwise_across_sweeps(layout, capacity, many, int8):
    """The split size follows the cache's capacity, so every sweep bound
    from 64 to the capacity that covers the same live tokens gives the
    same bits: rows whose live tokens fit in one split (the bound one
    split or many: the one-split path against the merge of a live split
    with empty ones) and rows spread over several splits (more empty
    splits after the same boundaries)."""
    from repro_torch.common.quant import quantize_rows
    if int8 and layout == "drafter":
        pytest.skip("the drafter's cache is bf16")
    dev = _cuda()
    rng = np.random.default_rng(capacity + many)
    t = lambda a: torch.from_numpy(a).to(dev)            # noqa: E731
    bf = torch.bfloat16
    if layout == "paged":
        n, B, KH, G, bs = 8, 8, 1, 4, 16
        nmax = capacity // bs
        base = n * B * KH
    else:
        n, B, KH, G, bs = 1, (8 if layout == "contiguous" else 32), \
            (8 if layout == "contiguous" else 1), 4, None
        base = B * KH
    c = da.split_plan(capacity, base, bs, _sms(dev), capacity)[1]
    assert c < capacity                      # more than one split at full
    top = (3 * c) if many else c
    lengths = rng.integers(max(1, top // 2), min(top, capacity) + 1,
                           B).astype(np.int32)
    hd = 128
    if layout == "paged":
        N = B * nmax + 1
        table = (rng.permutation(N - 1)[:B * nmax].reshape(B, nmax) + 1
                 ).astype(np.int32)
        q = t(rng.standard_normal((n, B, KH * G, hd)).astype(np.float32))
        shape = (n, N, bs, KH, hd)
    else:
        q = t(rng.standard_normal((B, KH * G, hd)).astype(np.float32))
        shape = (B, capacity, KH, hd)
    k, v = (t(rng.standard_normal(shape).astype(np.float32))
            for _ in range(2))
    if int8:
        (k, ks), (v, vs) = quantize_rows(k), quantize_rows(v)
    else:
        k, v, ks, vs = k.to(bf), v.to(bf), None, None
    q, lens = q.to(bf), t(lengths)

    def call(max_len):
        if layout == "paged":
            return ops.paged_decode_attention(q, k, v, t(table), lens,
                                              max_len=max_len, k_scale=ks,
                                              v_scale=vs)
        return ops.decode_attention(q, k, v, lens, max_len=max_len,
                                    k_scale=ks, v_scale=vs)

    sweeps = sorted({m for m in (64, 128, 256, 512, 1024, capacity)
                     if int(lengths.max()) <= m <= capacity})
    outs = [call(m) for m in sweeps]
    plans = [da.split_plan(da._sweep_blocks(nmax, bs, m) * bs if bs else
                           da._sweep_cols(capacity, 512, m), base, bs,
                           _sms(dev), capacity) for m in sweeps]
    torch.cuda.synchronize()
    assert len({p[1] for p in plans}) == 1 and len(sweeps) >= 2
    assert plans[-1][0] > 1                  # the widest sweep: many splits
    if not many and layout == "paged":
        assert plans[0][0] == 1              # the one-split path too
    for m, o in zip(sweeps[1:], outs[1:]):
        assert torch.equal(o, outs[0]), (m, (o.float() - outs[0].float())
                                         .abs().max().item())
    want = (ref.paged_decode_attention_plain(q, k, v, t(table), lens,
                                             k_scale=ks, v_scale=vs)
            if layout == "paged" else
            ref.decode_attention_plain(q, k, v, lens, k_scale=ks,
                                       v_scale=vs))
    torch.testing.assert_close(outs[-1].float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
@pytest.mark.parametrize("int8", [False, True])
def test_decode_kernels_on_a_ranks_tracks_bitwise_the_full_launch(layout,
                                                                   int8):
    """A track rank of W (2, 4) launches the decode kernels over its n/W
    tracks with ``plan_scale`` W: its rows bitwise the same tracks' rows
    of the n-track launch, at pt-6b-d4's decode shape (8 tracks x 8
    slots, G 4 on 1 KV head, hd 128, capacity 592, the contiguous layout
    with the tracks folded into the rows), where a plan from the rank's
    own blocks would split otherwise."""
    from repro_torch.common.quant import quantize_rows
    dev = _cuda()
    rng = np.random.default_rng(int8)
    t = lambda a: torch.from_numpy(a).to(dev)            # noqa: E731
    n, B, KH, G, hd, bs, cap = 8, 8, 1, 4, 128, 16, 592
    nmax = cap // bs
    lengths = t(rng.integers(cap // 2, cap + 1, B).astype(np.int32))
    q = t(rng.standard_normal((n, B, KH * G, hd)).astype(np.float32))
    if layout == "paged":
        N = B * nmax + 1
        table = t((rng.permutation(N - 1)[:B * nmax].reshape(B, nmax) + 1
                   ).astype(np.int32))
        shape, page = (n, N, bs, KH, hd), bs
    else:
        shape, page = (n, B, cap, KH, hd), None
    k, v = (t(rng.standard_normal(shape).astype(np.float32))
            for _ in range(2))
    if int8:
        (k, ks), (v, vs) = quantize_rows(k), quantize_rows(v)
    else:
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
        ks = vs = None
    q = q.to(torch.bfloat16)

    def call(a, b, scale):
        """Tracks [a, b) in one launch; contiguous: folded into rows."""
        m = b - a

        def cut(x):
            if x is None:
                return None
            x = x[a:b].contiguous()
            return x if page else x.reshape(m * B, *x.shape[2:])

        if layout == "paged":
            return ops.paged_decode_attention(
                cut(q), cut(k), cut(v), table, lengths, k_scale=cut(ks),
                v_scale=cut(vs), plan_scale=scale)
        return ops.decode_attention(
            cut(q), cut(k), cut(v), lengths.repeat(m), k_scale=cut(ks),
            v_scale=cut(vs), plan_scale=scale).reshape(m, B, KH * G, hd)

    full = call(0, n, 1)
    plans = {W: da.split_plan(cap, n // W * B * KH, page, _sms(dev), cap)
             for W in (1, 2, 4)}
    assert plans[4] != plans[1], plans       # the rank's own plan differs
    for W in (2, 4):
        k_ = n // W
        for r in range(W):
            got = call(r * k_, (r + 1) * k_, W)
            assert torch.equal(got, full[r * k_:(r + 1) * k_]), (W, r)
    with pytest.raises(ValueError, match="plan_scale"):
        call(0, n // 2, 0)


@pytest.mark.gpu
def test_threefry_on_the_card_matches_the_cpu():
    """The sampler's threefry stream on the card: row_keys (seeds 0, 1,
    2**31 - 1, 2**32 - 1 by counters 0-300, every salt), random bits and
    uniforms of [8, 100352] draws bitwise the CPU port's; the Gumbel
    noise within 2 ulp of max(|g|, 1) (``log`` may differ in its last
    bit); a sampled ``sample_rows`` over the serve vocabulary."""
    from repro_torch.common import prng
    from repro_torch.serving import sampler
    dev = _cuda()
    seeds = torch.tensor([0, 1, 2 ** 31 - 1, 2 ** 32 - 1])
    cnt = torch.arange(301)
    s, c = seeds.repeat_interleave(301), cnt.repeat(4)
    for salt in (sampler.SALT_SAMPLE, sampler.SALT_ACCEPT,
                 sampler.SALT_DRAFT):
        assert torch.equal(sampler.row_keys(s.to(dev), c.to(dev), salt).cpu(),
                           sampler.row_keys(s, c, salt))
    keys = sampler.row_keys(torch.arange(8), torch.full((8,), 3), 0)
    V = 100352
    assert torch.equal(prng.random_bits(keys.to(dev), (V,)).cpu(),
                       prng.random_bits(keys, (V,)))
    assert torch.equal(prng.uniform(keys.to(dev), (V,)).cpu(),
                       prng.uniform(keys, (V,)))
    g, want = prng.gumbel(keys.to(dev), (V,)).cpu(), prng.gumbel(keys, (V,))
    ulp = torch.from_numpy(np.spacing(np.maximum(want.abs().numpy(), 1.0)
                                      .astype(np.float32)))
    assert ((g.double() - want.double()).abs() <= 2 * ulp).all()
    logits = torch.randn(8, V, generator=torch.Generator().manual_seed(0))
    par = (torch.full((8,), 0.8), torch.full((8,), 50, dtype=torch.int32),
           torch.full((8,), 0.95))
    got = sampler.sample_rows(logits.to(dev), keys.to(dev),
                              *(x.to(dev) for x in par)).cpu()
    assert got.dtype == torch.int32 and ((got >= 0) & (got < V)).all()
    assert (got == sampler.sample_rows(logits, keys, *par)).sum() >= 7


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True])
def test_decode_kernels_launch_one_device_kernel_per_call(int8):
    """One launch per call, the combine inside it: the profiler sees one
    device kernel (and no memset or copy) for a multi-split call of
    each layout."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    dev = _cuda()
    for call in _decode_calls(dev, "bfloat16", int8)[:2]:
        call()                                 # counters, build: warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        assert len(names) == 1 and "decode_kernel" in names[0], names


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernels_take_unaligned_rows(dtype):
    """Caches whose base is not 16-byte aligned (views one element into
    a buffer) take the scalar path, in both layouts, and agree with the
    plain versions."""
    dev, tol = _cuda(), _TOL[dtype]
    rng = np.random.default_rng(11)

    def unaligned(a):
        buf = torch.empty(a.size + 1, dtype=_TDT[dtype], device=dev)
        x = buf[1:].view(a.shape)
        x.copy_(torch.from_numpy(a))
        assert x.data_ptr() % 16 and x.is_contiguous()
        return x

    q, kp, vp, table, lengths = _paged_inputs(3, 6, 1, 4, 128, 16, 40, rng,
                                              _sms(dev))
    args = (torch.from_numpy(q).to(dev, _TDT[dtype]), unaligned(kp),
            unaligned(vp), torch.from_numpy(table).to(dev),
            torch.from_numpy(lengths).to(dev))
    assert da._vector_rows(128, *args[1:3]) == 0
    torch.testing.assert_close(ops.paged_decode_attention(*args),
                               ref.paged_decode_attention_plain(*args),
                               rtol=tol, atol=tol)
    q, k, v, lengths = _dense_inputs(6, 700, 2, 4, 128, rng, _sms(dev))
    args = (torch.from_numpy(q).to(dev, _TDT[dtype]), unaligned(k),
            unaligned(v), torch.from_numpy(lengths).to(dev))
    torch.testing.assert_close(ops.decode_attention(*args),
                               ref.decode_attention_plain(*args),
                               rtol=tol, atol=tol)


@pytest.mark.gpu
def test_contiguous_model_decode_on_card_matches_cpu():
    """The reduced dense model's contiguous decode step (the kernel in
    every layer, a frozen lane) on the card against the CPU, fp32: the
    logits of the active lanes and the whole cache after the step."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import decoder
    dev, cpu = _cuda(), torch.device("cpu")
    cfg = reduced_config("dense-6b")
    params = decoder.init_lm(torch.Generator().manual_seed(0), cfg, cpu)
    rng = np.random.default_rng(9)
    init = [torch.from_numpy(rng.standard_normal(tuple(leaf.shape))
                             .astype(np.float32))
            for leaf in _leaves(decoder.init_cache(cfg, 3, 24, device=cpu))]
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(3,)))
    pos = torch.tensor([5, 0, 17], dtype=torch.int32)
    act = torch.tensor([True, False, True])
    out = {}
    for d in (cpu, dev):
        cache = decoder.init_cache(cfg, 3, 24, device=d)
        for leaf, x in zip(_leaves(cache), init):
            leaf.copy_(x)
        before = ops.launch_counts()["decode_attention"]
        logits, cache = decoder.lm_decode_step(
            _tree_to(params, d), cache, toks.to(d), pos.to(d), cfg,
            active=act.to(d), kv_max_len=24)
        out[d] = (logits[act.to(d)].cpu(),
                  [leaf.cpu() for leaf in _leaves(cache)])
        if d == dev:
            torch.cuda.synchronize()
            assert ops.launch_counts()["decode_attention"] == \
                before + cfg.n_layers
    torch.testing.assert_close(out[dev][0], out[cpu][0], rtol=1e-4, atol=1e-4)
    for a, b in zip(out[dev][1], out[cpu][1]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_at_the_drafters_shapes(dtype):
    """The contiguous decode kernel as the speculative drafter calls it at
    pt-6b-d4: its d = 4 tracks of 8 slots folded into 32 rows, 4 query
    heads on 1 KV head, hd 128, 584 cache columns; rows at the K + 1 draft
    positions of a 512-token prompt, and rows whose length runs past the
    cache (a draft position at or past S, whose write is dropped), under
    the engine's power-of-two cuts."""
    dev, tol = _cuda(), _TOL[dtype]
    rng = np.random.default_rng(11)
    B, S, KH, G, hd = 32, 584, 1, 4, 128
    q = rng.standard_normal((B, KH * G, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, KH, hd)).astype(np.float32)
            for _ in range(2))
    lengths = np.asarray([513 + i % 5 for i in range(B)], np.int32)
    lengths[-3:] = [S, S + 1, S + 4]
    cast = lambda a: torch.from_numpy(a).to(dev, _TDT[dtype])   # noqa: E731
    args = (cast(q), cast(k), cast(v), torch.from_numpy(lengths).to(dev))
    before = ops.launch_counts()["decode_attention"]
    cuts = (None, 512, S, 1024)
    for max_len in cuts:
        torch.testing.assert_close(
            ops.decode_attention(*args, max_len=max_len),
            ref.decode_attention_plain(*args, max_len=max_len),
            rtol=tol, atol=tol)
    torch.cuda.synchronize()
    assert ops.launch_counts()["decode_attention"] == before + len(cuts)


@pytest.mark.gpu
def test_speculative_engine_on_card_matches_cpu():
    """The reduced PT model in fp32 with speculate_k=3, draft_tracks=2:
    greedy streams on the card equal the CPU's and plain decode's, with
    one host transfer per step, the drafter's decode kernel launched
    once per layer in each of the K + 1 draft steps of every engine step,
    and no paged decode launch (the verify is the chunk program)."""
    from repro_torch.configs import reduced_config
    from repro_torch.core.track import init_pt
    from repro_torch.serving.engine import Engine
    dev, cpu = _cuda(), torch.device("cpu")
    cfg = reduced_config("pt-6b-d4")
    params = init_pt(torch.Generator().manual_seed(0), cfg, cpu)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(1, cfg.vocab_size, size=(L,)).tolist()
               for L in (9, 16, 5)]
    kw = dict(max_slots=2, max_seq_len=48)
    plain = Engine(cfg, params, device=cpu, **kw).generate(prompts, 8)
    out = {}
    for d in (cpu, dev):
        eng = Engine(cfg, _tree_to(params, d), device=d, speculate_k=3,
                     draft_tracks=2, **kw)
        before = ops.launch_counts()
        out[d] = eng.generate(prompts, 8)
        assert eng.runner.decode_transfers == eng.steps_run
        if d == dev:
            torch.cuda.synchronize()
            after = ops.launch_counts()
            spec_steps = eng.metrics.summary()["spec_steps"]
            assert after["decode_attention"] - before["decode_attention"] \
                == cfg.n_layers * 4 * eng.steps_run >= cfg.n_layers * 4 \
                * spec_steps > 0
            assert after["paged_decode_attention"] == \
                before["paged_decode_attention"]
    assert out[dev] == out[cpu] == plain


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tree_to(v, dev) for v in tree)
    return tree.to(dev)


# ---------------------------------------------------------------------------
# the pre-planned step programs: CUDA graphs against eager steps
# ---------------------------------------------------------------------------

# arm -> (arch, dtype, engine knobs), reduced configs; a "sampled" arm's
# requests sample (temperature 0.8, top-k 50, top-p 0.95), so its steps
# run the sampled programs
_PLAN_ARMS = {"paged bf16": ("pt-6b-d4", "bfloat16", {}),
              "paged bf16 sampled": ("pt-6b-d4", "bfloat16", {}),
              "int8 kv": ("pt-6b-d4", "bfloat16", {"kv_dtype": "int8"}),
              "contiguous": ("dense-6b", "bfloat16", {"paged": False}),
              "mamba state rows": ("falcon-mamba-7b", "bfloat16",
                                   {"prefill_chunk": 8}),
              "spec": ("pt-6b-d4", "float32",
                       {"speculate_k": 3, "draft_tracks": 2}),
              "spec sampled": ("pt-6b-d4", "float32",
                               {"speculate_k": 3, "draft_tracks": 2})}


def _plan_engine(arm, dev, preplan=True):
    from repro_torch.configs import reduced_config
    from repro_torch.launch.steps import model_fns
    from repro_torch.serving.engine import Engine
    arch, dtype, knobs = _PLAN_ARMS[arm]
    cfg = reduced_config(arch).replace(dtype=dtype)
    params = model_fns(cfg)["init"](
        torch.Generator(device=dev).manual_seed(0), cfg, dev)
    return Engine(cfg, params, max_slots=3, max_seq_len=64, block_size=8,
                  device=dev, preplan=preplan, **knobs)


def _decoding(eng, n=3, sampled=False):
    """n requests admitted and decoding (sampled ones with seeds 0..n-1),
    nothing in flight."""
    from repro_torch.serving.engine import RequestState
    from repro_torch.serving.sampler import SampleParams
    rng = np.random.default_rng(5)
    sp = SampleParams(0.8, 50, 0.95) if sampled else SampleParams()
    reqs = [eng.submit(rng.integers(1, eng.cfg.vocab_size,
                                    size=(7 + 9 * i,)).tolist(), 20,
                       params=sp, seed=i)
            for i in range(n)]
    while any(q.state is not RequestState.DECODE for q in reqs):
        eng.step()
    return reqs


def _cache_tensors(r):
    def walk(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                yield from walk(v)
        elif isinstance(tree, tuple):
            for v in tree:
                yield from walk(v)
        elif hasattr(tree, "pool"):
            yield from (t for t in (tree.pool, tree.scale) if t is not None)
        else:
            yield tree

    return list(walk(r.cache)) + (list(r.draft_cache["blocks"])
                                  if r.speculate_k else [])


@pytest.mark.gpu
@pytest.mark.parametrize("arm", list(_PLAN_ARMS))
def test_graph_replay_equals_the_eager_step_bitwise(arm):
    """One decode (spec) step replayed from its CUDA graph against the
    same step run eagerly from the same cache bytes: logits, packed
    result and every cache byte after it bitwise equal, and the replay
    adds the capture's launches to the counters."""
    dev = _cuda()
    eng = _plan_engine(arm, dev)
    r = eng.runner
    _decoding(eng, sampled=arm.endswith("sampled"))
    cache = _cache_tensors(r)
    saved = [t.clone() for t in cache]

    def step():
        kw = dict(seeds=eng._seeds, top_k=eng._topks, top_p=eng._topps)
        if r.speculate_k:
            h = r.dispatch_spec(eng._tok, eng._pos, eng._active, eng._temps,
                                eng._counts, **kw)
            out = r.wait_spec(h)
        else:
            h = r.dispatch_decode(eng._tok, eng._pos, eng._active,
                                  eng._temps, eng._eos, eng._remaining,
                                  eng._counts, **kw)
            out = r.wait_decode(h)
        return (h["logits"].clone(), [np.asarray(o).copy() for o in out],
                [t.clone() for t in cache], ops.launch_counts(), h["key"])

    programs, r.programs = r.programs, {}
    before = ops.launch_counts()
    eager = step()
    r.programs = programs
    for t, s in zip(cache, saved):
        t.copy_(s)
    hits = r.planned_hits
    replay = step()
    assert r.planned_hits == hits + 1
    assert replay[4] == eager[4] and replay[4][-1] == arm.endswith("sampled")
    assert torch.equal(eager[0], replay[0])
    assert all(np.array_equal(a, b) for a, b in zip(eager[1], replay[1]))
    assert all(torch.equal(a, b) for a, b in zip(eager[2], replay[2]))
    assert {k: replay[3][k] - eager[3][k] for k in before} == \
        {k: eager[3][k] - before[k] for k in before}


@pytest.mark.gpu
@pytest.mark.parametrize("arm", list(_PLAN_ARMS))
def test_capture_leaves_the_cache_unchanged(arm):
    """``plan_programs`` on an engine with requests decoding: warm-up and
    capture run every lane idle, so no byte of any live block, state row,
    contiguous row or drafter row changes (block 0, the trash block,
    takes the idle lanes' writes); the run then finishes."""
    dev = _cuda()
    eng = _plan_engine(arm, dev, preplan=False)
    r = eng.runner
    reqs = _decoding(eng)
    live = None
    if r.paged:
        live = torch.as_tensor(sorted(set(r.kv.table_np.ravel()) - {0}),
                               dtype=torch.long, device=dev)

    def snap():
        out = []
        for t in _cache_tensors(r):
            pooled = live is not None and t.dim() >= 4 and \
                t.shape[-4] == r.kv.num_blocks and t.shape[-3] == \
                r.kv.block_size
            out.append(t.index_select(t.dim() - 4, live).clone() if pooled
                       else t.clone())
        return out

    before = snap()
    assert r.plan_programs() == len(r.programs) > 0
    torch.cuda.synchronize()
    for a, b in zip(before, snap()):
        assert torch.equal(a, b)
    eng.run()
    assert all(len(q.output) == 20 for q in reqs)
    assert r.planned_hits > 0


@pytest.mark.gpu
def test_decode_launch_that_grows_the_counters_under_capture_raises(
        monkeypatch):
    """The ticket counters are sized before any capture: a launch that
    would grow them while a graph is being captured raises, and the
    buffer a graph may hold is never replaced."""
    dev = _cuda()
    small = torch.zeros(1, dtype=torch.int32, device=dev)
    monkeypatch.setitem(da._COUNTERS, dev, small)
    rng = np.random.default_rng(2)
    q, kp, vp, table, lengths = _paged_inputs(2, 4, 1, 4, 128, 16, 40, rng,
                                              _sms(dev))
    args = [torch.from_numpy(a).to(dev) for a in (q, kp, vp, table, lengths)]
    assert da.split_plan(40 * 16, 2 * 4, 16, _sms(dev))[0] > 1
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream(dev)
    with pytest.raises(RuntimeError, match="reserve_counters"):
        with torch.cuda.graph(graph, stream=stream):
            ops.paged_decode_attention(*args)
    assert da._COUNTERS[dev] is small
    grown = da.reserve_counters(dev, 8)
    assert grown.numel() >= 8 and any(t is small for t in da._RETIRED)


# ---------------------------------------------------------------------------
# track ranks on the one card
# ---------------------------------------------------------------------------

_RANK_PROMPT, _RANK_STEPS = 512, 4


def _rank_logits(par, device: str) -> np.ndarray:
    """pt-6b-d4 bf16 at full width, its depth cut to 8 layers (R = 2),
    from seed 0, on one track rank (``NO_PARALLEL``: one process): the
    prefill's last row and ``_RANK_STEPS`` greedy paged decode steps of
    8 prompts of 512 tokens (capacity 592, as ``chip_smoke.py`` phase
    5), [8, 1 + steps, V] fp32."""
    from repro_torch.configs import get_config
    from repro_torch.core import track
    from repro_torch.serving.cache import PagedKVCache
    dev = torch.device(device)
    torch.cuda.set_device(dev)
    cfg = get_config("pt-6b-d4").replace(n_layers=8)
    full = track.init_pt(torch.Generator(device=dev).manual_seed(0), cfg,
                         dev)
    p = track.shard_tracks(full, cfg, par)
    del full
    B, cap = 8, _RANK_PROMPT + 80
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (B, _RANK_PROMPT)), device=dev)
    kv = PagedKVCache(cfg, max_slots=B, max_seq_len=cap, block_size=16,
                      device=dev, par=par)
    slots = list(range(B))
    for s in slots:
        kv.allocate(s, cap)
    with torch.no_grad():
        logits, cache = track.pt_forward(p, {"inputs": prompts}, cfg,
                                         par=par)
        out = [logits[:, -1].float()]
        kv.insert_prefill(cache, slots, kv.table_rows(slots))
        del logits, cache
        pos = torch.full((B,), _RANK_PROMPT, dtype=torch.int32, device=dev)
        for i in range(_RANK_STEPS):
            lg, _ = track.pt_decode_step(p, kv.engine_cache(),
                                         out[-1].argmax(-1), pos + i, cfg,
                                         block_table=kv.table(), par=par)
            out.append(lg.float())
    return torch.stack(out, dim=1).cpu().numpy()


@pytest.mark.gpu
def test_track_ranks_on_the_card_are_bitwise_one_process():
    """pt-6b-d4 bf16 at full width on W = 2 and W = 4 track ranks of the
    one card (gloo; 4 and 2 tracks a rank): every rank's prefill and
    decode logits bitwise one process's (the decode kernels plan their
    split for all 8 tracks on every rank)."""
    from repro_torch.runtime.parallel import NO_PARALLEL, spawn
    dev = _cuda()
    one = _rank_logits(NO_PARALLEL, str(dev))
    torch.cuda.empty_cache()
    for W in (2, 4):
        got = spawn(_rank_logits, W, (str(dev),), timeout=600.0)
        for r, g in enumerate(got):
            assert np.array_equal(g, one), (W, r, np.abs(g - one).max())
