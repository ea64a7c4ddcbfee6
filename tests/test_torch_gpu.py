"""On the card: each hand-written kernel against its plain PyTorch version
(tolerance fp32 2e-5, bf16 2e-2, as tests/test_kernels.py; the W8A16
matmul in fp32 1e-4, for its long fp32 sums; the scan as the reference's
sweep), the launch counts the wrappers keep, and int8 quantization
bitwise equal to the CPU's.  Imports no JAX, so it runs on a GPU
machine without it:

  PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

Without a GPU every test here skips (the kernels have no CPU mode)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


def _paged_inputs(n, B, KH, G, hd, bs, nmax, rng):
    N = B * nmax + 3
    table = (rng.permutation(N - 1)[:B * nmax].reshape(B, nmax) + 1
             ).astype(np.int32)
    lengths = np.asarray([1 + (11 * i + 5) % (nmax * bs) for i in range(B)],
                         np.int32)
    return (rng.standard_normal((n, B, KH * G, hd)).astype(np.float32),
            rng.standard_normal((n, N, bs, KH, hd)).astype(np.float32),
            rng.standard_normal((n, N, bs, KH, hd)).astype(np.float32),
            table, lengths)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(3, 4, 1, 4, 128, 16, 6),
                                   (4, 2, 1, 2, 8, 16, 3),
                                   (2, 3, 2, 2, 64, 8, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_kernel_matches_plain(shape, dtype):
    dev, tol = _cuda(), _TOL[dtype]
    rng = np.random.default_rng(0)
    q, kp, vp, table, lengths = _paged_inputs(*shape, rng)
    cast = lambda a: torch.from_numpy(a).to(dev, _TDT[dtype])   # noqa: E731
    args = (cast(q), cast(kp), cast(vp), torch.from_numpy(table).to(dev),
            torch.from_numpy(lengths).to(dev))
    before = ops.launch_counts()["paged_decode_attention"]
    for max_len in (None, int(lengths.max()), 8):
        torch.testing.assert_close(
            ops.paged_decode_attention(*args, max_len=max_len),
            ref.paged_decode_attention_plain(*args, max_len=max_len),
            rtol=tol, atol=tol)
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_decode_attention"] == before + 3


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KH,hd", [(3, 100, 4, 1, 64), (2, 64, 2, 2, 8),
                                         (1, 130, 4, 2, 128),
                                         (2, 200, 4, 1, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_matches_plain(B, S, H, KH, hd, dtype):
    dev, tol = _cuda(), _TOL[dtype]
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(dev, _TDT[dtype])
               for s in ((B, S, H, hd), (B, S, KH, hd), (B, S, KH, hd)))
    before = ops.launch_counts()["flash_attention"]
    for causal, softcap in ((True, None), (False, None), (True, 5.0)):
        torch.testing.assert_close(
            ops.flash_attention(q, k, v, causal=causal, softcap=softcap),
            ref.flash_attention_plain(q, k, v, causal=causal,
                                      softcap=softcap), rtol=tol, atol=tol)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 3


@pytest.mark.gpu
@pytest.mark.parametrize("shape,per_track", [((8, 2, 5, 1408), True),
                                             ((7, 32), False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel_matches_plain(shape, per_track, dtype):
    dev, tol = _cuda(), _TOL[dtype]
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 3
                         ).to(dev, _TDT[dtype])
    s = torch.from_numpy(rng.standard_normal(
        (shape[0], shape[-1]) if per_track else (shape[-1],)
    ).astype(np.float32) * 0.2).to(dev)
    before = ops.launch_counts()["rmsnorm"]
    torch.testing.assert_close(ops.rmsnorm(x, s), ref.rmsnorm_plain(x, s),
                               rtol=tol, atol=tol)
    torch.cuda.synchronize()
    assert ops.launch_counts()["rmsnorm"] == before + 1


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


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(3, 4, 1, 4, 128, 16, 6),
                                   (2, 3, 2, 2, 64, 8, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_paged_decode_kernel_matches_plain(shape, dtype):
    """int8 pools with their fp32 scale pools, ragged lengths over a
    shuffled table, with and without a ``max_len`` cut."""
    from repro_torch.common.quant import quantize_rows
    dev, tol = _cuda(), _TOL[dtype]
    rng = np.random.default_rng(4)
    q, kp, vp, table, lengths = _paged_inputs(*shape, rng)
    (k8, ks), (v8, vs) = (quantize_rows(torch.from_numpy(a).to(dev))
                          for a in (kp, vp))
    args = (torch.from_numpy(q).to(dev, _TDT[dtype]), k8, v8,
            torch.from_numpy(table).to(dev), torch.from_numpy(lengths).to(dev))
    before = ops.launch_counts()
    for max_len in (None, int(lengths.max()), 8):
        torch.testing.assert_close(
            ops.paged_decode_attention(*args, max_len=max_len, k_scale=ks,
                                       v_scale=vs),
            ref.paged_decode_attention_plain(*args, max_len=max_len,
                                             k_scale=ks, v_scale=vs),
            rtol=tol, atol=tol)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["paged_decode_attention_int8"] == \
        before["paged_decode_attention_int8"] + 3
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


def _dense_inputs(B, S, KH, G, hd, rng):
    lengths = np.asarray([1 + (13 * i + 7) % S for i in range(B)], np.int32)
    return (rng.standard_normal((B, KH * G, hd)).astype(np.float32),
            rng.standard_normal((B, S, KH, hd)).astype(np.float32),
            rng.standard_normal((B, S, KH, hd)).astype(np.float32), lengths)


# (B, S, KH, G, hd): G 4 at hd 128 (dense-6b), G 1 with an S no tile
# divides, G 8, hd 256
_DENSE_SHAPES = [(3, 72, 2, 4, 128), (5, 37, 1, 1, 64), (2, 100, 2, 8, 16),
                 (2, 40, 1, 2, 256)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", _DENSE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_contiguous_decode_kernel_matches_plain(shape, dtype):
    """The contiguous-cache decode kernel against its plain version, with
    no cut, a cut at the longest row and cuts shorter than some rows (in
    tiles of 16 and of 512 columns)."""
    dev, tol = _cuda(), _TOL[dtype]
    rng = np.random.default_rng(7)
    q, k, v, lengths = _dense_inputs(*shape, rng)
    cast = lambda a: torch.from_numpy(a).to(dev, _TDT[dtype])   # noqa: E731
    args = (cast(q), cast(k), cast(v), torch.from_numpy(lengths).to(dev))
    before = ops.launch_counts()
    cuts = ((512, None), (16, int(lengths.max())), (16, 9), (512, 3))
    for block_s, max_len in cuts:
        torch.testing.assert_close(
            ops.decode_attention(*args, block_s=block_s, max_len=max_len),
            ref.decode_attention_plain(*args, block_s=block_s,
                                       max_len=max_len),
            rtol=tol, atol=tol)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["decode_attention"] == before["decode_attention"] + 4
    assert after["paged_decode_attention"] == before["paged_decode_attention"]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", _DENSE_SHAPES[:3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_contiguous_decode_kernel_matches_plain(shape, dtype):
    """int8 caches with their fp32 per-token-per-head scales."""
    from repro_torch.common.quant import quantize_rows
    dev, tol = _cuda(), _TOL[dtype]
    rng = np.random.default_rng(8)
    q, k, v, lengths = _dense_inputs(*shape, rng)
    (k8, ks), (v8, vs) = (quantize_rows(torch.from_numpy(a).to(dev))
                          for a in (k, v))
    args = (torch.from_numpy(q).to(dev, _TDT[dtype]), k8, v8,
            torch.from_numpy(lengths).to(dev))
    before = ops.launch_counts()
    for max_len in (None, int(lengths.max()), 9):
        torch.testing.assert_close(
            ops.decode_attention(*args, block_s=16, max_len=max_len,
                                 k_scale=ks, v_scale=vs),
            ref.decode_attention_plain(*args, block_s=16, max_len=max_len,
                                       k_scale=ks, v_scale=vs),
            rtol=tol, atol=tol)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["decode_attention_int8"] == \
        before["decode_attention_int8"] + 3
    assert after["decode_attention"] == before["decode_attention"]


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
