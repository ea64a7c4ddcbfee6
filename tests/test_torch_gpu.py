"""On the card: each hand-written kernel against its plain PyTorch version
(tolerance fp32 2e-5, bf16 2e-2, as tests/test_kernels.py), and the
launch counts the wrappers keep.  Imports no JAX, so it runs on a GPU
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
