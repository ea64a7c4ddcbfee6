"""Symmetric int8 quantization (counterpart of ``repro.common.quant``).

Two consumers on the serving path:

  * weights — ``quantize_params`` replaces the recognised projection
    matrices of a parameter tree with :class:`QuantTensor` leaves
    (per-output-channel scales over the contraction axes);
  * KV rows — ``quantize_rows`` gives the per-token-per-head (payload,
    scale) pair the int8 block pools store.

A ``QuantTensor`` keeps its fp32 scale at the SAME RANK as the int8
payload (keepdims over the quantized axes), so indexing the stacked
leading dims ([R, D, n, ...]) slices payload and scale together.

``matmul`` sends every int8 product through the W8A16 kernel
(``ops.int8_matmul``), which writes the activation dtype (the kernel
rounds acc * scale once in its epilogue: the bits the reference's cast
of the fp32 product gives).  Unlike the reference, which
dequantizes the attention projections in jnp, every projection here
takes the kernel (``PERF.md`` notes why).
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels import ops

QMAX = 127.0
_EPS = 1e-12          # zero-row guard: scale of an all-zero row is _EPS/127


class QuantTensor:
    """int8 payload + same-rank broadcastable fp32 scale."""

    __slots__ = ("payload", "scale")

    def __init__(self, payload: torch.Tensor, scale: torch.Tensor):
        if payload.dim() != scale.dim():
            raise ValueError(f"payload {tuple(payload.shape)} and scale "
                             f"{tuple(scale.shape)} differ in rank")
        self.payload = payload
        self.scale = scale

    @property
    def shape(self) -> torch.Size:
        return self.payload.shape

    def __getitem__(self, idx) -> "QuantTensor":
        """Index leading (never quantized) dims of payload and scale."""
        return QuantTensor(self.payload[idx], self.scale[idx])

    def __repr__(self) -> str:
        return (f"QuantTensor(payload={tuple(self.payload.shape)}, "
                f"scale={tuple(self.scale.shape)})")


def is_quantized(x: Any) -> bool:
    return isinstance(x, QuantTensor)


def _norm_axes(axes: Union[int, Sequence[int]], ndim: int) -> Tuple[int, ...]:
    if isinstance(axes, int):
        axes = (axes,)
    return tuple(sorted(a % ndim for a in axes))


def quantize(x: torch.Tensor, axes: Union[int, Sequence[int]] = -1
             ) -> QuantTensor:
    """Symmetric int8 with amax/127 scales over ``axes`` (keepdims,
    fp32); round half to even, as ``jnp.round``."""
    ax = _norm_axes(axes, x.dim())
    xf = x.float()
    amax = torch.clamp_min(torch.amax(xf.abs(), dim=ax, keepdim=True), _EPS)
    # a tensor divisor: CUDA turns division by a Python scalar into a
    # product with its reciprocal, which is 1 ulp off amax / 127 for some
    # amax; the card must quantize exactly as the CPU and the reference
    scale = amax / torch.full_like(amax, QMAX)
    q = torch.clamp(torch.round(xf / scale), -QMAX, QMAX)
    return QuantTensor(q.to(torch.int8), scale)


def dequantize(qt: QuantTensor, dtype: torch.dtype = torch.float32
               ) -> torch.Tensor:
    return (qt.payload.float() * qt.scale).to(dtype)


# ---------------------------------------------------------------------------
# KV-row quantization (per token per head, scale over head_dim)
# ---------------------------------------------------------------------------

def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., hd] float -> (int8 [..., hd], fp32 scale [..., 1])."""
    qt = quantize(x, axes=-1)
    return qt.payload, qt.scale


def dequantize_rows(payload: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (payload.float() * scale.float()).to(dtype)


# ---------------------------------------------------------------------------
# weight-tree quantization
# ---------------------------------------------------------------------------

# projection name -> contraction axes of the core (unstacked) shape;
# scales are per output channel (keepdims over these axes)
_AXES = {
    "wq": (-3,), "wk": (-3,), "wv": (-3,),    # [d, H|KH, hd]   @ d
    "wi_gate": (-2,), "wi_up": (-2,),         # [d, d_ff]       @ d
    "head": (-2,),                            # [d, V]          @ d
}
# 'wo' is two different matrices; the parent dict tells them apart
_WO_AXES = {"mixer": (-3, -2),                # [H, hd, d]      @ (H, hd)
            "mlp": (-2,)}                     # [d_ff, d]       @ d_ff


def weight_axes(name: str, parent: str) -> Optional[Tuple[int, ...]]:
    """Contraction axes of a named weight leaf, None when it stays fp."""
    if parent == "cross":       # enc-dec cross-attn: never served quantized
        return None
    if name == "wo":
        return _WO_AXES.get(parent)
    return _AXES.get(name)


def _quantize_leaf(w: torch.Tensor, axes: Tuple[int, ...]) -> QuantTensor:
    """``quantize`` one leading slice at a time when dim 0 is a stacking
    dim, so a stacked [R, D, n, ...] leaf never needs a full fp32 copy
    (the same numbers: the quantized axes never include dim 0)."""
    ax = _norm_axes(axes, w.dim())
    if 0 in ax or w.shape[0] == 1:
        return quantize(w, ax)
    payload = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    sshape = [1 if i in ax else s for i, s in enumerate(w.shape)]
    scale = torch.empty(sshape, dtype=torch.float32, device=w.device)
    for i in range(w.shape[0]):
        qt = quantize(w[i], tuple(a - 1 for a in ax))
        payload[i] = qt.payload
        scale[i] = qt.scale
    return QuantTensor(payload, scale)


def quantize_params(params: Any) -> Tuple[Any, int]:
    """Replace recognised projection weights with int8 QuantTensors.

    Embeddings, norms and every unrecognised leaf pass through in full
    precision.  Returns (tree, number of quantized leaves)."""
    n_q = [0]

    def walk(node, name, parent):
        if isinstance(node, dict):
            return {k: walk(v, k, name) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, name, parent) for v in node)
        ax = weight_axes(name, parent)
        if (ax is None or not isinstance(node, torch.Tensor)
                or not node.is_floating_point()
                or node.dim() < max(-a for a in ax)):
            return node
        n_q[0] += 1
        return _quantize_leaf(node, ax)

    return walk(params, "", ""), n_q[0]


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------

def as_matrix(w: Any, k: int) -> Any:
    """A track-stacked weight [n, ...] as the [n, k, N] matrix of a
    contraction over its first ``k`` elements after the track dim; a
    QuantTensor's per-output-column scale becomes [n, 1, N]."""
    n = w.shape[0]
    if isinstance(w, QuantTensor):
        return QuantTensor(w.payload.reshape(n, k, -1),
                           w.scale.reshape(n, 1, -1))
    return w.reshape(n, k, -1)


def matmul(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x [n, ..., K] @ w [n, K, N] -> [n, ..., N] in x's dtype: one
    batched product for all tracks.  An int8 ``w`` (QuantTensor with
    scale [n, 1, N]) goes through the W8A16 kernel."""
    n, K = x.shape[0], x.shape[-1]
    xm = x.reshape(n, -1, K)
    if isinstance(w, QuantTensor):
        out = ops.int8_matmul(xm.contiguous(), w.payload, w.scale,
                              out_dtype=x.dtype)
    else:
        out = torch.matmul(xm, w)
    return out.reshape(*x.shape[:-1], w.shape[-1])
