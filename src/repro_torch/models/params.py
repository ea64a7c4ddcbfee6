"""Parameter specs: the shape, dtype and initial values of every leaf of a
parameter tree (no JAX counterpart; the reference draws its leaves
inside each ``*_init``).

``init_pt`` and ``init_lm`` draw their trees from these specs, and
``weights.from_jax_params`` checks a tree carried across from the
reference against them.  A spec is a nest of dicts and tuples whose
leaves are :class:`Leaf`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch


@dataclass(frozen=True)
class Leaf:
    """One parameter leaf.

    ``std`` set: drawn normal * std, in the model dtype (or in fp32 with
    ``fp32=True``).  ``std`` None: an fp32 constant, ``fill(shape)`` or
    zeros (norm scales, biases)."""

    shape: Tuple[int, ...]
    std: Optional[float] = None
    fp32: bool = False
    fill: Optional[Callable[[Tuple[int, ...]], torch.Tensor]] = None

    def dtype(self, model_dtype: torch.dtype) -> torch.dtype:
        if self.std is None or self.fp32:
            return torch.float32
        return model_dtype

    def stacked(self, lead: Tuple[int, ...]) -> "Leaf":
        """The same leaf with stacking dims ``lead`` in front."""
        return dataclasses.replace(self, shape=tuple(lead) + tuple(self.shape))

    def make(self, generator: torch.Generator, model_dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
        if self.std is None:
            if self.fill is None:
                return torch.zeros(self.shape, dtype=torch.float32,
                                   device=device)
            return self.fill(self.shape).to(device, torch.float32)
        t = torch.randn(self.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return t.mul_(self.std).to(self.dtype(model_dtype))


def map_leaves(fn: Callable[[Leaf], Any], spec: Any) -> Any:
    """Apply ``fn`` to every leaf of a spec, keeping its nesting."""
    if isinstance(spec, dict):
        return {k: map_leaves(fn, v) for k, v in spec.items()}
    if isinstance(spec, tuple):
        return tuple(map_leaves(fn, v) for v in spec)
    if isinstance(spec, Leaf):
        return fn(spec)
    raise TypeError(f"not a parameter spec: {spec!r}")


def stack(spec: Any, lead: Tuple[int, ...]) -> Any:
    return map_leaves(lambda leaf: leaf.stacked(lead), spec)


def make_params(spec: Any, generator: torch.Generator,
                model_dtype: torch.dtype, device: torch.device) -> Any:
    """Draw every leaf, in the spec's order, from ``generator`` (which
    must live on ``device``)."""
    return map_leaves(lambda leaf: leaf.make(generator, model_dtype, device),
                      spec)
