"""Public kernel wrappers and their launch counts.

Each wrapper launches its hand-written kernel for CUDA tensors (raising
if it cannot) and runs its plain PyTorch version for CPU tensors.  Each
keeps ``launches``, a plain int it bumps only where it launched the
kernel, so a run can show which kernels its path went through.  The
int8 branch of each decode kernel counts apart from its fp branch, and
``int8_matmul.routes``, ``flash_attention.routes`` and
``rmsnorm.routes`` count the W8A16, the flash and the RMSNorm launches
by route (``add_rmsnorm`` and ``fuse_rmsnorm`` are RMSNorm routes: they
count under ``rmsnorm``).

A CUDA graph's replay runs no Python, so no wrapper counts it: the
graph records the change of ``counters()`` over its capture, puts the
counters back as they were (``set_counters``), and adds that change at
every replay (``add_counters``), so the counts stay the launches the
device ran (``launch.steps.StepGraph``).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_int8,
                                                  paged_decode_attention,
                                                  paged_decode_attention_int8)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.quant_matmul import int8_matmul
from repro_torch.kernels.rmsnorm import add_rmsnorm, fuse_rmsnorm, rmsnorm
from repro_torch.kernels.ssm_scan import ssm_scan

KERNELS = {"paged_decode_attention": paged_decode_attention,
           "flash_attention": flash_attention,
           "rmsnorm": rmsnorm,
           "paged_decode_attention_int8": paged_decode_attention_int8,
           "int8_matmul": int8_matmul,
           "ssm_scan": ssm_scan,
           "decode_attention": decode_attention,
           "decode_attention_int8": decode_attention_int8}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


_ROUTED = ("int8_matmul", "flash_attention", "rmsnorm")


def counters() -> Dict[str, int]:
    """Every launch count (under the kernel's name) and every route count
    (under ``name/route``), flat."""
    out = launch_counts()
    for name in _ROUTED:
        out.update({f"{name}/{r}": n
                    for r, n in KERNELS[name].routes.items()})
    return out


def set_counters(values: Dict[str, int]) -> None:
    """Set the counts named in ``values`` (keys as ``counters()``)."""
    for key, n in values.items():
        name, _, route = key.partition("/")
        if route:
            KERNELS[name].routes[route] = n
        else:
            KERNELS[name].launches = n


def add_counters(delta: Dict[str, int]) -> None:
    """Add ``delta`` (keys as ``counters()``) to the counts."""
    now = counters()
    set_counters({k: now[k] + n for k, n in delta.items()})


def reset_launch_counts() -> None:
    """Every launch count to 0, and the route counts of ``int8_matmul``,
    ``flash_attention`` and ``rmsnorm`` too."""
    set_counters(dict.fromkeys(counters(), 0))
