"""Public kernel wrappers and their launch counts.

Each wrapper launches its hand-written kernel for CUDA tensors (raising
if it cannot) and runs its plain PyTorch version for CPU tensors.  Each
keeps ``launches``, a plain int it bumps only where it launched the
kernel, so a run can show which kernels its path went through.  The
int8 branch of each decode kernel counts apart from its fp branch, and
``int8_matmul.routes`` and ``flash_attention.routes`` count the W8A16
and the flash launches by route.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_int8,
                                                  paged_decode_attention,
                                                  paged_decode_attention_int8)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.quant_matmul import int8_matmul
from repro_torch.kernels.rmsnorm import rmsnorm
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


def reset_launch_counts() -> None:
    """Every launch count to 0, and the route counts of ``int8_matmul``
    and ``flash_attention`` too."""
    for fn in KERNELS.values():
        fn.launches = 0
    for fn in (int8_matmul, flash_attention):
        for r in fn.routes:
            fn.routes[r] = 0
