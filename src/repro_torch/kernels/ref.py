"""Plain PyTorch versions of every ported kernel (counterpart of
``repro.kernels.ref``): what the CPU path runs and what the kernels are
held against on the card.  ``paged_decode_attention_plain`` covers both
branches of paged decode (int8 pools with ``k_scale``/``v_scale``), and
``decode_attention_plain`` both branches of contiguous-cache decode;
``add_rmsnorm_plain`` and ``fuse_rmsnorm_plain`` are the RMSNorm
kernel's other two routes."""
from repro_torch.kernels.decode_attention import (decode_attention_plain,
                                                  paged_decode_attention_plain)
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.quant_matmul import int8_matmul_plain
from repro_torch.kernels.rmsnorm import (add_rmsnorm_plain,
                                         fuse_rmsnorm_plain, rmsnorm_plain)
from repro_torch.kernels.ssm_scan import ssm_scan_plain

__all__ = ["decode_attention_plain", "paged_decode_attention_plain",
           "flash_attention_plain", "rmsnorm_plain", "add_rmsnorm_plain",
           "fuse_rmsnorm_plain", "int8_matmul_plain", "ssm_scan_plain"]
