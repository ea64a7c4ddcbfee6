"""Optimizers (counterpart of ``repro.optim``): AdamW (+ fp32 master),
Adafactor, global-norm clipping, the warmup-cosine schedule.  The
gradient compression of ``repro.optim.compress``, which no train path
calls, is ROADMAP queue 1, item 9c."""
from repro_torch.optim.adafactor import adafactor_init, adafactor_update
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.common import (ADAFACTOR_THRESHOLD, clip_by_global_norm,
                                      make_optimizer, warmup_cosine)

__all__ = ["adafactor_init", "adafactor_update", "adamw_init",
           "adamw_update", "ADAFACTOR_THRESHOLD", "clip_by_global_norm",
           "make_optimizer", "warmup_cosine"]
