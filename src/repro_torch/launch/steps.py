"""Model-function dispatch of the serving path (counterpart of the
``model_fns`` table of ``repro.launch.steps``; its train and dry-run
step functions are ROADMAP queue 1, item 9).

A PT config (``cfg.pt`` set) serves through ``core.track``, every other
config through the dense ``lm_*`` decoder.  The entries take the same
arguments on both paths: a PT cache has no per-slot state rows, so
``active``, ``slots`` and ``chunk_lens`` change nothing there (in the
reference they are dead code for it too).  ``chunk_hidden`` (no
reference counterpart) is the chunk step without the LM head, which the
runner applies to each request's last real row only.  ``init_cache`` is
the contiguous cache of either path, the engine cache of
``Engine(paged=False)``: ``[R, D, n, B, S, KH, hd]`` K and V for a PT
model, the ``lm_*`` tree of per-layer rows otherwise.
"""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.common.types import ModelConfig
from repro_torch.core import track as pt_lib
from repro_torch.models import decoder as dec_lib


def model_fns(cfg: ModelConfig) -> Dict[str, Callable]:
    if cfg.pt is not None:
        return {"init": pt_lib.init_pt,
                "forward": pt_lib.pt_forward,
                "decode": pt_lib.pt_decode_step,
                "chunk": pt_lib.pt_chunk_step,
                "chunk_hidden": pt_lib.pt_chunk_hidden,
                "init_cache": pt_lib.pt_init_cache}
    return {"init": dec_lib.init_lm,
            "forward": dec_lib.lm_forward,
            "decode": dec_lib.lm_decode_step,
            "chunk": dec_lib.lm_chunk_step,
            "chunk_hidden": dec_lib.lm_chunk_hidden,
            "init_cache": dec_lib.init_cache}
