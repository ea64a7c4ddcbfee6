"""Device selection for the port's entry points.

``Engine``, ``ModelRunner``, ``init_pt`` and ``launch.serve`` run on the
GPU unless the caller asks for the CPU by name.  Without a GPU and
without an explicit device they raise: the port never carries on on the
CPU behind the caller's back.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike) -> torch.device:
    """``None`` means the current CUDA device; anything else is taken as
    given, with a bare 'cuda' pinned to the current device index.
    Raises when CUDA is asked for (explicitly or by default) and no GPU
    is visible."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; the port runs on the GPU by "
                "default — pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """``cfg.dtype`` string -> torch dtype."""
    try:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16}[name]
    except KeyError:
        raise ValueError(f"unsupported model dtype {name!r}") from None
