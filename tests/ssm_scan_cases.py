"""The scan route's digest cases: the shapes ``tests/ssm_scan_digests.json``
records and ``tests/test_torch_gpu.py`` holds the kernel to, their seeded
inputs and the digest of an output.  ``tools/ssm_scan_ab.py`` imports
them from here to record the digests, so the tool and the test draw the
same inputs."""
from __future__ import annotations

import hashlib

import numpy as np
import torch

# each case: dtype and the shape of a and b, [B, S, features...]
CASES = [
    ("float32", (8, 2048, 4096)),          # recurrentgemma-9b prefill
    ("float32", (8, 512, 4096)),           # its chunk of 512
    ("float32", (8, 256, 8192, 16)),       # falcon-mamba's chunk
    ("float32", (3, 37, 8192, 1)),         # ragged S, d_state 1
    ("bfloat16", (2, 100, 512, 16)),
    ("bfloat16", (2, 100, 4096)),
    ("bfloat16", (3, 37, 48, 3)),
    ("bfloat16", (1, 333, 100)),           # bf16, F % 8 = 4
    ("float32", (2, 19, 33, 5)),           # the register path (F 165)
    ("bfloat16", (1, 5, 7, 3)),            # the register path, bf16
    ("float32", (2, 1, 4096)),             # one step
    ("float32", (1, 2049, 100)),           # F 100: a ragged feature tile
]
KEYS = ("dtype", "shape")
_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def case_inputs(case: dict, dev: torch.device):
    """(a, b, h0) of one case on ``dev``: numpy draws seeded by the
    case's shape (a uniform in [0.5, 1), b and h0 standard normal, all
    float32), a and b cast to the case's dtype on the card."""
    shape = tuple(case["shape"])
    rng = np.random.default_rng(list(shape))
    a = rng.uniform(0.5, 1.0, size=shape).astype(np.float32)
    b = rng.standard_normal(size=shape, dtype=np.float32)
    h0 = rng.standard_normal(size=(shape[0],) + shape[2:], dtype=np.float32)
    dt = _DT[case["dtype"]]
    return (torch.from_numpy(a).to(dev).to(dt),
            torch.from_numpy(b).to(dev).to(dt), torch.from_numpy(h0).to(dev))


def digest(t: torch.Tensor) -> str:
    """sha256 of a tensor's bytes."""
    b = t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes()
    return hashlib.sha256(b).hexdigest()
