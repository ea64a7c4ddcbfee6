"""PyTorch + CUDA port of the Parallel-Track serving stack (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its
module names (``configs``, ``core.track``, ``models.*``,
``serving.*``, ``launch.serve``) and imports nothing from it.  Entry
points run on CUDA unless the caller passes ``device="cpu"``; every
kernel wrapper in ``kernels`` launches a hand-written Hopper kernel on a
CUDA tensor and runs its plain PyTorch version on a CPU tensor.
"""
