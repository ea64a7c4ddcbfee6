"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled by its own ``nvcc`` process into a
shared library with a plain C interface, loaded with ``ctypes``
(pointers and the stream are ``c_void_p``; each launch function returns
``cudaGetLastError()``, which the wrapper checks).  All sources build in
parallel at first use, into ``<repo>/build/kernels`` keyed by a hash of
the sources and flags, so a fresh checkout builds everything itself and
an unchanged tree reuses what is there.  Nothing here runs at import
time; there is no fallback when ``nvcc`` is missing or a build fails.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("paged_decode.cu", "flash_attention.cu", "int8_matmul.cu",
           "ssm_scan.cu", "rmsnorm.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class Built:
    """One loaded library and how it was obtained."""
    lib: ctypes.CDLL
    path: Path
    seconds: float        # compile wall time (0.0 when reused from disk)
    ptxas: List[str]      # the -Xptxas -v report, spills included (empty
                          # when reused)


_LOADED: Dict[str, Built] = {}


def nvcc_path() -> str:
    """``nvcc`` from PATH, else from ``$CUDA_HOME`` or the toolkit's
    default install prefix.  Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "csrc/ with nvcc at first use on a GPU machine")


def _digest(source: str) -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _target(source: str) -> Path:
    return BUILD_DIR / f"{Path(source).stem}-{_digest(source)}.so"


def build_all() -> Dict[str, Built]:
    """Build (in parallel) and load every kernel library not loaded yet.
    Returns the loaded libraries by source name."""
    todo = [s for s in SOURCES if s not in _LOADED]
    procs = {}
    started = {}
    for src in todo:
        out = _target(src)
        if out.is_file():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / src)]
        started[src] = time.perf_counter()
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    logs = {}
    failed = []
    for src, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[src] = (time.perf_counter() - started[src],
                     [ln for ln in log.splitlines() if ln.strip()])
        if proc.returncode != 0:
            failed.append(f"{src} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    for src in todo:
        seconds, log = logs.get(src, (0.0, []))
        path = _target(src)
        _LOADED[src] = Built(ctypes.CDLL(str(path)), path, seconds,
                             [ln for ln in log
                              if "ptxas" in ln or "spill" in ln])
    return dict(_LOADED)


def library(source: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<source>``."""
    if source not in _LOADED:
        build_all()
    return _LOADED[source].lib


def cuda_stream(tensor) -> ctypes.c_void_p:
    """The current PyTorch stream of ``tensor``'s device, for a launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(tensor.device).cuda_stream)


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
