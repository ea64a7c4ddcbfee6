"""Atomic checkpoints with keep-k GC and resume (counterpart of
``repro.checkpoint.store``, on the reference's on-disk layout).

Layout:  <dir>/step_000123/
            manifest.json        - step, leaf paths, shapes, dtypes, extra
            <flat-leaf-path>.npy - one file per leaf ('/' -> '__')

The paths are the reference's (``common/pytree.py``), bf16 leaves are
stored as their uint16 bits (numpy has no bf16) with dtype "bfloat16"
in the manifest, so each package restores the other's checkpoints.  A
checkpoint is written into ``step_X.tmp-<nonce>`` and promoted with one
``rename``: readers never see a partial checkpoint, and a crash leaves
only a tmp dir that a later save sweeps.  ``latest_step`` ignores tmp
dirs and dirs without a manifest.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import uuid
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.common.pytree import map_with_path, tree_map, tree_paths


def _safe(path: str) -> str:
    return path.replace("/", "__")


def _host(leaf: Any) -> np.ndarray:
    """A leaf as a numpy array (bf16 as its uint16 bits), a copy."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    arr = np.array(leaf, copy=True)
    return arr.view(np.uint16) if arr.dtype.name == "bfloat16" else arr


def _dtype_name(leaf: Any) -> str:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return "bfloat16"
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


def save(ckpt_dir: str | Path, step: int, tree: Any, *, keep: int = 3,
         extra: Optional[Dict[str, Any]] = None) -> Path:
    """Write one checkpoint atomically; GC old ones (keep-k)."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:09d}"
    tmp = ckpt_dir / f"step_{step:09d}.tmp-{uuid.uuid4().hex[:8]}"
    tmp.mkdir(parents=True)
    manifest: Dict[str, Any] = {"step": step, "leaves": {},
                                "extra": extra or {}}
    for path, leaf in tree_paths(tree):
        arr = _host(leaf)
        fn = _safe(path) + ".npy"
        np.save(tmp / fn, arr)
        manifest["leaves"][path] = {"file": fn, "shape": list(arr.shape),
                                    "dtype": _dtype_name(leaf)}
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic promotion
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: Path, keep: int) -> None:
    steps = sorted(d for d in ckpt_dir.iterdir()
                   if d.is_dir() and d.name.startswith("step_")
                   and ".tmp-" not in d.name)
    for d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(d, ignore_errors=True)
    for d in ckpt_dir.iterdir():               # sweep stale tmp dirs
        if ".tmp-" in d.name and time.time() - d.stat().st_mtime > 60:
            shutil.rmtree(d, ignore_errors=True)


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(d.name.split("_")[1]) for d in ckpt_dir.iterdir()
             if d.is_dir() and d.name.startswith("step_")
             and ".tmp-" not in d.name and (d / "manifest.json").exists()]
    return max(steps) if steps else None


def restore(ckpt_dir: str | Path, tree_like: Any, *,
            step: Optional[int] = None) -> Any:
    """Load a checkpoint into the structure of ``tree_like`` (the newest
    complete one unless ``step`` is given): each leaf in its saved dtype,
    on the device of ``tree_like``'s leaf (the CPU where that is no
    tensor).  Raises KeyError for a leaf the checkpoint lacks."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:09d}"
    manifest = json.loads((d / "manifest.json").read_text())

    def load(path: str, leaf):
        meta = manifest["leaves"].get(path)
        if meta is None:
            raise KeyError(f"checkpoint {d} missing leaf {path}")
        arr = np.load(d / meta["file"])
        t = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
             if meta["dtype"] == "bfloat16" else torch.from_numpy(arr))
        return t.to(leaf.device if isinstance(leaf, torch.Tensor) else "cpu")

    return map_with_path(load, tree_like)


def manifest_extra(ckpt_dir: str | Path, step: Optional[int] = None) -> Dict:
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
    d = ckpt_dir / f"step_{step:09d}"
    return json.loads((d / "manifest.json").read_text()).get("extra", {})


class AsyncCheckpointer:
    """Snapshot to host memory, then write on a background thread:
    checkpoint I/O off the training critical path.  The snapshot is a
    copy of every leaf (on the CPU a tensor's ``cpu()`` is the tensor
    itself, which the next in-place optimizer step would rewrite under
    the writer).  ``wait()`` before exit; it raises what the writer
    raised."""

    def __init__(self, ckpt_dir: str | Path, keep: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save(self, step: int, tree: Any,
             extra: Optional[Dict[str, Any]] = None) -> None:
        self.wait()
        host_tree = tree_map(
            lambda l: l.detach().to("cpu", copy=True)
            if isinstance(l, torch.Tensor) else np.array(l, copy=True), tree)

        def run():
            try:
                save(self.ckpt_dir, step, host_tree, keep=self.keep,
                     extra=extra)
            except BaseException as e:          # surfaced by wait()
                self.last_error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err
