"""Fault-tolerant checkpointing: save/restore, async writer, keep-K
retention, atomic manifests, elastic restart (a checkpoint written under
one mesh restores under another: each leaf is saved whole and placed on
load).  The port of ``repro.train.checkpoint``, with its on-disk layout,
so either package restores the other's checkpoints.

Layout:
  <dir>/step_000123/
      manifest.json            {step, leaves: [{path, file, shape, dtype}],
                                complete}
      <md5(path)[:16]>.npy     one file per leaf
  <dir>/LATEST                 atomically-updated pointer

A leaf's path is its dict keys joined by ``/`` (``params/blocks/in_proj``,
``step``), leaves listed in JAX's flatten order.  bf16 is stored as
``uint16`` under the manifest dtype ``"bfloat16"`` (npy has no bf16): the
port reinterprets the bits through ``torch.int16``, so it needs no
``ml_dtypes``.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading

import numpy as np
import torch

from ..tree import leaves_with_path, unflatten_like


def _fname(path: str) -> str:
    return hashlib.md5(path.encode()).hexdigest()[:16] + ".npy"


def _to_host(t: torch.Tensor):
    """(numpy array to store, manifest dtype) of a tensor: a copy, so a
    later in-place update of ``t`` cannot reach the writer."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_write: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        self._thread = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save ----
    def save(self, step: int, state) -> None:
        """Copy every leaf to the host now; write the files on the writer
        thread (``async_write``) or before returning."""
        host = [(p, *_to_host(x)) for p, x in leaves_with_path(state)]
        if self.async_write:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._thread.start()
        else:
            self._write(step, host)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host_leaves) -> None:
        d = os.path.join(self.dir, f"step_{step:09d}")
        tmp = d + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "leaves": []}
        for path, arr, dt in host_leaves:
            np.save(os.path.join(tmp, _fname(path)), arr)
            manifest["leaves"].append(
                {"path": path, "file": _fname(path),
                 "shape": list(arr.shape), "dtype": dt})
        manifest["complete"] = True
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(d):
            shutil.rmtree(d)
        os.rename(tmp, d)                                  # atomic publish
        with open(os.path.join(self.dir, "LATEST.tmp"), "w") as f:
            f.write(os.path.basename(d))
        os.replace(os.path.join(self.dir, "LATEST.tmp"),
                   os.path.join(self.dir, "LATEST"))
        self._gc()

    def _gc(self):
        steps = sorted(x for x in os.listdir(self.dir) if x.startswith("step_"))
        for old in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, old), ignore_errors=True)

    # ---------------------------------------------------------- restore ----
    def latest_step(self):
        p = os.path.join(self.dir, "LATEST")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            name = f.read().strip()
        d = os.path.join(self.dir, name)
        if not os.path.exists(os.path.join(d, "manifest.json")):
            return None
        return int(name.split("_")[1])

    def restore(self, template, step=None, shardings=None):
        """(state, step): the checkpoint loaded into the structure of
        ``template``.  Each leaf goes to the device its sharding names
        (``shardings``: a tree of ``distributed.sharding.NamedSharding`` of
        the template's structure, e.g. from ``state_shardings`` under a new
        mesh: the elastic-restart path), or else to the template leaf's
        device."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError("no checkpoint found")
        d = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        if not manifest.get("complete"):
            raise ValueError(f"incomplete checkpoint {d}")
        by_path = {leaf["path"]: leaf for leaf in manifest["leaves"]}
        tmpl = leaves_with_path(template)
        sh = None if shardings is None else \
            [s for _, s in leaves_with_path(shardings)]
        out = []
        for i, (path, t) in enumerate(tmpl):
            meta = by_path[path]
            x = _from_host(np.load(os.path.join(d, meta["file"])), meta["dtype"])
            if tuple(x.shape) != tuple(t.shape):
                raise ValueError(f"{path}: shape {tuple(x.shape)} in the "
                                 f"checkpoint, {tuple(t.shape)} in the template")
            out.append(x.to(sh[i].device if sh is not None else t.device))
        return unflatten_like(template, out), step
