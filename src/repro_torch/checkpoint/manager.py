"""Atomic, resumable checkpoints in numpy npz, the reference's
``checkpoint/manager.py`` with its on-disk format:

    <dir>/step_<N>.tmp/          (written first)
        arrays_00000.npz         (flattened path -> array)
        manifest.json            (step, time, array shapes and dtypes,
                                  pipeline state)
    <dir>/step_<N>/              (atomic rename when complete)

bf16 tensors are stored as ``uint16`` views under the key suffix
``__bf16`` (npz has no bfloat16) and re-viewed as ``torch.bfloat16`` on
restore, in torch (numpy has no bfloat16 and the card's machine has no
``ml_dtypes``). ``save_async`` copies the state to the host before it
returns and writes on a worker thread; ``wait()`` joins it. The last
``keep`` (default 3) checkpoints are kept.

A state is a nested dict whose leaves are tensors (or nn.Modules, read
through their ``state_dict()``); keys join with "/". ``restore`` copies
into the template's tensors in place, so a model and its optimizer state
come back where they live. Checkpoints written by the JAX package use the
reference's pytree paths and are not read here.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

_BF16_SUFFIX = "__bf16"


def _leaves(tree, prefix: str = ""):
    """(path, tensor) for every leaf, in the tree's order."""
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, torch.Tensor):
        yield prefix[:-1], tree
    else:
        raise TypeError(f"{prefix[:-1]}: a checkpoint leaf must be a tensor, got {type(tree)}")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy (never a view: the tensor keeps changing in place)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _flatten(tree) -> Dict[str, np.ndarray]:
    flat = {}
    for key, t in _leaves(tree):
        arr = _to_numpy(t)
        flat[key + _BF16_SUFFIX if t.dtype == torch.bfloat16 else key] = arr
    return flat


def _restore_into(template, flat: Dict[str, np.ndarray]):
    for key, t in _leaves(template):
        if key + _BF16_SUFFIX in flat:
            arr = torch.from_numpy(flat[key + _BF16_SUFFIX].view(np.int16)).view(torch.bfloat16)
        elif key in flat:
            arr = torch.from_numpy(flat[key])
        else:
            raise KeyError(f"checkpoint missing array {key!r}")
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(arr.shape)} != {tuple(t.shape)}")
        with torch.no_grad():
            t.copy_(arr.to(t.dtype))
    return template


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save --------------------------------------------------------------

    def _write(self, step: int, flat: Dict[str, np.ndarray], meta: Dict[str, Any]):
        tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
        final = os.path.join(self.dir, f"step_{step:08d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays_00000.npz"), **flat)
        manifest = {
            "step": step,
            "time": time.time(),
            "arrays": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                       for k, v in flat.items()},
            **meta,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def save(self, step: int, state_tree, meta: Optional[Dict[str, Any]] = None):
        """Synchronous save."""
        self.wait()
        self._write(step, _flatten(state_tree), meta or {})

    def save_async(self, step: int, state_tree, meta: Optional[Dict[str, Any]] = None):
        """Snapshot now (host copy), write on a worker thread."""
        self.wait()
        flat = _flatten(state_tree)  # the host copy, before returning
        meta = dict(meta or {})

        def work():
            try:
                self._write(step, flat, meta)
            except BaseException as e:  # noqa: BLE001 -- re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        for s in self.steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    # -- restore -----------------------------------------------------------

    def steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def manifest(self, step: int) -> Dict[str, Any]:
        with open(os.path.join(self.dir, f"step_{step:08d}", "manifest.json")) as f:
            return json.load(f)

    def restore(self, step: int, template):
        """Copy checkpoint ``step`` into the template's tensors, in place;
        returns the template."""
        d = os.path.join(self.dir, f"step_{step:08d}")
        with np.load(os.path.join(d, "arrays_00000.npz")) as z:
            flat = {k: z[k] for k in z.files}
        return _restore_into(template, flat)
