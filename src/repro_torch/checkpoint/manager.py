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
come back where they live; a meta or DTensor leaf of the template comes
back as a new host tensor instead, and ``reshard`` places such a host
tree on a mesh (the elastic re-mesh). Checkpoints written by the JAX
package use the reference's pytree paths and are not read here.

In a world of several ranks (``torch.distributed``) every rank calls
``save`` (a DTensor leaf is gathered whole, a collective), rank 0 writes,
and a synchronous save returns on every rank once the files are there.
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
import torch.distributed as dist

from repro_torch.parallel.context import is_dtensor

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
    if is_dtensor(t):
        t = t.full_tensor()
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


def _restore_into(template, flat: Dict[str, np.ndarray], prefix: str = ""):
    if isinstance(template, torch.nn.Module):
        _restore_into(template.state_dict(), flat, prefix)
        return template
    if isinstance(template, dict):
        return {k: _restore_into(v, flat, f"{prefix}{k}/") for k, v in template.items()}
    key, t = prefix[:-1], template
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{key}: a checkpoint leaf must be a tensor, got {type(t)}")
    if key + _BF16_SUFFIX in flat:
        arr = torch.from_numpy(flat[key + _BF16_SUFFIX].view(np.int16)).view(torch.bfloat16)
    elif key in flat:
        arr = torch.from_numpy(flat[key])
    else:
        raise KeyError(f"checkpoint missing array {key!r}")
    if tuple(arr.shape) != tuple(t.shape):
        raise ValueError(f"{key}: checkpoint shape {tuple(arr.shape)} != {tuple(t.shape)}")
    if t.is_meta or is_dtensor(t):
        return arr.to(t.dtype)
    with torch.no_grad():
        t.copy_(arr.to(t.dtype))
    return t


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _writes() -> bool:
    """Whether this rank writes the checkpoint files (rank 0 of the world)."""
    return not dist.is_initialized() or dist.get_rank() == 0


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
        flat = _flatten(state_tree)
        if _writes():
            self._write(step, flat, meta or {})
        if _world() > 1:
            dist.barrier()

    def save_async(self, step: int, state_tree, meta: Optional[Dict[str, Any]] = None):
        """Snapshot now (host copy), write on a worker thread."""
        self.wait()
        flat = _flatten(state_tree)  # the host copy, before returning
        meta = dict(meta or {})
        if not _writes():
            return

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
        """Checkpoint ``step`` in the template's structure: copied into its
        tensors in place, its meta and DTensor leaves as new host tensors
        (see the module doc)."""
        d = os.path.join(self.dir, f"step_{step:08d}")
        with np.load(os.path.join(d, "arrays_00000.npz")) as z:
            flat = {k: z[k] for k in z.files}
        return _restore_into(template, flat)

    def restore_latest(self, template):
        """(step, restored tree) of the newest checkpoint, or (None, None)."""
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, template)


def reshard(tree, shardings):
    """Place a host tree onto a mesh under new shardings (a tree of
    ``NamedSharding`` of the same structure): the elastic re-mesh, any
    checkpoint back on any compatible mesh. Every rank of the mesh calls
    it with the same values."""
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tree, dict):
        return {k: reshard(v, shardings[k]) for k, v in tree.items()}
    mesh = shardings.mesh
    return distribute_tensor(tree.to(mesh.device_type), mesh, shardings.placements)
