"""The data-parallel group of the training path, the data axis of the
reference's ``launch/mesh.py``.

``make_data_group(device)`` returns the ``torch.distributed`` group that
gradient compression reduces over:

* the initialised world, if there is one;
* else the world ``torchrun`` describes (``RANK``, ``WORLD_SIZE``,
  ``MASTER_ADDR``, ``MASTER_PORT`` in the environment);
* else a one-rank world on a ``FileStore`` in a temporary directory.

The backend follows the device: NCCL for a CUDA device, gloo for the CPU,
never one in place of the other (a world already up with the other
backend raises). The reference's ``model`` axis (tensor parallelism) is
not ported: a mesh spec with a second axis raises (ROADMAP A9).
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from typing import Tuple

import torch
import torch.distributed as dist

NOT_PORTED = "not ported yet (ROADMAP A9: parallel/ and the model axis)"


def backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def parse_mesh(spec: str, world: int) -> Tuple[int]:
    """A ``--mesh`` spec as the data axis' size: "" means the whole world;
    "N" must equal it; "DxM" (a model axis) raises NotImplementedError."""
    if not spec:
        return (world,)
    shape = tuple(int(x) for x in spec.split("x"))
    if len(shape) > 1:
        raise NotImplementedError(f"mesh {spec!r} has a model axis: {NOT_PORTED}")
    if shape[0] != world:
        raise ValueError(f"mesh {spec!r} asks for {shape[0]} data ranks; the world has {world}")
    return shape


def make_data_group(device: torch.device):
    """The data-parallel process group for ``device`` (see the module doc)."""
    backend = backend_for(device)
    if dist.is_initialized():
        have = dist.get_backend()
        if have != backend:
            raise RuntimeError(
                f"the process group is up with backend {have!r}; {device} needs {backend!r}")
        return dist.group.WORLD
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(backend, init_method="env://")
        atexit.register(_shut_down, None)
        return dist.group.WORLD
    path = tempfile.mkdtemp(prefix="repro_torch_group_")
    store = dist.FileStore(os.path.join(path, "store"), 1)
    dist.init_process_group(backend, store=store, rank=0, world_size=1)
    atexit.register(_shut_down, path)
    return dist.group.WORLD


def _shut_down(store_dir) -> None:
    """At exit: the group first, then its store. NCCL's watchdog polls the
    store until the group is destroyed; with the store gone first it waits
    out its timeout (minutes) before the process can end."""
    if dist.is_initialized():
        dist.destroy_process_group()
    if store_dir is not None:
        shutil.rmtree(store_dir, ignore_errors=True)
