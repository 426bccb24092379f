"""Meshes and process groups, the reference's ``launch/mesh.py``.

Production target: 256 chips a pod. The single-pod mesh is (16, 16) over
("data", "model"); the 2-pod mesh adds a leading "pod" axis (batch shards
over ("pod", "data")). A mesh is a ``DeviceMesh`` over the world of
``torch.distributed`` ranks, one device a rank, row-major over the axes.

The world comes from, in order:

* the initialised world, if there is one;
* else the world ``torchrun`` describes (``RANK``, ``WORLD_SIZE``,
  ``MASTER_ADDR``, ``MASTER_PORT`` in the environment);
* else a one-rank world on a ``FileStore`` in a temporary directory.

The backend follows the device: NCCL for a CUDA device, gloo for the CPU,
never one in place of the other (a world already up with the other
backend raises). NCCL takes one rank a card, so one card holds a 1 x 1
mesh; meshes of several ranks run on the host over gloo, or on as many
cards.
"""

from __future__ import annotations

import atexit
import math
import os
import shutil
import tempfile
from typing import Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def parse_mesh(spec: str, world: int) -> Tuple[int, ...]:
    """A ``--mesh`` spec as the mesh's shape: "" means (world,); "N" must
    equal the world; "DxM" is (D, M), a data and a model axis, with
    D * M equal to the world."""
    if not spec:
        return (world,)
    shape = tuple(int(x) for x in spec.split("x"))
    if len(shape) > 2:
        raise ValueError(f"mesh {spec!r}: at most a data and a model axis")
    if math.prod(shape) != world:
        raise ValueError(f"mesh {spec!r} asks for {math.prod(shape)} ranks; "
                         f"the world has {world}")
    return shape


def init_world(device: torch.device) -> int:
    """Bring up the world for ``device`` (see the module doc); its size."""
    backend = backend_for(device)
    if dist.is_initialized():
        have = dist.get_backend()
        if have != backend:
            raise RuntimeError(
                f"the process group is up with backend {have!r}; {device} needs {backend!r}")
        return dist.get_world_size()
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(backend, init_method="env://")
        atexit.register(_shut_down, None)
        return dist.get_world_size()
    path = tempfile.mkdtemp(prefix="repro_torch_group_")
    store = dist.FileStore(os.path.join(path, "store"), 1)
    dist.init_process_group(backend, store=store, rank=0, world_size=1)
    atexit.register(_shut_down, path)
    return 1


def make_mesh(shape: Sequence[int], axes: Sequence[str], device) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` over the whole world (which must hold
    prod(shape) ranks), named ``axes``."""
    device = torch.device(device)
    world = init_world(device)
    n = math.prod(shape)
    if n != world:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks; the world has {world}")
    return DeviceMesh(device.type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(device, *, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def describe(mesh) -> str:
    return "x".join(f"{n}={s}" for n, s in zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def make_data_group(device: torch.device, shape: Sequence[int] = ()):
    """The process group gradient compression reduces over: the world, or,
    for a (data, model) ``shape``, this rank's data group (the ranks of its
    model index, one a data index)."""
    init_world(device)
    if len(shape) < 2:
        return dist.group.WORLD
    return make_mesh(shape, ("data", "model"), device).get_group("data")


def _shut_down(store_dir) -> None:
    """At exit: the group first, then its store. NCCL's watchdog polls the
    store until the group is destroyed; with the store gone first it waits
    out its timeout (minutes) before the process can end."""
    if dist.is_initialized():
        dist.destroy_process_group()
    if store_dir is not None:
        shutil.rmtree(store_dir, ignore_errors=True)
