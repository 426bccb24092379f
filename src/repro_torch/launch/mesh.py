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

The dry run (``launch/dryrun.py``) runs in a world of its own:
``dryrun_world`` brings up a fake process group of ``DRYRUN_WORLD`` (512)
ranks in this one process (``torch.testing``'s ``fake`` backend: its
collectives return at once, and nothing is sent), and
``make_dryrun_mesh`` lays a mesh over its first ranks, as the
reference's ``make_mesh`` takes the first of its 512 placeholder devices.
Nothing opens a world at import.

The backend follows the device: NCCL for a CUDA device, gloo for the CPU,
never one in place of the other (a world already up with the other
backend raises). NCCL takes one rank a card, so one card holds a 1 x 1
mesh; meshes of several ranks run on the host over gloo, or on as many
cards.
"""

from __future__ import annotations

import atexit
import contextlib
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
    return make_mesh(*production_shape(multi_pod), device)


DRYRUN_WORLD = 512  # 2 pods x 256 chips


@contextlib.contextmanager
def dryrun_world(n: int = DRYRUN_WORLD):
    """A fake process group of ``n`` ranks, this process rank 0, for the
    enclosed block; torn down on exit, so that a world of another
    backend can come up after it (``init_world`` refuses a mismatch).
    Raises if a process group is already up."""
    if dist.is_initialized():
        raise RuntimeError(f"a process group ({dist.get_backend()!r}) is already up; "
                           f"the dry run needs a world of its own")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_dryrun_mesh(shape: Sequence[int], axes: Sequence[str], device) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` over the first prod(shape) ranks of
    the dry-run world (``dryrun_world``), named ``axes``."""
    n = math.prod(shape)
    if n > dist.get_world_size():
        raise ValueError(f"need {n} ranks, the world has {dist.get_world_size()}")
    return DeviceMesh(torch.device(device).type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def production_shape(multi_pod: bool):
    """(shape, axes) of the single-pod or the 2-pod mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


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
