"""Thread-local activation-sharding policy, the reference's
``parallel/context.py``, on DTensors.

Model code is arch-agnostic; distribution code sets a policy (e.g. shard
the hidden state's sequence axis over 'model' for sequence-parallel archs)
and ``constrain`` applies it wherever the models call it (embedding output,
super-block boundaries). Outside a policy, and for a tensor that is not a
DTensor, both calls return their argument: one attribute read a call.
DTensor is imported only where one can exist (``is_dtensor``), so a
process that never distributes does not pay its import.

``local_rows`` and ``local_range`` serve the models' DTensor paths: a
product with weights whole on every rank, run on each rank's rows, and
the slice of a split dim that a rank holds.
"""

from __future__ import annotations

import contextlib
import copy
import sys
import threading
from typing import Optional

import torch

from repro_torch.parallel.sharding import axis_len, placements

_LOCAL = threading.local()


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor; none exists before
    ``torch.distributed.tensor`` is imported, so this imports nothing."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


@contextlib.contextmanager
def activation_sharding(sharding: Optional[object]):
    """``sharding`` is a ``steps.NamedSharding`` for (b, s, d) hidden
    states, or None."""
    prev = getattr(_LOCAL, "sharding", None)
    _LOCAL.sharding = sharding
    try:
        yield
    finally:
        _LOCAL.sharding = prev


@contextlib.contextmanager
def param_gather_sharding(mesh):
    """FSDP: while set, ``constrain_group_params`` all-gathers one layer's
    weights over the data axis of ``mesh`` when the layer runs (its
    TP-only placements), instead of the whole model at once."""
    prev = getattr(_LOCAL, "param_gather", None)
    _LOCAL.param_gather = mesh
    try:
        yield
    finally:
        _LOCAL.param_gather = prev


def constrain_group_params(layer: torch.nn.Module) -> torch.nn.Module:
    """``layer`` itself, or under ``param_gather_sharding`` a shallow copy
    whose DTensor parameters are redistributed with the data axis
    replicated (differentiably: gradients reach the sharded parameters)."""
    mesh = getattr(_LOCAL, "param_gather", None)
    if mesh is None:
        return layer
    from torch.distributed.tensor import DTensor, Replicate

    data = mesh.mesh_dim_names.index("data")

    def gathered(module):
        out = copy.copy(module)
        out._parameters = dict(module._parameters)
        out._modules = {k: gathered(v) for k, v in module._modules.items()}
        for name, p in module._parameters.items():
            if isinstance(p, DTensor) and not p.placements[data].is_replicate():
                places = list(p.placements)
                places[data] = Replicate()
                out._parameters[name] = p.redistribute(p.device_mesh, places)
        return out

    return gathered(layer)


def constrain(h):
    """Redistribute a DTensor ``h`` (b, s, d) to the policy's placements
    when the policy's axes divide its shape; else ``h`` unchanged."""
    sh = getattr(_LOCAL, "sharding", None)
    if sh is None or not is_dtensor(h) or h.ndim != 3:
        return h
    spec = tuple(sh.spec) + (None,) * (h.ndim - len(sh.spec))
    for dim, entry in enumerate(spec):
        if h.shape[dim] % max(axis_len(sh.mesh, entry), 1) != 0:
            return h
    return h.redistribute(sh.mesh, placements(sh.spec, sh.mesh))


def local_rows(fn, x, *weights):
    """``fn(x, *weights)`` (a product applied to the last dim of ``x``) for
    a DTensor ``x``: where every weight is whole on every rank and ``x``'s
    last dim is not split, each rank applies ``fn`` to its own rows (a
    flattened batch-by-sequence split is one DTensor cannot reshape back);
    else DTensor's own propagation. A weight's gradient is then a partial
    sum over the mesh dims that split the rows."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = x.device_mesh
    whole = all(w is None or all(p.is_replicate() for p in w.placements) for w in weights)
    if not whole or any(p.is_shard(x.ndim - 1) for p in x.placements):
        return fn(x, *weights)
    places = [p if p.is_shard() else Replicate() for p in x.placements]
    x = x.redistribute(mesh, places)
    grad_places = [Partial() if p.is_shard() else Replicate() for p in places]
    out = fn(x.to_local(), *(None if w is None else w.to_local(grad_placements=grad_places)
                             for w in weights))
    return DTensor.from_local(out, mesh, places)


def local_range(global_len: int, mesh, places, dim: int):
    """(first index, length) of this rank's slice of tensor dim ``dim``
    under the placements ``places`` (mesh dims in order, each an even
    split)."""
    lo, n = 0, global_len
    for mesh_dim, place in enumerate(places):
        if place.is_shard(dim):
            size = mesh.size(mesh_dim)
            if n % size:
                raise ValueError(f"dim {dim} of {global_len} does not split {size} ways")
            n //= size
            lo += mesh.get_local_rank(mesh_dim) * n
    return lo, n
