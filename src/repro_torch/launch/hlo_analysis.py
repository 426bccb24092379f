"""Roofline counts of one rank's step, the reference's
``launch/hlo_analysis.py``.

The reference parses XLA's compiled, post-SPMD HLO text. Eager PyTorch has
no HLO: this module counts the aten ops that rank 0 runs instead, through
a ``TorchDispatchMode`` (``RooflineCounter``) around a step run on meta
shards (``launch/dryrun.py``). A DTensor op is let through to DTensor
(the mode returns ``NotImplemented`` for it), which runs it as ops on
rank 0's local shards and collectives of ``_c10d_functional``; those are
what is counted, at the local shapes. Only ops on plain meta tensors
count: DTensor's own shape propagation runs an op once more on
global-shape FakeTensors, its bookkeeping on host tensors, and (torch
2.13) the decomposition it runs once to find an op's strategy on meta
tensors that carry a ``_spec``; none of them is the step's.

It accumulates the reference's ``RooflineCounts``:

* ``flops``: each op's FLOPs by ``torch.utils.flop_counter``'s formulas
  (mm, addmm, bmm, baddbmm, convolution, attention): 2 x prod(result) x
  the contracted size, the reference's dot count. Elementwise ops count
  none, as there.
* ``collective_bytes`` and ``collectives``: the result bytes of each
  collective, by kind (``COLLECTIVE_KINDS``); ``wait_tensor`` counts 0,
  as the reference skips ``-done``. No promotion correction: DTensor
  reduces bf16 in bf16. A partial sum over two mesh dims is reduced as
  two collectives (DTensor's rule), where XLA issues one over both axes.
* ``memory_bytes``: per op, its tensor operands plus its result, the
  reference's ``_op_memory_bytes``, with these classes:
  - views and metadata count 0 (``OpOverload.is_view``, ``FREE``: an
    eager reshape that copies is a ``clone``, and counts);
  - a gather counts twice its result (``GATHERS``, the reference's
    dynamic-slice and gather); a slice is a view, so its consumer reads
    the slice, where XLA's static ``slice`` reads its whole operand;
  - an update of a region (``UPDATES``: ``copy_``, ``index_put_``,
    ``slice_scatter``, ...) counts twice the update, the reference's
    dynamic-update-slice;
  - a fill counts its result once (``FILLS``, XLA's broadcast of a
    constant).
  Eager ops are not fused: an elementwise chain that XLA fuses into one
  pass reads and writes every intermediate here, so the count runs
  above the reference's. No constant is fitted to meet it.
* ``warnings``: none are raised by the counting; the field is kept.

Besides, ``transcendentals`` (the result elements of ``TRANSCENDENTALS``)
and ``peak_bytes``: the most bytes of storage that ops allocated during
the count and that were alive at once (each new storage is added when an
op returns it and taken off when the last tensor seen on it is freed).
"""

from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# _c10d_functional op name -> the reference's collective kind
COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "permute_tensor": "collective-permute",
    "send": "collective-permute",
    "recv_": "collective-permute",
}
COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "_dtensor", "c10d")

FREE = frozenset({"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
                  "_unsafe_view", "lift_fresh", "set_", "resize_", "_local_scalar_dense",
                  "wait_tensor", "sym_size", "sym_stride", "sym_numel"})
GATHERS = frozenset({"index", "gather", "index_select", "embedding", "take"})
# op name -> the position of its update operand
UPDATES = {"copy_": 1, "copy": 1, "index_put_": 2, "index_put": 2, "_index_put_impl_": 2,
           "slice_scatter": 1, "select_scatter": 1, "index_copy_": 3, "index_copy": 3,
           "scatter": 3, "scatter_": 3, "scatter_add": 3, "scatter_add_": 3,
           "index_add": 3, "index_add_": 3, "masked_scatter": 2, "masked_scatter_": 2}
FILLS = frozenset({"zeros", "ones", "full", "zero_", "fill_", "zeros_like", "ones_like",
                   "full_like", "new_zeros", "new_ones", "new_full", "arange", "scalar_tensor"})
TRANSCENDENTALS = frozenset({"exp", "exp2", "expm1", "log", "log1p", "log2", "tanh", "sigmoid",
                             "rsqrt", "sqrt", "sin", "cos", "pow", "erf", "silu", "gelu",
                             "softplus", "_softmax", "_log_softmax", "logsumexp"})


@dataclasses.dataclass
class RooflineCounts:
    flops: float = 0.0
    collective_bytes: float = 0.0
    collectives: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    memory_bytes: float = 0.0
    warnings: List[str] = dataclasses.field(default_factory=list)
    transcendentals: float = 0.0
    peak_bytes: int = 0


def nbytes(x) -> int:
    """Bytes of the tensors in ``x`` (a tensor, or a list or tuple of them)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(x)
               if isinstance(t, torch.Tensor))


def _is_step_op(types, tree) -> bool:
    """Whether an op is the step's own work: its tensors are plain meta
    tensors (the local shards and what is computed from them). DTensor's
    shape propagation runs on FakeTensors, and its bookkeeping on host
    tensors; neither counts. Nor does the first call of an op that DTensor
    shards through its decomposition (torch 2.13 runs the decomposition
    once on global-shape meta tensors that carry a ``_spec``, then caches
    the strategy): counted, it would make a trace's counts depend on what
    ran before it in the process."""
    if any(t is not torch.Tensor and t is not torch.nn.Parameter for t in types):
        return False
    leaves = [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]
    return (bool(leaves) and all(t.is_meta for t in leaves)
            and not any(hasattr(t, "_spec") for t in leaves))


class RooflineCounter(TorchDispatchMode):
    """Counts every op the enclosed code runs on plain (local) tensors
    into ``self.counts``; DTensor ops are handed to DTensor first."""

    def __init__(self):
        super().__init__()
        from torch.distributed.tensor import DTensor

        self._dtensor = DTensor
        self.counts = RooflineCounts()
        self.read = set()  # storages the counted ops took as inputs
        self._live = 0
        self._storages: Dict[int, list] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _is_step_op(types, (args, kwargs, out)):
            self._account(func, args, kwargs, out)
            self._track(out)
            self.read.update(t.untyped_storage()._cdata for t in tree_leaves((args, kwargs))
                             if isinstance(t, torch.Tensor))
        return out

    # -- counting ---------------------------------------------------------

    def _account(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry

        c = self.counts
        packet = func._overloadpacket
        name = packet.__name__
        ns = func.namespace
        if ns == "prim":
            return
        if packet in flop_registry:
            c.flops += float(flop_registry[packet](*args, **kwargs, out_val=out))
        if ns in COLLECTIVE_NAMESPACES:
            kind = COLLECTIVE_KINDS.get(name)
            if kind is None:
                return
            b = nbytes(out)
            c.collective_bytes += b
            c.collectives[kind] += b
            c.memory_bytes += nbytes((args, kwargs)) + b
            return
        if name in TRANSCENDENTALS:
            c.transcendentals += sum(t.numel() for t in tree_leaves(out)
                                     if isinstance(t, torch.Tensor))
        c.memory_bytes += op_memory_bytes(func, name, args, kwargs, out)

    # -- live bytes -------------------------------------------------------

    def _track(self, out) -> None:
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            storage = t.untyped_storage()
            key = storage._cdata
            entry = self._storages.get(key)
            if entry is None:
                entry = self._storages[key] = [storage.nbytes(), 0]
                self._live += entry[0]
                self.counts.peak_bytes = max(self.counts.peak_bytes, self._live)
            entry[1] += 1
            weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self._live -= entry[0]
            del self._storages[key]


def op_memory_bytes(func, name: str, args, kwargs, out) -> int:
    """Bytes one op moves, by the classes of the module doc."""
    if func.is_view or name in FREE or name == "detach" or name == "alias":
        return 0
    if name in GATHERS:
        return 2 * nbytes(out)
    if name in UPDATES:
        pos = UPDATES[name]
        upd = args[pos] if len(args) > pos else None
        return 2 * (nbytes(upd) if isinstance(upd, torch.Tensor) else nbytes(out))
    if name in FILLS:
        return nbytes(out)
    return nbytes((args, kwargs)) + nbytes(out)


def as_record(counts: RooflineCounts) -> dict:
    """The record's ``hlo`` entry, the reference's keys."""
    return {"flops_per_device": counts.flops,
            "memory_bytes_per_device": counts.memory_bytes,
            "collective_bytes_per_device": counts.collective_bytes,
            "collectives": dict(counts.collectives),
            "warnings": counts.warnings[:20]}
