"""Thread-local activation-sharding policy, the reference's
``parallel/context.py``, on DTensors.

Model code is arch-agnostic; distribution code sets a policy (e.g. shard
the hidden state's sequence axis over 'model' for sequence-parallel archs)
and ``constrain`` applies it wherever the models call it (embedding output,
super-block boundaries). Outside a policy, and for a tensor that is not a
DTensor, both calls return their argument: one attribute read a call.
DTensor is imported only where one can exist (``is_dtensor``), so a
process that never distributes does not pay its import.

``local_product``, ``vocab_lookup`` and ``local_range`` serve the
models' DTensor paths: a product run on each rank's shards with a
tensor-parallel layer's placements, the vocab-parallel embedding, and
the slice of a split dim that a rank holds. ``reduce_partial`` and
``reduce_grad`` place the reductions where Megatron and XLA place them: a
partial sum (a row-parallel product's output, a lookup in a vocab-split
table) is all-reduced where it is made, and so is the partial-sum
gradient of a column-parallel product's input, so the hidden state stays
whole over the model axis. Left to DTensor, a partial sum is
reduce-scattered over the hidden dim, and every product after it gathers
its weights instead.
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


def local_product(fn, x, w, b=None):
    """``fn(x, w)`` + ``b`` (a product over the last dim of ``x``) for a
    DTensor ``x``, each rank on its own shards, mesh dim by mesh dim (rows
    of ``x`` split over a mesh dim that splits ``w`` are gathered first):

    * ``x``'s rows split, ``w`` and ``b`` whole: the rank's rows; the
      weights' gradients are partial sums;
    * ``x`` whole, ``w``'s columns split with ``b``'s (column-parallel):
      the rank's columns; ``x``'s gradient is a partial sum, all-reduced
      here (``reduce_grad``);
    * ``x``'s last dim split with ``w``'s rows (row-parallel): a partial
      sum, all-reduced here; ``b`` is added after; where ``x`` is whole
      (a split that would cut a head was gathered), each rank takes its
      slice of it first;
    * all whole: the whole product on every rank.

    Any other pairing is left to DTensor's own propagation, and the
    result's partial sums are reduced. A flattened batch-by-sequence split
    is one DTensor cannot reshape back, and its choices for a product's
    backward gather weights that the placements above never move."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    x = reduce_partial(x)
    last = x.ndim - 1
    mesh = x.device_mesh

    def places(t):
        return t.placements if is_dtensor(t) else (Replicate(),) * mesh.ndim

    # rows split over a mesh dim that also splits w (a sequence split meets
    # a tensor-parallel weight): the rows are gathered first, as sequence
    # parallelism gathers the sequence before a tensor-parallel product
    gather = [xp.is_shard() and xp.dim < last and not wp.is_replicate()
              for xp, wp in zip(x.placements, places(w))]
    if any(gather):
        x = x.redistribute(mesh, [Replicate() if g else xp
                                  for g, xp in zip(gather, x.placements)])

    out, xg, wg, bg, row_parallel, cut = [], [], [], [], False, False
    for xp, wp, bp in zip(x.placements, places(w), places(b)):
        if xp.is_shard() and xp.dim < last and wp.is_replicate() and bp.is_replicate():
            out.append(Shard(xp.dim))
            xg.append(xp)
            wg.append(Partial())
            bg.append(Partial())
        elif xp.is_shard(last) and wp.is_shard(0) and bp.is_replicate():
            out.append(Partial())
            xg.append(xp)
            wg.append(wp)
            bg.append(Replicate())
            row_parallel = True
        elif xp.is_replicate() and wp.is_shard(0) and bp.is_replicate():
            out.append(Partial())
            xg.append(Partial())
            wg.append(wp)
            bg.append(Replicate())
            row_parallel = cut = True
        elif xp.is_replicate() and wp.is_shard(1) and (b is None or bp.is_shard(0)):
            out.append(Shard(last))
            xg.append(Partial())
            wg.append(wp)
            bg.append(bp)
        elif xp.is_replicate() and wp.is_replicate() and bp.is_replicate():
            out.append(Replicate())
            xg.append(Replicate())
            wg.append(Replicate())
            bg.append(Replicate())
        else:
            y = fn(x, w)
            return reduce_partial(y if b is None else y + b)

    def local(t, grads):
        return t.to_local(grad_placements=grads) if is_dtensor(t) else t

    xl = local(reduce_grad(x), xg)
    if cut:
        if any(p.is_shard(last) for p in x.placements):
            return reduce_partial(fn(x, w) if b is None else fn(x, w) + b)
        lo, n = local_range(w.shape[0], mesh, w.placements, 0)
        xl = xl[..., lo:lo + n]
    y = fn(xl, local(w, wg))
    if b is not None and not row_parallel:
        y = y + local(b, bg)
    y = reduce_partial(DTensor.from_local(y, mesh, out, run_check=False))
    return y + b if b is not None and row_parallel else y


def local_bmm(a, b):
    """``torch.bmm(a, b)`` for DTensors a (n, i, k) and b (n, k, j), each
    rank on its own blocks, mesh dim by mesh dim: the batch split in both
    stays split; the contracted dim split in both gives a partial sum,
    all-reduced here; a's rows (b's columns) split against a whole b (a)
    stay split, and the whole operand's gradient is a partial sum,
    all-reduced where it arrives (``reduce_grad``). Any other pairing is
    left to DTensor's own propagation."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    out, ga, gb = [], [], []
    for pa, pb in zip(a.placements, b.placements):
        if pa.is_shard(0) and pb.is_shard(0):
            out.append(Shard(0)), ga.append(pa), gb.append(pb)
        elif pa.is_shard(2) and pb.is_shard(1):
            out.append(Partial()), ga.append(pa), gb.append(pb)
        elif pa.is_shard(1) and pb.is_replicate():
            out.append(Shard(1)), ga.append(pa), gb.append(Partial())
        elif pa.is_replicate() and pb.is_shard(2):
            out.append(Shard(2)), ga.append(Partial()), gb.append(pb)
        elif pa.is_replicate() and pb.is_replicate():
            out.append(Replicate()), ga.append(pa), gb.append(pb)
        else:
            return reduce_partial(torch.bmm(a, b))

    def local(t, grads):
        if any(g.is_partial() for g in grads):
            t = reduce_grad(t)
        return t.to_local(grad_placements=grads)

    y = torch.bmm(local(a, ga), local(b, gb))
    return reduce_partial(DTensor.from_local(y, a.device_mesh, out, run_check=False))


def reduce_partial(x):
    """A DTensor ``x`` with every partial-sum mesh dim reduced (made
    Replicate; an all-reduce each); ``x`` itself when it has none, or is
    not a DTensor."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p
                                          for p in x.placements])


class _ReduceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return reduce_partial(g)


def reduce_grad(x):
    """``x`` (a DTensor; anything else is returned as it is), whose
    gradient, where it arrives a partial sum, is all-reduced here."""
    if not is_dtensor(x) or not x.requires_grad:
        return x
    return _ReduceGrad.apply(x)


def vocab_lookup(table, ids):
    """``table[ids]`` for a DTensor ``table`` (vocab, d), each rank on its
    own ids: where the vocab is split, each rank looks its ids up in its
    own rows (ids outside them give 0) and the partial sums are
    all-reduced, the vocab-parallel embedding. The rows keep ``ids``'
    batch split (over one mesh dim or several)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = table.device_mesh
    tp = table.placements
    if not is_dtensor(ids):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim, run_check=False)
    lo, n = local_range(table.shape[0], mesh, tp, 0)
    idl = ids.to_local()
    # a rank's rows of the table take gradient from its own ids only: a
    # partial sum over the mesh dims that split the ids
    grads = [Partial() if i.is_shard() else t for t, i in zip(tp, ids.placements)]
    local = table.to_local(grad_placements=grads)
    if n == table.shape[0]:
        rows = local[idl]
    else:
        hit = (idl >= lo) & (idl < lo + n)
        rows = local[torch.clamp(idl - lo, 0, n - 1)] * hit[..., None].to(table.dtype)
    out = [Partial() if t.is_shard(0) else i for t, i in zip(tp, ids.placements)]
    return reduce_partial(DTensor.from_local(rows, mesh, out, run_check=False))


def vocab_argmax(x):
    """``torch.argmax(x, -1)`` for a DTensor ``x`` (b, vocab) split over
    the vocab: each rank's (max, index) pairs are gathered over the mesh
    dims that split the vocab, and the first largest wins (the lowest
    index on ties, as ``torch.argmax``: ranks hold the vocab in order).
    The result keeps ``x``'s batch split."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = x.device_mesh
    places = [Replicate() if p.is_partial() else p for p in x.placements]
    x = x.redistribute(mesh, places)
    lo, _ = local_range(x.shape[1], mesh, places, 1)
    best, idx = x.to_local().float().max(dim=-1)
    pair = torch.stack([best.double(), (idx + lo).double()], dim=-1)[:, None]  # (b, 1, 2)
    gathered = DTensor.from_local(pair, mesh, places, run_check=False).redistribute(
        mesh, [Replicate() if p.is_shard(1) else p for p in places]).to_local()
    pick = torch.argmax(gathered[..., 0], dim=-1)  # (b,): the first largest
    tokens = gathered[..., 1].gather(1, pick[:, None])[:, 0].long()
    return DTensor.from_local(tokens, mesh, [p if p.is_shard(0) else Replicate()
                                             for p in places], run_check=False)


def local_rows_of(module: torch.nn.Module, x):
    """Where ``x`` is a DTensor split over its rows (dim 0) alone and
    every parameter of ``module`` is whole on every rank, the block runs
    on each rank's rows with no DTensor inside: returns (a shallow copy of
    ``module`` holding the local parameters, whose gradients are partial
    sums over the mesh dims that split the rows; ``to_local``, which takes
    ``x`` or a dict of row-split DTensors to local tensors; ``wrap``,
    which takes the block's outputs, row-split, back to DTensors). Else
    None: the block runs on DTensors."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not is_dtensor(x) or any(not (p.is_shard(0) or p.is_replicate()) for p in x.placements):
        return None
    params = list(module.parameters())
    if not all(is_dtensor(p) and all(q.is_replicate() for q in p.placements) for p in params):
        return None
    mesh = x.device_mesh
    rows = [Shard(0) if p.is_shard(0) else Replicate() for p in x.placements]
    grads = [Partial() if p.is_shard(0) else Replicate() for p in x.placements]

    def localized(m):
        out = copy.copy(m)
        out._parameters = {k: None if v is None else v.to_local(grad_placements=grads)
                           for k, v in m._parameters.items()}
        out._modules = {k: None if v is None else localized(v) for k, v in m._modules.items()}
        return out

    def to_local(tree):
        if isinstance(tree, dict):
            return {k: to_local(v) for k, v in tree.items()}
        return tree.redistribute(mesh, rows).to_local() if is_dtensor(tree) else tree

    def wrap(tree):
        if isinstance(tree, dict):
            return {k: wrap(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(wrap(v) for v in tree)
        if isinstance(tree, torch.Tensor):
            return DTensor.from_local(tree, mesh, rows, run_check=False)
        return tree

    return localized(module), to_local, wrap


def regroup_columns(pieces, widths):
    """The last dims of ``pieces`` taken as one row of columns and cut
    again into consecutive pieces of ``widths``. For DTensors whose last
    dim is split over one mesh dim (the same in every piece, each piece in
    even chunks of its own), every output piece is split over that mesh
    dim in even chunks of its own, and the columns move between the ranks
    of that dim in one all-to-all: a rank receives only the columns of its
    new chunks that another rank holds. This is how a column-parallel
    projection whose output concatenates several head-split tensors
    (Mamba2's z | x | B | C | dt) hands each rank its own heads of each,
    where slicing the DTensor would gather the whole output on every rank.
    Anything else (plain tensors; a last dim whole, or split over several
    mesh dims; a width that does not split evenly) is concatenated and
    sliced as it is."""
    offs = [0]
    for w in widths:
        offs.append(offs[-1] + w)

    def sliced():
        whole = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=-1)
        return [whole[..., a:b] for a, b in zip(offs, offs[1:])]

    first = pieces[0]
    if not is_dtensor(first):
        return sliced()
    last = first.ndim - 1
    pieces = [reduce_partial(p) for p in pieces]
    places = pieces[0].placements
    cut = [d for d, p in enumerate(places) if p.is_shard(last)]
    widths_in = [p.shape[-1] for p in pieces]
    if (len(cut) != 1 or any(tuple(p.placements) != tuple(places) for p in pieces)
            or sum(widths_in) != offs[-1]):
        return sliced()
    from torch.distributed._functional_collectives import all_to_all_single_autograd
    from torch.distributed.tensor import DTensor

    mesh, md = pieces[0].device_mesh, cut[0]
    n, me = mesh.size(md), mesh.get_local_rank(md)
    if any(w % n for w in widths_in + list(widths)):
        return sliced()

    def chunks(ws, rank):
        """[(global lo, hi)] of rank's chunk of each piece of widths ws."""
        out, lo = [], 0
        for w in ws:
            out.append((lo + rank * w // n, lo + (rank + 1) * w // n))
            lo += w
        return out

    def overlaps(dst, src):
        """[(global lo, hi, offset in src's local row)] that rank ``src``
        holds of rank ``dst``'s new chunks, in order of the new pieces."""
        held, out = chunks(widths_in, src), []
        for a, b in chunks(widths, dst):
            at = 0
            for c, d in held:
                lo, hi = max(a, c), min(b, d)
                if lo < hi:
                    out.append((lo, hi, at + lo - c))
                at += d - c
        return out

    local = torch.cat([p.to_local() for p in pieces], dim=-1)
    sends = [[] if j == me else overlaps(j, me) for j in range(n)]
    recvs = [[] if s == me else overlaps(me, s) for s in range(n)]
    cols = [local[..., o:o + hi - lo] for out in sends for lo, hi, o in out]
    got = None
    if n > 1:  # every rank of the mesh dim takes part
        buf = (torch.cat(cols, dim=-1) if cols else local[..., :0]).movedim(-1, 0)
        got = all_to_all_single_autograd(
            buf.contiguous(), [sum(hi - lo for lo, hi, _ in r) for r in recvs],
            [sum(hi - lo for lo, hi, _ in s) for s in sends],
            (mesh, md)).movedim(0, -1)
    # every received or held column of this rank's new chunks, by its
    # global position
    parts, at = [], 0
    for s in range(n):
        for lo, hi, o in overlaps(me, s):
            if s == me:
                parts.append((lo, hi, local[..., o:o + hi - lo]))
            else:
                parts.append((lo, hi, got[..., at:at + hi - lo]))
                at += hi - lo
    out = []
    for a, b in chunks(widths, me):
        mine = sorted((p for p in parts if a <= p[0] < b), key=lambda p: p[0])
        t = mine[0][2] if len(mine) == 1 else torch.cat([p[2] for p in mine], dim=-1)
        out.append(DTensor.from_local(t, mesh, places, run_check=False))
    return out


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
