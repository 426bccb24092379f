"""Partition rules for params, optimizer state, batches and decode caches,
the reference's ``parallel/sharding.py``, as DTensor placements.

A spec (``Spec``) has one entry per tensor dim, each ``None``, a mesh axis
name or a tuple of axis names (the reference's ``PartitionSpec``; a
shorter spec leaves the trailing dims unsharded). ``placements(spec,
mesh)`` turns it into one ``Shard``/``Replicate`` per mesh dim.

TP policy per tensor (model axis = 16 on the production meshes):
  * attention Q / O projections: shard the head axis when n_heads divides
    the model axis; otherwise the arch runs SEQUENCE-parallel attention
    (activations sharded on seq -- starcoder2's 24H) or replicated-model
    (mamba2-130m) -- decided by ``tp_mode``.
  * K/V projections: shard heads when n_kv_heads divides the axis, else
    REPLICATE (GQA KV is small; Megatron-style). Their optimizer moments
    are ZeRO-1-sharded over the data axis so replication never costs f32.
  * dense MLP / MoE experts: canonical column/row (expert) sharding.
  * embeddings: vocab-sharded when divisible (gemma3's 262k), else
    replicated (whisper 51865, mamba2 50280, granite-moe 49155).

Optimizer state: the param's spec plus ZeRO-1 -- the first unsharded dim
divisible by the data axis takes "data". FSDP (``param_specs(fsdp=True)``,
off by default as in the reference) does the same to large params.

The port keeps one module a layer (``blocks.<g * len(pattern) + i>``,
``enc_blocks.<l>``, ``dec_blocks.<l>``) where the reference stacks each
pattern position's leaves over a leading group axis that is never
TP-sharded, so a layer's spec is the reference's without that axis. Two
rules see the stack: the ZeRO-1 and FSDP size thresholds are taken on the
stacked size (group x the layer's), so the port extends exactly the
tensors the reference extends; and where the reference's first free
divisible dim is the group axis itself, the port takes the layer's first
free divisible dim (the same bytes a device), or none when no dim of the
layer divides (ROADMAP §C lists where that happens).

Batch/cache specs: batch shards over ("pod", "data") when divisible; KV
caches shard heads when divisible, else the SEQUENCE axis. The rules take
any mesh-like object with ``mesh_dim_names`` and ``shape`` (a
``DeviceMesh``, or ``MeshShape`` for the production meshes' rules without
their ranks).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import TYPE_CHECKING, Any, Dict, Optional, Tuple, Union

import torch

if TYPE_CHECKING:  # models/ import this package through parallel/context.py
    from repro_torch.configs.base import ArchDef, ShapeCell

Entry = Union[None, str, Tuple[str, ...]]


class Spec(tuple):
    """``Spec(None, "model")``: one entry per tensor dim."""

    def __new__(cls, *entries: Entry):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, the reference's ``jax.sharding.NamedSharding``."""

    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes without its ranks, for the rules."""

    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


# ---------------------------------------------------------------------------
# mesh helpers
# ---------------------------------------------------------------------------


def axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def dp_size(mesh) -> int:
    s = axis_sizes(mesh)
    return math.prod(s[a] for a in dp_axes(mesh))


def model_size(mesh) -> int:
    return axis_sizes(mesh).get("model", 1)


def _axes(entry: Entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axis_len(mesh, entry: Entry) -> int:
    s = axis_sizes(mesh)
    return math.prod(s[a] for a in _axes(entry))


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on every mesh
    dim that tensor dim d's entry names, ``Replicate()`` elsewhere. Two mesh
    dims on one tensor dim shard it in mesh order (the first names the
    major part), as JAX orders ("pod", "data")."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        idx = [names.index(a) for a in _axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: axes {entry} are not in the mesh's order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"{spec}: mesh axis {names[i]!r} shards two dims")
            out[i] = Shard(dim)
    return tuple(out)


def shard_factor(spec: Spec, mesh) -> int:
    """How many ways ``spec`` splits a tensor over ``mesh``."""
    return math.prod(axis_len(mesh, e) for e in spec)


# ---------------------------------------------------------------------------
# TP mode per arch
# ---------------------------------------------------------------------------


def tp_mode(arch: ArchDef, mesh) -> str:
    """'head' | 'seq' | 'replicate' -- how attention/TP shards on this mesh."""
    m = model_size(mesh)
    if m == 1:
        return "replicate"
    cfg = arch.full
    if arch.is_encdec():
        return "head" if cfg.n_heads % m == 0 else "seq"
    if cfg.attn is not None:
        return "head" if cfg.attn.n_heads % m == 0 else "seq"
    # attention-free (mamba2-130m): TP only if inner heads divide the axis
    if cfg.mamba_cfg is not None and cfg.mamba_cfg.n_heads % m == 0:
        return "head"
    return "replicate"


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------


def _spec_for(path: str, shape: Tuple[int, ...], arch: ArchDef, mesh) -> Spec:
    m = model_size(mesh)
    mode = tp_mode(arch, mesh)
    cfg = arch.full
    nd = len(shape)

    def last2(col_spec):
        """Spec with sharding on the trailing 2 dims, leading dims None."""
        return Spec(*([None] * (nd - 2) + list(col_spec)))

    def last1(s):
        return Spec(*([None] * (nd - 1) + [s]))

    if m == 1 or mode == "replicate":
        return Spec()

    # --- embeddings / heads
    if re.search(r"(embed|pos_embed|tok_embed)\.table$", path):
        vocab = shape[0]
        return Spec("model", None) if vocab % m == 0 else Spec()
    if re.search(r"lm_head\.w$", path):
        return last2([None, "model"]) if shape[-1] % m == 0 else Spec()

    # --- attention projections
    if re.search(r"(attn|self|cross)\.q\.w$", path):
        if mode == "head" and cfg_heads(arch) % m == 0:
            return last2([None, "model"])
        return Spec()
    if re.search(r"(attn|self|cross)\.[kv]\.w$", path):
        if mode == "head" and cfg_kv_heads(arch) % m == 0:
            return last2([None, "model"])
        return Spec()  # replicate small GQA KV
    if re.search(r"(attn|self|cross)\.q\.b$", path):
        return last1("model") if mode == "head" and cfg_heads(arch) % m == 0 else Spec()
    if re.search(r"(attn|self|cross)\.[kv]\.b$", path):
        return last1("model") if mode == "head" and cfg_kv_heads(arch) % m == 0 else Spec()
    if re.search(r"(attn|self|cross)\.o\.w$", path):
        if mode == "head" and cfg_heads(arch) % m == 0:
            return last2(["model", None])
        return Spec()

    # --- MoE
    if re.search(r"moe\.router\.w$", path):
        return Spec()
    if re.search(r"moe\.experts\.(up|gate|down)\.w$", path):
        # (E, D, F): shard experts
        return Spec(*([None] * (nd - 3) + ["model", None, None]))

    # --- dense MLP
    if re.search(r"mlp\.(up|gate)\.w$", path):
        return last2([None, "model"]) if shape[-1] % m == 0 else Spec()
    if re.search(r"mlp\.(up|gate)\.b$", path):
        return last1("model") if shape[-1] % m == 0 else Spec()
    if re.search(r"mlp\.down\.w$", path):
        return last2(["model", None]) if shape[-2] % m == 0 else Spec()

    # --- Mamba2
    mc = cfg_mamba(arch)
    if mc is not None:
        head_tp = mc.n_heads % m == 0
        if re.search(r"mamba\.in_proj\.w$", path):
            return last2([None, "model"]) if head_tp and shape[-1] % m == 0 else Spec()
        if re.search(r"mamba\.out_proj\.w$", path):
            return last2(["model", None]) if head_tp else Spec()
        if re.search(r"mamba\.conv_[wb]$", path):
            return last1("model") if head_tp and shape[-1] % m == 0 else Spec()

    # --- norms, Mamba2's A_log / dt_bias / D / norm_scale, vision proj
    return Spec()


def cfg_heads(arch: ArchDef) -> int:
    return arch.full.n_heads if arch.is_encdec() else arch.full.attn.n_heads


def cfg_kv_heads(arch: ArchDef) -> int:
    return arch.full.n_kv_heads if arch.is_encdec() else arch.full.attn.n_kv_heads


def cfg_mamba(arch: ArchDef):
    return None if arch.is_encdec() else arch.full.mamba_cfg


_STACKED = re.compile(r"^(blocks|enc_blocks|dec_blocks)\.(\d+)\.")


def _group_sizes(names, arch: ArchDef) -> Dict[str, int]:
    """The reference's stack length for each stack of layers in ``names``:
    ``blocks`` holds n_layers / len(pattern) groups, ``enc_blocks`` and
    ``dec_blocks`` one entry a layer."""
    layers: Dict[str, set] = {}
    for name in names:
        hit = _STACKED.match(name)
        if hit:
            layers.setdefault(hit.group(1), set()).add(int(hit.group(2)))
    per = 1 if arch.is_encdec() else len(arch.full.pattern)
    return {stack: len(ids) // (per if stack == "blocks" else 1)
            for stack, ids in layers.items()}


def _group_of(name: str, sizes: Dict[str, int]) -> int:
    """The stack length behind ``name`` (0 for a leaf the reference does
    not stack)."""
    hit = _STACKED.match(name)
    return sizes[hit.group(1)] if hit else 0


def _over_data(entries: list, shape: Tuple[int, ...], d: int) -> Spec:
    """Shard the first free dim divisible by ``d`` over "data"."""
    for i, (e, s) in enumerate(zip(entries, shape)):
        if e is None and s % d == 0:
            entries[i] = "data"
            return Spec(*entries)
    return Spec(*entries)


def _has_data(entries) -> bool:
    return any("data" in _axes(e) for e in entries)


# FSDP is implemented but DEFAULT OFF, as in the reference (its measured
# cost under XLA is recorded there).
FSDP_MIN_BYTES = 32 * 2**20  # shard a tensor over 'data' when its TP shard
#                               still exceeds 32 MiB per device


def _fsdp_extend(spec: Spec, shape: Tuple[int, ...], mesh, dtype_bytes: int = 2,
                 group: int = 0) -> Spec:
    """FSDP: additionally shard large tensors over the 'data' axis (first
    free divisible dim); ``group`` is the reference's stack length, whose
    stacked size the thresholds read."""
    d = axis_sizes(mesh).get("data", 1)
    if d == 1 or len(shape) + (1 if group else 0) < 2:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    if _has_data(entries):
        return spec
    n = math.prod(shape) * max(group, 1)
    m = axis_sizes(mesh).get("model", 1)
    sharded_by = m if any(e == "model" for e in entries) else 1
    if n * dtype_bytes // sharded_by < FSDP_MIN_BYTES:
        return spec
    out = _over_data(entries, shape, d)
    return out if _has_data(out) else spec


def _named_leaves(params) -> Dict[str, Any]:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def param_specs(params, arch: ArchDef, mesh, *, fsdp: bool = False) -> Dict[str, Spec]:
    """{name: Spec} for a model (or its {name: tensor}; meta tensors do)."""
    leaves = _named_leaves(params)
    sizes = _group_sizes(leaves, arch)
    specs = {}
    for name, leaf in leaves.items():
        sp = _spec_for(name, tuple(leaf.shape), arch, mesh)
        if fsdp:
            sp = _fsdp_extend(sp, tuple(leaf.shape), mesh, group=_group_of(name, sizes))
        specs[name] = sp
    return specs


def zero1_spec(spec: Spec, shape: Tuple[int, ...], mesh, group: int = 0) -> Spec:
    """Extend a param spec for optimizer moments: shard the first free,
    divisible dim over 'data' (ZeRO-1); ``group`` as in ``_fsdp_extend``."""
    d = axis_sizes(mesh).get("data", 1)
    if d == 1:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    if _has_data(entries):
        return spec
    # moments smaller than ~1 MiB aren't worth slicing
    if math.prod(shape) * max(group, 1) < 262_144:
        return spec
    out = _over_data(entries, shape, d)
    return out if _has_data(out) else spec


def opt_state_specs(opt_state, pspecs: Dict[str, Spec], mesh, arch: ArchDef):
    """Specs for {m, v, step}: the param spec + ZeRO-1 data sharding."""
    sizes = _group_sizes(pspecs, arch)

    def moments(tree):
        return {name: zero1_spec(pspecs[name], tuple(leaf.shape), mesh,
                                 _group_of(name, sizes))
                for name, leaf in tree.items()}

    return {"m": moments(opt_state["m"]), "v": moments(opt_state["v"]), "step": Spec()}


# ---------------------------------------------------------------------------
# batch / cache / activation specs
# ---------------------------------------------------------------------------


def _batch_axis(cell: ShapeCell, mesh) -> Optional[Tuple[str, ...]]:
    dsize = dp_size(mesh)
    return dp_axes(mesh) if (cell.batch % max(dsize, 1) == 0 and dsize > 1) else None


def map_tree(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over nested dicts and lists (paths joined by "."); a
    ``Spec`` is a leaf."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, f"{path}{k}.") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, Spec):
        return type(tree)(map_tree(fn, v, f"{path}{i}.") for i, v in enumerate(tree))
    return fn(path[:-1], tree)


def batch_specs(batch_tree, cell: ShapeCell, mesh):
    """tokens/labels (B, S) (and frames, images) shard the batch over the
    dp axes when divisible."""
    b_ax = _batch_axis(cell, mesh)
    return map_tree(lambda _, leaf: Spec(*([b_ax] + [None] * (len(leaf.shape) - 1))),
                     batch_tree)


def cache_specs(caches, arch: ArchDef, cell: ShapeCell, mesh):
    """KV caches (B, hk, S, hd) shard heads if divisible else seq; mamba
    states (B, h, n, p) shard heads if divisible; ``idx`` is a host int."""
    m = model_size(mesh)
    b_ax = _batch_axis(cell, mesh)
    mc = cfg_mamba(arch)

    def spec(path, leaf):
        if path.endswith("idx"):
            return Spec()
        shape = tuple(leaf.shape)
        if path.endswith("conv"):  # (B, dconv-1, ch)
            ch_ok = m > 1 and mc is not None and mc.n_heads % m == 0 and shape[-1] % m == 0
            return Spec(b_ax, None, "model" if ch_ok else None)
        if path.endswith("ssm"):  # (B, h, n, p)
            h_ok = m > 1 and shape[-3] % m == 0
            return Spec(b_ax, "model" if h_ok else None, None, None)
        # attention kv: (B, hk, S, hd)
        if m > 1 and shape[-3] % m == 0:
            return Spec(b_ax, "model", None, None)
        if m > 1 and shape[-2] % m == 0:
            return Spec(b_ax, None, "model", None)  # sequence-sharded
        return Spec(b_ax, None, None, None)

    return map_tree(spec, caches)


def activation_spec(arch: ArchDef, cell: ShapeCell, mesh) -> Optional[Spec]:
    """Hidden-state constraint applied at super-block boundaries: only
    'seq' archs (heads don't divide the axis) are constrained -- attention
    work balances by sharding the sequence."""
    if tp_mode(arch, mesh) != "seq":
        return None
    if cell.seq % model_size(mesh) != 0:
        return None
    return Spec(_batch_axis(cell, mesh), "model", None)


def bytes_per_device(tree, specs, mesh) -> int:
    """Bytes one device holds of ``tree`` (tensors, meta ones too) under
    ``specs``, a spec tree of the same structure; sharded dims divide."""
    if isinstance(tree, dict):
        return sum(bytes_per_device(v, specs[k], mesh) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return sum(bytes_per_device(v, sp, mesh) for v, sp in zip(tree, specs))
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size() // shard_factor(specs, mesh)
    return 0
