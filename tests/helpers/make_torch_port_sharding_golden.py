"""Write ``tests/data/torch_port_sharding_golden.json``: the JAX package's
partition specs for every arch at full width on five meshes, in the port's
form, for ``chip_smoke.py`` phase 10a (the card has no JAX) and
``tests/test_torch_sharding.py`` (which also holds the file equal to the
live reference, so it cannot go stale).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/helpers/make_torch_port_sharding_golden.py

The port's form of a spec: a list of entries (null, an axis name, or a
list of axis names), a one-axis tuple written as its name, trailing nulls
dropped. A leaf the reference stacks over layers (``blocks/<i>/...``,
``enc_blocks/...``, ``dec_blocks/...``, every cache leaf) loses its
leading entry; where ZeRO-1 or FSDP put "data" on that group axis, the
port's rule shards the layer's first free dim the data axis divides
instead, or nothing when none does (``parallel/sharding.py``).
Params are keyed by the reference's path (``convert.reference_param_path``
maps a port name onto it), caches by the reference's cache path
(``convert.reference_cache_path``).
"""

import functools
import json
import math
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "..", "src"))

OUT = os.path.join(HERE, "..", "data", "torch_port_sharding_golden.json")
MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "8x1": ((8, 1), ("data", "model")),
}
STACKS = ("blocks/", "enc_blocks/", "dec_blocks/")


class FakeMesh:
    """Just enough Mesh surface for the rule functions."""

    def __init__(self, shape, names):
        self.devices = np.empty(shape, dtype=object)
        self.axis_names = names


def norm(entries) -> list:
    """A spec's entries in the port's form (see the module doc)."""
    out = []
    for e in entries:
        if isinstance(e, (tuple, list)):
            e = None if len(e) == 0 else e[0] if len(e) == 1 else list(e)
        out.append(e)
    while out and out[-1] is None:
        out.pop()
    return out


def _axes(entry):
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def port_form(entries, stacked: bool, shape, sizes) -> list:
    """The port's spec of one layer of a reference leaf of ``shape``."""
    if not stacked:
        return norm(entries)
    e = list(entries) + [None] * (len(shape) - len(entries))
    lead, rest = e[0], e[1:]
    if "data" in _axes(lead):
        for i, (x, s) in enumerate(zip(rest, shape[1:])):
            if x is None and s % sizes["data"] == 0:
                rest[i] = "data"
                break
    return norm(rest)


def _flat(tree, is_leaf=None):
    import jax

    from repro.parallel import sharding as rs

    return {rs._path_str(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def _device_bytes(tree, specs, sizes) -> int:
    total = 0
    for path, leaf in tree.items():
        factor = math.prod(math.prod(sizes[a] for a in _axes(e)) for e in tuple(specs[path]))
        total += int(np.prod(leaf.shape)) * leaf.dtype.itemsize // factor
    return total


@functools.lru_cache(maxsize=None)
def _abstract(arch_id: str):
    """The arch's FULL (params, AdamW state) as ShapeDtypeStructs."""
    import jax

    from repro.configs import ARCHS
    from repro.optim import adamw

    arch = ARCHS[arch_id]
    params = jax.eval_shape(lambda: arch.init(jax.random.PRNGKey(0), arch.full))
    return params, jax.eval_shape(adamw.init, params)


def reference_specs(arch_id: str, mesh_name: str) -> dict:
    """The reference's specs for one arch on one mesh, in the port's form."""
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.configs import ARCHS
    from repro.configs.base import SHAPES
    from repro.parallel import sharding as rs

    arch = ARCHS[arch_id]
    shape, names = MESHES[mesh_name]
    mesh, sizes = FakeMesh(shape, names), dict(zip(names, shape))
    is_spec = lambda x: isinstance(x, P)  # noqa: E731
    params, opt = _abstract(arch_id)
    flat = _flat(params)
    pspec = rs.param_specs(params, arch, mesh)
    fspec = _flat(rs.param_specs(params, arch, mesh, fsdp=True), is_spec)
    ospec = _flat(rs.opt_state_specs(opt, pspec, mesh)["m"], is_spec)
    pspec = _flat(pspec, is_spec)

    def form(specs, path):
        return port_form(tuple(specs[path]), path.startswith(STACKS), flat[path].shape, sizes)

    out = {
        "tp_mode": rs.tp_mode(arch, mesh),
        "params": {p: form(pspec, p) for p in flat},
        "fsdp": {p: form(fspec, p) for p in flat},
        "opt": {p: form(ospec, p) for p in flat},
        "param_bytes": _device_bytes(flat, pspec, sizes),
        "fsdp_param_bytes": _device_bytes(flat, fspec, sizes),
        "moment_bytes": 2 * _device_bytes(_flat(opt["m"]), ospec, sizes),
        "batch": {}, "cache": {}, "activation": {},
    }
    for cell_name, cell in SHAPES.items():
        if not arch.supports(cell_name):
            continue
        inputs = arch.input_specs(cell_name)
        bspec = rs.batch_specs(inputs, cell, mesh)
        out["batch"][cell_name] = {k: {"shape": list(v.shape), "spec": norm(tuple(bspec[k]))}
                                   for k, v in inputs.items()}
        act = rs.activation_spec(arch, cell, mesh)
        out["activation"][cell_name] = None if act is None else norm(tuple(act))
        if cell.kind == "decode":
            extra = (cell.seq,) if arch.is_encdec() else ()
            caches = jax.eval_shape(
                lambda: arch.init_caches(arch.full, cell.batch, cell.seq, *extra))
            cspec = _flat(rs.cache_specs(caches, arch, cell, mesh), is_spec)
            out["cache"][cell_name] = {p: norm(tuple(cspec[p])[1:]) for p in _flat(caches)}
    return out


def build() -> dict:
    from repro.configs import ARCHS

    return {"meshes": {k: [list(s), list(n)] for k, (s, n) in MESHES.items()},
            "archs": {a: {m: reference_specs(a, m) for m in MESHES} for a in sorted(ARCHS)}}


def main():
    golden = build()
    with open(OUT, "w") as f:
        json.dump(golden, f, indent=0, sort_keys=True)
        f.write("\n")
    print(f"wrote {os.path.relpath(OUT)} ({os.path.getsize(OUT):,} bytes)")


if __name__ == "__main__":
    main()
