"""The limits the port's dry-run records are held to against the
reference's (``tests/data/torch_port_dryrun_golden.json``), for
``tests/test_torch_dryrun.py`` and ``chip_smoke.py`` phase 11. Imports no
JAX and nothing of the port.

Every metric of a cell outside its limit is recorded in
``tests/data/torch_port_dryrun_exceptions.json``
(``make_torch_port_dryrun_exceptions.py`` writes it; ROADMAP §C lists
the classes): its class of gap (``CLASSES``), the reference's count, and
the port's count under each torch version it was counted with. A record
must be outside exactly where the file says, and each recorded metric
must equal the port's recorded count for the running torch version
(``drift``): a new gap, a stale entry and a count that moved all fail, so
that writing the file anew is the only way to move a listed count. The
counts are kept a torch version each because DTensor's propagation
differs between versions (the MoE train cells' collectives, a few bytes of
scalar reductions elsewhere).
"""

import json
import os

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
GOLDEN = os.path.join(DATA, "torch_port_dryrun_golden.json")
RECORDED = os.path.join(DATA, "torch_port_dryrun_exceptions.json")
with open(RECORDED) as _f:
    _RECORDED = json.load(_f)
CLASSES = _RECORDED["classes"]
CELLS = _RECORDED["cells"]  # cell -> {metric: {class, reference, port: {version: count}}}
EXCEPTIONS = {cell: {metric: entry["class"] for metric, entry in metrics.items()}
              for cell, metrics in CELLS.items()}
# a listed count against the recorded one: shape arithmetic, exact but for
# the order of float sums
DRIFT_REL = 1e-9


def torch_version() -> str:
    """"major.minor" of the torch this process runs."""
    import torch

    return ".".join(torch.__version__.split("+")[0].split(".")[:2])


FLOPS_REL = 0.05  # flops_per_device within 5%
BYTES_FACTOR = 2.0  # memory and each collective kind's bytes within 2x

# qwen1.5-110b's 80 head-split attn.q.b moments stay whole over "data" in
# the port (sharding.zero1_spec, ROADMAP §C): bytes a device above the
# reference's
ZERO1_EXTRA = {"qwen1.5-110b__train_4k__pod": 307_200,
               "qwen1.5-110b__train_4k__multipod": 307_200}


def load_golden() -> dict:
    with open(GOLDEN) as f:
        return json.load(f)


def ratio(port: float, ref: float) -> float:
    if ref == 0:
        return 1.0 if port == 0 else float("inf")
    return port / ref


def kind_of(key: str) -> str:
    """"train", "prefill" or "decode" from a record key's shape."""
    shape = key.split("__")[1]
    for kind in ("train", "prefill"):
        if kind in shape:
            return kind
    return "decode"


def argument_delta(key: str, arch, cfg) -> int:
    """The port's argument bytes a device less the reference's for the
    cell ``key`` of ``arch`` (a port ``ArchDef``) at ``cfg`` (ROADMAP §C):
    the AdamW step counter is int64 (the reference's int32); each
    attention cache's position is a host int (the reference's an int32 a
    layer); the ZeRO-1 bytes of ``ZERO1_EXTRA``."""
    kind = kind_of(key)
    if kind == "train":
        return 4 + ZERO1_EXTRA.get(key, 0)
    if kind == "decode":
        enc = dict(enc_len=2) if arch.is_encdec() else {}
        caches = arch.init_caches(cfg, 1, 2, device="meta", **enc)
        flat = [v for c in caches for v in (c.values() if "idx" not in c else [c])]
        return -4 * sum(1 for v in flat if isinstance(v, dict) and "idx" in v)
    return 0


def gaps(port: dict, ref: dict) -> dict:
    """{metric: (port, reference)} for every metric of a record outside
    its limit: "flops", "memory", "collective:<kind>" (a kind either side
    issues)."""
    ph, rh = port["hlo"], ref["hlo"]
    out = {}
    if abs(ratio(ph["flops_per_device"], rh["flops_per_device"]) - 1) > FLOPS_REL:
        out["flops"] = (ph["flops_per_device"], rh["flops_per_device"])
    pairs = {"memory": (ph["memory_bytes_per_device"], rh["memory_bytes_per_device"])}
    for kind in sorted(set(ph["collectives"]) | set(rh["collectives"])):
        pairs[f"collective:{kind}"] = (ph["collectives"].get(kind, 0.0),
                                       rh["collectives"].get(kind, 0.0))
    for name, (p, r) in pairs.items():
        q = ratio(p, r)
        if not 1 / BYTES_FACTOR <= q <= BYTES_FACTOR:
            out[name] = (p, r)
    return out


def metric_value(rec: dict, metric: str) -> float:
    """A record's count of ``metric`` ("flops", "memory",
    "collective:<kind>")."""
    h = rec["hlo"]
    if metric == "flops":
        return h["flops_per_device"]
    if metric == "memory":
        return h["memory_bytes_per_device"]
    return h["collectives"].get(metric.split(":", 1)[1], 0.0)


def drift(key: str, port: dict, ref: dict, version: str) -> list:
    """Messages for each recorded metric of cell ``key`` whose count in the
    port's record ``port`` is not the recorded one for torch ``version``
    (or none is recorded for it), or whose reference count is not the
    golden record ``ref``'s; empty when all hold."""
    bad = []
    for metric, entry in CELLS.get(key, {}).items():
        if entry["reference"] != metric_value(ref, metric):
            bad.append(f"{key} {metric}: the reference's {metric_value(ref, metric)!r}, "
                       f"recorded {entry['reference']!r}")
        want = entry["port"].get(version)
        got = metric_value(port, metric)
        if want is None:
            bad.append(f"{key} {metric}: no count recorded for torch {version} "
                       f"(recorded: {sorted(entry['port'])}); this run counts {got!r}")
        elif abs(got - want) > DRIFT_REL * max(abs(want), 1.0):
            bad.append(f"{key} {metric}: the port counts {got!r}, recorded {want!r} "
                       f"under torch {version}")
    return bad
