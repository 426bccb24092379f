"""The numbers that decide ``correct``: what the program's timed path
produced, held against the plain reference, each number beside its limit.

Training (``train_gaps``), over the first steps of the run:

* ``loss_gap``: the largest |loss - reference loss| / |reference loss| of a
  step;
* ``grad_gap``: the worst leaf's |norm - reference norm| of the first
  gradient as the optimizer took it, over the larger of that leaf's
  reference norm and the median leaf's;
* ``update_gap``: the same of each leaf's change over the steps, leaving
  out the leaves whose reference gradient is under a thousandth of the
  median leaf's (a key's bias under softmax: only round-off moves them).

Serving (``served_gaps``), over a sample of the requests served:

* ``token_gap``: the widest gap by which a served token's reference logit
  lies below the reference's best logit at that position;
* ``kv_gap``: the largest ||K - K_ref|| / ||K_ref|| (and the same of V) of
  the last layer's cache that a prefill hands on.

Limits live in ``chipbench/limits/<workload>.json``, each number's limit
beside the readings it was set from; a number without a limit there is
held to infinity (the run still prints it).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict

RATIO_FLOOR = 1e-3  # leaves whose reference gradient is under this share of the median's


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float]) -> Dict[str, float]:
    """Each leaf's gap; a leaf that is not finite on either side reads inf."""
    median = statistics.median(ref.values())
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30) for k in ref}
    return {k: g if math.isfinite(g) else math.inf for k, g in gaps.items()}


def worst_leaves(prog: dict, ref: dict) -> Dict[str, str]:
    """The leaf behind each leaf-wise number (for the run's log)."""
    moved = _moved(ref)
    out = {}
    for number, key, names in (("grad_gap", "grad_norms", ref["grad_norms"]),
                               ("update_gap", "change_norms", moved)):
        gaps = _leaf_gaps(prog[key], {k: ref[key][k] for k in names})
        out[number] = max(gaps, key=gaps.get) if gaps else ""
    return out


def _moved(ref: dict):
    floor = RATIO_FLOOR * statistics.median(ref["grad_norms"].values())
    return [k for k, g in ref["grad_norms"].items() if g >= floor]


def train_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]) or not all(map(math.isfinite, losses)):
        losses = [math.inf]
    g_ref = ref["grad_norms"]
    if set(prog["grad_norms"]) != set(g_ref) or set(prog["change_norms"]) != set(g_ref):
        return {"loss_gap": max(losses), "grad_gap": math.inf, "update_gap": math.inf}
    change_ref = {k: ref["change_norms"][k] for k in _moved(ref)}
    return {"loss_gap": max(losses),
            "grad_gap": max(_leaf_gaps(prog["grad_norms"], g_ref).values()),
            "update_gap": max(_leaf_gaps(prog["change_norms"], change_ref).values(), default=0.0)}


def verdict(numbers: Dict[str, float], lims: Dict[str, float]) -> dict:
    """{name: {value, limit}} and whether every number is within its limit
    (a NaN is not)."""
    table = {k: {"value": v, "limit": lims.get(k, math.inf)} for k, v in numbers.items()}
    ok = all(v <= t["limit"] for v, t in zip(numbers.values(), table.values()))
    return {"correct": ok, "checks": table}
