"""Deterministic, seeded fault schedules for the fleet service.

The fault-injection harness behind ``tests/test_torch_service.py`` and the
crash-recovery sweeps: a seed maps to ONE reproducible fault
(``single_fault_schedule``) and ``inject`` arms it on a live
``SchedulerService``. Three fault kinds cover the service's failure
surface:

* ``node-down`` — a node crashes mid-run (in-flight segments killed,
  burned joules carried, jobs requeued) and later recovers;
* ``heartbeat-loss`` — a manager goes silent; the node keeps running but
  the service must *declare* it down after the heartbeat timeout
  (requires the service to be built with ``heartbeat_period_s`` set);
* ``journal-torn`` — the journal write is killed between snapshot and
  commit (``Journal.tear_at_s``): the commit raises ``JournalTorn`` (the
  simulated process death) and recovery must proceed from the previous
  commit (requires a journal).

The property the harness exists to check (``test_torch_service.py``): any
single-fault schedule still ends with **zero lost jobs** and an honest,
paper-units energy ledger (every ``_j`` total equals final segments plus
carried priors).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.fleet.service import events as ev

FAULT_KINDS: Tuple[str, ...] = ("node-down", "heartbeat-loss", "journal-torn")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault (times in sim seconds)."""

    kind: str
    time_s: float
    node: Optional[str] = None  # node-down / heartbeat-loss target
    recover_s: Optional[float] = None  # node-up time (node-down only)


def single_fault_schedule(
    seed: int,
    *,
    nodes: Sequence[str],
    t_lo_s: float,
    t_hi_s: float,
    kinds: Sequence[str] = FAULT_KINDS,
) -> FaultSpec:
    """The seed's single fault: kind, landing time and target are all
    drawn from ``default_rng(seed)`` — same seed, same fault, always."""
    rng = np.random.default_rng(seed)
    kind = kinds[int(rng.integers(len(kinds)))]
    time_s = float(rng.uniform(t_lo_s, t_hi_s))
    node = None
    if kind in ("node-down", "heartbeat-loss"):
        node = nodes[int(rng.integers(len(nodes)))]
    recover_s = None
    if kind == "node-down":
        # the node comes back within a bounded window so permanently-lost
        # capacity can never make "zero lost jobs" vacuously unplaceable
        recover_s = time_s + float(rng.uniform(0.25, 1.0)) * (t_hi_s - t_lo_s)
    return FaultSpec(kind=kind, time_s=time_s, node=node, recover_s=recover_s)


def inject(service, fault: FaultSpec) -> None:
    """Arm one fault on a live (not yet drained) ``SchedulerService``."""
    if fault.kind == "node-down":
        service.inject(ev.node_down(fault.time_s, fault.node))
        if fault.recover_s is not None:
            service.inject(ev.node_up(fault.recover_s, fault.node))
    elif fault.kind == "heartbeat-loss":
        if service.heartbeat_period_s is None:
            raise ValueError(
                "heartbeat-loss needs a service built with "
                "heartbeat_period_s set"
            )
        service.managers[fault.node].silence_after_s = fault.time_s
    elif fault.kind == "journal-torn":
        if service.journal is None:
            raise ValueError("journal-torn needs a service with a journal")
        service.journal.tear_at_s = fault.time_s
    else:
        raise ValueError(f"unknown fault kind {fault.kind!r}")
