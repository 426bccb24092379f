"""EnergyOptimalPlanner: one workload at a time over ``core.engine``.

The canonical planning path is ``engine.PlanningEngine`` — memoized,
batched SVR characterization (``svr.fit_many``), batched grid prediction,
multi-objective argmin, one constraint semantics. This class keeps the
one-workload call ``launch/train --auto-energy`` makes
(``plan_for_workload``) over an engine that falls back to the fastest
config when a deadline is infeasible (``on_infeasible="fastest"``).

``device`` is the engine's torch device: ``None`` is the CUDA device
(raises without one), ``"cpu"`` the host.
"""

from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.core.engine import (
    CHIP_GRID,
    DRYRUN_DIR,
    Constraints,
    EnergyPlan,
    PlanningEngine,
    Workload,
)
from repro_torch.core.power import PowerModel
from repro_torch.core.tpu_power import F_GRID, FleetTelemetry, fit_fleet_power
from repro_torch.device import DeviceLike


class EnergyOptimalPlanner:
    """A ``PlanningEngine`` with the fastest-config fallback, planning one
    (arch, shape cell) at a time."""

    def __init__(
        self,
        power_model: PowerModel,
        *,
        dryrun_dir: str = DRYRUN_DIR,
        noise: float = 0.02,
        seed: int = 0,
        chip_grid: Sequence[int] = CHIP_GRID,
        freq_grid: Sequence[float] = tuple(F_GRID),
        device: DeviceLike = None,
    ):
        self.engine = PlanningEngine(
            power_model,
            freq_grid=freq_grid,
            chip_grid=chip_grid,
            dryrun_dir=dryrun_dir,
            noise=noise,
            seed=seed,
            on_infeasible="fastest",
            device=device,
        )

    @classmethod
    def default(cls, device: DeviceLike = None) -> "EnergyOptimalPlanner":
        return cls(fit_fleet_power(FleetTelemetry()), device=device)

    def plan_for_workload(
        self,
        arch_id: str,
        cell,
        *,
        n_steps: int = 1,
        max_step_time_s: Optional[float] = None,
    ) -> EnergyPlan:
        constraints = (
            Constraints(max_time_s=max_step_time_s)
            if max_step_time_s is not None
            else None
        )
        return self.engine.plan(
            Workload(arch_id, cell, n_steps=n_steps, constraints=constraints)
        )
