"""Closed-loop evaluation: engine plans vs the stock Linux governors.

The paper's headline (§4.2, Tables 2-5, Fig. 10) is that the energy-optimal
configuration beats the stock ``acpi-cpufreq`` governors by up to ~14× when
the governor runs at an unlucky core count and by single-digit percent at
its best. This module closes the characterize → fit → plan → compare loop
as one engine-driven path:

  1. fit the node power model from the §3.3 stress sweep,
  2. characterize every application with ``CharacterizationSet.from_node``
     and fit all SVR surfaces in ONE ``svr.fit_many`` batch,
  3. plan each (app, input) with the unified ``core.engine`` argmin
     (``energy.minimize_energy`` → ``solve_grid``; objective selectable),
  4. run the plan *and* each stock governor (performance / powersave /
     ondemand / conservative) on the node simulator via
     ``node_sim.Node.run_governor`` and report measured energy ratios.

Governors are pinned to the same frequency table the planner searched
(the paper pins the DVFS range for both sides); measured energies can be
averaged over ``repeats`` runs to tame the simulated IPMI / timing noise.
The SVR fit's Gram build and every plan's grid prediction run on the card
(``device=None``); the power fit, the KKT solves, the argmin and the
governor simulation run on the host.
``python -m repro_torch.core.evaluate [--quick] [--device cpu]`` prints the
Table-2-style report.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core import energy, power
from repro_torch.core.characterize import CharacterizationSet
from repro_torch.core.governor import (
    ConservativeGovernor,
    OndemandGovernor,
    PerformanceGovernor,
    PowersaveGovernor,
)
from repro_torch.core.node_sim import FREQ_GRID, INPUT_SIZES, MAX_CORES, Node, PROFILES
from repro_torch.device import DeviceLike, resolve_device

STOCK_GOVERNORS = ("performance", "powersave", "ondemand", "conservative")


def make_governor(name: str, freq_table=None):
    """One stock governor by its cpufreq name (shared frequency table)."""
    if name == "performance":
        return PerformanceGovernor(freq_table)
    if name == "powersave":
        return PowersaveGovernor(freq_table)
    if name == "ondemand":
        return OndemandGovernor(freq_table=freq_table)
    if name == "conservative":
        return ConservativeGovernor(freq_table=freq_table)
    raise ValueError(f"unknown governor {name!r}; want {STOCK_GOVERNORS}")


@dataclasses.dataclass(frozen=True)
class PlanRun:
    """The engine's chosen configuration for one (app, input), as measured."""

    app: str
    input_size: float
    frequency_ghz: float
    cores: int
    predicted_energy_j: float
    time_s: float
    energy_j: float


@dataclasses.dataclass(frozen=True)
class GovernorRun:
    """One stock-governor run, plus its energy ratio vs the engine plan."""

    app: str
    input_size: float
    governor: str
    cores: int
    time_s: float
    energy_j: float
    ratio: float  # governor energy / plan energy (> 1: plan wins)


@dataclasses.dataclass
class ComparisonReport:
    """Paper-Table-2-style report over (app × input × governor × cores)."""

    plans: List[PlanRun]
    runs: List[GovernorRun]
    objective: str = "energy"

    # summary ratios are NaN (not an error) on an empty run set: fleet
    # reports over artifact traces have plans but no governor runs
    @property
    def worst_case_ratio(self) -> float:
        return max((r.ratio for r in self.runs), default=float("nan"))

    @property
    def best_case_ratio(self) -> float:
        return min((r.ratio for r in self.runs), default=float("nan"))

    @property
    def mean_ratio(self) -> float:
        ratios = [r.ratio for r in self.runs]
        return float(np.mean(ratios)) if ratios else float("nan")

    def ratios_by_governor(self) -> Dict[str, Tuple[float, float, float]]:
        """{governor: (best, mean, worst) energy ratio vs the plan}."""
        out = {}
        for g in sorted({r.governor for r in self.runs}):
            rs = [r.ratio for r in self.runs if r.governor == g]
            out[g] = (min(rs), float(np.mean(rs)), max(rs))
        return out

    def plan_beats_all(self, tol: float = 0.02) -> bool:
        """Paper ordering: the plan uses <= energy of every governor run
        (tol absorbs residual measurement noise on exact ties)."""
        return self.best_case_ratio >= 1.0 - tol

    def table(self) -> str:
        """Render the Tables 2-5 analogue."""
        lines = [
            f"{'app':<14}{'N':>3}  {'plan':>14}  {'E kJ':>8}   "
            + "".join(f"{g:>14}" for g in STOCK_GOVERNORS),
            "-" * (43 + 14 * len(STOCK_GOVERNORS)),
        ]
        for p in self.plans:
            by_gov = {}
            for r in self.runs:
                if (r.app, r.input_size) == (p.app, p.input_size):
                    by_gov.setdefault(r.governor, []).append(r.ratio)
            cells = "".join(
                f"{min(by_gov[g]):>6.2f}/{max(by_gov[g]):<6.2f} "
                if g in by_gov
                else f"{'-':>14}"
                for g in STOCK_GOVERNORS
            )
            lines.append(
                f"{p.app:<14}{int(p.input_size):>3}  "
                f"{p.frequency_ghz:>5.1f}GHz x{p.cores:>3}c  "
                f"{p.energy_j / 1e3:>8.2f}   {cells}"
            )
        lines.append(
            f"governor/plan energy ratios (best/worst per row); "
            f"suite worst-case {self.worst_case_ratio:.2f}x, "
            f"mean {self.mean_ratio:.2f}x, best {self.best_case_ratio:.2f}x"
        )
        return "\n".join(lines)

    def to_json(self) -> dict:
        return {
            "objective": self.objective,
            "worst_case_ratio": self.worst_case_ratio,
            "best_case_ratio": self.best_case_ratio,
            "mean_ratio": self.mean_ratio,
            "ratios_by_governor": {
                g: {"best": b, "mean": m, "worst": w}
                for g, (b, m, w) in self.ratios_by_governor().items()
            },
            "plans": [dataclasses.asdict(p) for p in self.plans],
            "runs": [dataclasses.asdict(r) for r in self.runs],
        }

    @classmethod
    def from_json(cls, payload: dict) -> "ComparisonReport":
        """Round-trip loader for ``to_json`` output.

        The one serialization path for node- and fleet-scale reports
        (``fleet.report.FleetReport`` embeds a ``ComparisonReport`` payload
        and loads it through here). Derived summary fields in the payload
        are ignored — they are recomputed from the records; unknown keys in
        plan/run records are dropped so newer payloads load on older code.
        """
        plan_fields = {f.name for f in dataclasses.fields(PlanRun)}
        run_fields = {f.name for f in dataclasses.fields(GovernorRun)}
        return cls(
            plans=[
                PlanRun(**{k: v for k, v in p.items() if k in plan_fields})
                for p in payload.get("plans", ())
            ],
            runs=[
                GovernorRun(**{k: v for k, v in r.items() if k in run_fields})
                for r in payload.get("runs", ())
            ],
            objective=payload.get("objective", "energy"),
        )


def _mean_energy(runs) -> Tuple[float, float]:
    return (
        float(np.mean([r.energy_j for r in runs])),
        float(np.mean([r.time_s for r in runs])),
    )


def compare_governors(
    node: Node,
    apps: Optional[Sequence[str]] = None,
    input_sizes: Sequence[float] = INPUT_SIZES,
    *,
    objective: str = "energy",
    power_model=None,
    char_freqs: Sequence[float] = tuple(FREQ_GRID),
    char_cores: Iterable[int] = tuple(range(1, MAX_CORES + 1)),
    char_inputs: Optional[Sequence[float]] = None,
    governor_cores: Sequence[int] = (1, 4, 8, 16, 24, 32),
    governors: Sequence[str] = STOCK_GOVERNORS,
    repeats: int = 1,
    device: DeviceLike = None,
) -> ComparisonReport:
    """Run the full closed loop on one node and return the report.

    ``char_*`` control the characterization sweep (reduce for quick runs);
    ``governor_cores`` is the core-count sweep each governor is run at (the
    governor only manages frequency — core count is whatever the user ran
    with, which is exactly the paper's worst-case lever). ``device`` is where
    the SVR models are fitted and evaluated (``None``: the CUDA device).
    """
    device = resolve_device(device)
    apps = list(apps if apps is not None else sorted(PROFILES))
    char_inputs = tuple(char_inputs if char_inputs is not None else input_sizes)
    freq_table = np.asarray(char_freqs, float)

    if power_model is None:
        power_model = power.fit_power_model(*node.stress_grid())

    # 2. one batched characterization + fit for the whole suite
    cset = CharacterizationSet.from_node(
        node, apps, freqs=char_freqs, cores=char_cores, input_sizes=char_inputs
    )
    models = cset.models_by_app(device=device)

    plans: List[PlanRun] = []
    runs: List[GovernorRun] = []
    for app in apps:
        for n in input_sizes:
            cfg = energy.minimize_energy(
                power_model,
                models[app],
                frequencies=char_freqs,
                cores=range(1, MAX_CORES + 1),
                input_size=n,
                objective=objective,
            )
            e_plan, t_plan = _mean_energy(
                [
                    node.run_fixed(app, cfg.frequency_ghz, cfg.cores, n)
                    for _ in range(repeats)
                ]
            )
            plans.append(
                PlanRun(
                    app=app,
                    input_size=float(n),
                    frequency_ghz=cfg.frequency_ghz,
                    cores=cfg.cores,
                    predicted_energy_j=cfg.predicted_energy_j,
                    time_s=t_plan,
                    energy_j=e_plan,
                )
            )
            for gname in governors:
                gov = make_governor(gname, freq_table)
                for p in governor_cores:
                    e_gov, t_gov = _mean_energy(
                        [
                            node.run_governor(app, gov, int(p), n)
                            for _ in range(repeats)
                        ]
                    )
                    runs.append(
                        GovernorRun(
                            app=app,
                            input_size=float(n),
                            governor=gname,
                            cores=int(p),
                            time_s=t_gov,
                            energy_j=e_gov,
                            ratio=e_gov / e_plan,
                        )
                    )
    return ComparisonReport(plans=plans, runs=runs, objective=objective)


def main(argv: Optional[Sequence[str]] = None) -> ComparisonReport:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="reduced sweep grids")
    ap.add_argument("--objective", choices=("energy", "edp", "ed2p"),
                    default="energy")
    ap.add_argument("--repeats", type=int, default=None)
    ap.add_argument("--json", help="write the full report to this path")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs on the host)")
    args = ap.parse_args(argv)

    node = Node(seed=args.seed)
    kw = dict(objective=args.objective, device=args.device)
    if args.quick:
        kw.update(
            char_freqs=FREQ_GRID[::2],
            char_cores=range(1, MAX_CORES + 1, 2),
            input_sizes=(1.0, 3.0, 5.0),
            governor_cores=(1, 8, 32),
            repeats=args.repeats or 1,
        )
    else:
        kw.update(repeats=args.repeats or 3)
    report = compare_governors(node, **kw)
    obs.log(report.table())
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report.to_json(), f, indent=1)
    return report


if __name__ == "__main__":
    main()
