"""Write tests/data/torch_port_fleet_golden.json from the JAX package.

The fleet simulation at the four settings the port's ``chip_smoke.py``
drives through ``python -m repro_torch.fleet``: the default run (4 nodes,
32 jobs, the paper's grids, seed 0), ``--quick``, ``--quick --horizon 600
--burst 3`` and ``--quick --fallback``. Each package fits its own power
model and its own SVR surfaces, as a user's run does. For each run the
golden keeps the engine scenario's completed jobs in completion order,
every scenario's total energy, makespan and deadline misses, and the
engine scheduler's refit and migration counts. JAX runs on the CPU:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/helpers/make_torch_port_fleet_golden.py
"""

import json
import os
import sys

from repro.fleet import __main__ as fleet_main

OUT = os.path.join(
    os.path.dirname(__file__), "..", "data", "torch_port_fleet_golden.json"
)
RUNS = (
    [],
    ["--quick"],
    ["--quick", "--horizon", "600", "--burst", "3"],
    ["--quick", "--fallback"],
)
# a completed job's fields, in the order each row keeps them
JOB_FIELDS = (
    "job_id", "node", "frequency_ghz", "cores", "start_s", "finish_s",
    "total_energy_j", "met_deadline", "migrations", "pareto_fallback",
    "negotiated",
)


def job_rows(sched):
    """The engine scheduler's completed jobs as ``JOB_FIELDS`` rows."""
    return [
        [c.placement.job.job_id, c.placement.node, c.placement.frequency_ghz,
         c.placement.cores, c.placement.start_s, c.finish_s, c.total_energy_j,
         c.met_deadline, c.migrations, c.placement.pareto_fallback,
         c.placement.negotiated]
        for c in sched.completed
    ]


def run_captured(module, argv):
    """``module.main(argv)`` with the engine scenario's scheduler kept:
    returns (report, scheduler)."""
    kept = {}
    inner = module.run_fleet_comparison

    def comparison(*args, **kw):
        report, sched = inner(*args, **kw)
        kept["sched"] = sched
        return report, sched

    module.run_fleet_comparison = comparison
    try:
        report = module.main(list(argv))
    finally:
        module.run_fleet_comparison = inner
    return report, kept["sched"]


def run_record(report, sched) -> dict:
    return {
        "jobs": job_rows(sched),
        "predicted_energy_j": [c.placement.predicted_energy_j for c in sched.completed],
        "scenarios": {
            name: {
                "total_energy_j": s.total_energy_j,
                "makespan_s": s.makespan_s,
                "deadline_misses": s.deadline_misses,
            }
            for name, s in report.scenarios.items()
        },
        "refits": sched.telemetry.n_recharacterizations,
        "migrations": sched.migrations(),
    }


def main() -> int:
    runs = []
    for argv in RUNS:
        report, sched = run_captured(fleet_main, argv)
        runs.append(dict(argv=list(argv), **run_record(report, sched)))
    payload = {
        "source": "repro.fleet.__main__.main(argv) on the JAX CPU backend",
        "job_fields": list(JOB_FIELDS),
        "runs": runs,
    }
    with open(OUT, "w") as f:
        json.dump(payload, f, indent=1)
        f.write("\n")
    print(f"wrote {len(runs)} runs to {os.path.normpath(OUT)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
