"""Write tests/data/torch_port_fleet_golden.json from the JAX package.

The fleet simulation at the four settings the port's ``chip_smoke.py``
drives through ``python -m repro_torch.fleet``: the default run (4 nodes,
32 jobs, the paper's grids, seed 0), ``--quick``, ``--quick --horizon 600
--burst 3`` and ``--quick --fallback``. Each package fits its own power
model and its own SVR surfaces, as a user's run does. For each run the
golden keeps the engine scenario's completed jobs in completion order,
every scenario's total energy, makespan and deadline misses, and the
engine scheduler's refit and migration counts.

Under ``mixed``, the mixed CPU + TPU pool (``--quick --mixed``: the zoo's
TPU jobs characterized by the analytic roofline): the lockstep run as
above, and the same run through ``--service --journal`` (its completed
jobs, predicted energies, batch count, total energy and misses) with the
kill point ``chip_smoke.py`` uses, before its middle batch (``--kill-at``
the batch before's sim time): the batch, that sim time, and the batches
and sim clock the killed journal holds.

Under ``auto_energy``, the plan ``python -m repro.launch.train --arch
mamba2-130m --smoke --auto-energy`` logs: ``EnergyOptimalPlanner.default()``
of the run's shape cell (``train``, its default sequence and batch), which
no dry-run artifact covers, so the analytic roofline. JAX runs on the CPU:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/helpers/make_torch_port_fleet_golden.py
"""

import contextlib
import importlib
import io
import json
import os
import sys
import tempfile

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
MIXED_ARGV = ["--quick", "--mixed"]
AUTO_ENERGY_ARGV = ["--arch", "mamba2-130m", "--smoke", "--auto-energy"]
AUTO_ENERGY_CELL = (128, 4)  # launch.train's default --seq and --batch
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
    """``module.main(argv)`` with the engine scenario's scheduler kept
    (``run_fleet_comparison``'s, or ``run_mixed_fleet_comparison``'s for
    ``--mixed``): returns (report, scheduler)."""
    kept = {}
    names = ("run_fleet_comparison", "run_mixed_fleet_comparison")
    inner = {name: getattr(module, name) for name in names}

    def keeping(fn):
        def comparison(*args, **kw):
            report, sched = fn(*args, **kw)
            kept["sched"] = sched
            return report, sched
        return comparison

    for name in names:
        setattr(module, name, keeping(inner[name]))
    try:
        report = module.main(list(argv))
    finally:
        for name in names:
            setattr(module, name, inner[name])
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


def run_service(module, argv):
    """``module.main(argv)`` quietly, with the last ``SchedulerService``
    that drained kept: returns (main's result, the service, what it
    printed)."""
    service_cls = importlib.import_module(
        module.__name__.replace("__main__", "service")).SchedulerService
    kept = {}
    inner = service_cls.drain

    def drain(self, **kw):
        kept["service"] = self
        return inner(self, **kw)

    service_cls.drain = drain
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            result = module.main(list(argv))
    finally:
        service_cls.drain = inner
    return result, kept.get("service"), buf.getvalue()


def kill_point(svc) -> tuple:
    """(k, sim time): ``--kill-at`` that time kills before batch k = n // 2,
    the journal holding k batches."""
    k = svc.n_batches // 2
    return k, svc.scheduler.rounds[k - 1].now


def mixed_service_record(module=fleet_main) -> dict:
    """The ``mixed`` entry's service run with its kill point."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "journal.json")
        _, svc, _ = run_service(module, MIXED_ARGV + ["--service", "--journal", path])
        k, kill_at = kill_point(svc)
        run_service(module, MIXED_ARGV + ["--service", "--journal", path,
                                          "--kill-at", repr(kill_at)])
        with open(path) as f:
            killed = json.load(f)
    sched = svc.scheduler
    return {
        "argv": MIXED_ARGV + ["--service"],
        "jobs": job_rows(sched),
        "predicted_energy_j": [c.placement.predicted_energy_j for c in sched.completed],
        "n_batches": svc.n_batches,
        "total_energy_j": sched.total_energy_j(),
        "deadline_misses": sched.deadline_misses(),
        "kill": {"batch": k, "at_s": kill_at, "committed": killed["n_batches"],
                 "now_s": killed["now_s"]},
    }


def mixed_record(module=fleet_main) -> dict:
    """The ``mixed`` entry: the lockstep run and the service run with its
    kill point."""
    with contextlib.redirect_stdout(io.StringIO()):
        report, sched = run_captured(module, MIXED_ARGV)
    lockstep = dict(argv=list(MIXED_ARGV), **run_record(report, sched))
    return {"lockstep": lockstep, "service": mixed_service_record(module)}


def auto_energy_record() -> dict:
    """The ``auto_energy`` entry: the plan's fields and its summary line."""
    import dataclasses

    from repro.configs.base import ShapeCell
    from repro.core.planner import EnergyOptimalPlanner

    seq, batch = AUTO_ENERGY_CELL
    plan = EnergyOptimalPlanner.default().plan_for_workload(
        arch_id="mamba2-130m", cell=ShapeCell("train", seq, batch, "train"))
    fields = dataclasses.asdict(plan)
    fields["mesh"] = list(fields["mesh"])
    return {"argv": AUTO_ENERGY_ARGV, "summary": plan.summary(), "plan": fields}


def main() -> int:
    runs = []
    for argv in RUNS:
        report, sched = run_captured(fleet_main, argv)
        runs.append(dict(argv=list(argv), **run_record(report, sched)))
    payload = {
        "source": "repro.fleet.__main__.main(argv) on the JAX CPU backend",
        "job_fields": list(JOB_FIELDS),
        "runs": runs,
        "mixed": mixed_record(),
        "auto_energy": auto_energy_record(),
    }
    with open(OUT, "w") as f:
        json.dump(payload, f, indent=1)
        f.write("\n")
    print(f"wrote {len(runs)} runs to {os.path.normpath(OUT)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
