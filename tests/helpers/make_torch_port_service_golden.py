"""Write the fleet service's and the apps' goldens from the JAX package.

* ``tests/data/torch_port_service_journal.json``: the journal of
  ``python -m repro.fleet --quick --service --journal F --kill-at 1500``,
  the run killed at sim t = 1,500 s after 19 of its 25 batches, before
  its drift refit (batch 23), which the resumed run then makes;
* ``tests/data/torch_port_service_golden.json``: the same run
  uninterrupted, its completed jobs as the fleet golden's ``job_fields``
  rows, their predicted energies, the batch count, total energy and
  deadline misses;
* ``tests/data/torch_port_apps_golden.npz``: each PARSEC app's outputs at
  its ``DEFAULT_N`` on ``make_inputs(DEFAULT_N, seed=0)``, keyed
  ``<app>/<output>``.

``chip_smoke.py`` resumes the journal on the card and holds the drained
schedule to the golden, and holds the card's apps to the npz. JAX runs on
the CPU:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/helpers/make_torch_port_service_golden.py
"""

import contextlib
import io
import json
import os
import sys
import tempfile

import numpy as np

from repro.apps import APPS
from repro.fleet import __main__ as fleet_main

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
JOURNAL = os.path.join(DATA, "torch_port_service_journal.json")
GOLDEN = os.path.join(DATA, "torch_port_service_golden.json")
APPS_GOLDEN = os.path.join(DATA, "torch_port_apps_golden.npz")
ARGV = ["--quick", "--service"]
KILL_AT_S = 1500.0


def job_rows(sched):
    """The scheduler's completed jobs as the fleet golden's ``job_fields``
    rows (``make_torch_port_fleet_golden.JOB_FIELDS``)."""
    return [
        [c.placement.job.job_id, c.placement.node, c.placement.frequency_ghz,
         c.placement.cores, c.placement.start_s, c.finish_s, c.total_energy_j,
         c.met_deadline, c.migrations, c.placement.pareto_fallback,
         c.placement.negotiated]
        for c in sched.completed
    ]


def _quiet(fn, *args):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args)


def killed_journal() -> dict:
    """The reference's ``--quick --service`` journal, killed at KILL_AT_S."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "journal.json")
        _quiet(fleet_main.main, ARGV + ["--journal", path, "--kill-at", str(KILL_AT_S)])
        with open(path) as f:
            return json.load(f)


def service_record() -> dict:
    """The reference's uninterrupted ``--quick --service`` schedule."""
    from repro.fleet.service import SchedulerService

    kept = {}
    inner = SchedulerService.drain

    def drain(self, **kw):
        kept["service"] = self
        return inner(self, **kw)

    SchedulerService.drain = drain
    try:
        _quiet(fleet_main.main, ARGV)
    finally:
        SchedulerService.drain = inner
    svc = kept["service"]
    sched = svc.scheduler
    return {
        "argv": ARGV,
        "kill_at_s": KILL_AT_S,
        "jobs": job_rows(sched),
        "predicted_energy_j": [c.placement.predicted_energy_j for c in sched.completed],
        "n_batches": svc.n_batches,
        "total_energy_j": sched.total_energy_j(),
        "deadline_misses": sched.deadline_misses(),
    }


def apps_outputs() -> dict:
    out = {}
    for name, mod in sorted(APPS.items()):
        for key, val in mod.run(mod.make_inputs(mod.DEFAULT_N, seed=0)).items():
            out[f"{name}/{key}"] = np.asarray(val)
    return out


def main() -> int:
    with open(JOURNAL, "w") as f:
        json.dump(killed_journal(), f)
    payload = {
        "source": "repro.fleet.__main__.main(['--quick', '--service']) on the JAX CPU backend",
        **service_record(),
    }
    with open(GOLDEN, "w") as f:
        json.dump(payload, f, indent=1)
        f.write("\n")
    np.savez_compressed(APPS_GOLDEN, **apps_outputs())
    for path in (JOURNAL, GOLDEN, APPS_GOLDEN):
        print(f"wrote {os.path.normpath(path)} ({os.path.getsize(path)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
