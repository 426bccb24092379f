"""One run of one cell: set-up, the measured window, the check, and the
result line's contents.

``run_cell`` takes the cell's entry from ``BENCHMARK.json``, its
configuration and traffic files, and drives the traffic's entry
(``chipbench/entries/<entry>.py``), which returns its end-to-end values,
the numbers the check compares and, in a traced run, what each step or
batch recorded. The per-layer metrics are then read by
``chipbench/metrics/<name>.py`` from that record and the profiler's trace.
"""

from __future__ import annotations

import gc
import time
from typing import Optional

import torch

from chipbench import check, spec, trace


class Context:
    """What an entry gets: the cell's files, the run's arguments, and the
    harness's hooks for the window's edges and the profiler."""

    def __init__(self, cfg, traffic, seed, seconds, trace_on, device, t_start):
        self.cfg, self.traffic = cfg, traffic
        self.seed, self.seconds, self.trace, self.device = seed, seconds, trace_on, device
        self.t_start = t_start
        self.cuda = torch.device(device).type == "cuda"
        self.setup_s = None
        self.peak_bytes = None
        self.window_peak_bytes = None
        self.profile = None  # the traced stretch of the window, once closed
        self._prof = None

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def mark_window_start(self) -> None:
        """Set-up ends here: everything built, warmed and synchronised."""
        self.window_start = time.perf_counter()
        self.setup_s = self.window_start - self.t_start
        if self.cuda:
            self.peak_bytes = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()

    def window_closed(self) -> None:
        self.sync()
        self.window_end = time.perf_counter()
        if self._prof is not None:
            self._stop_profile()
        if self.cuda:
            self.window_peak_bytes = torch.cuda.max_memory_allocated()
            self.peak_bytes = max(self.peak_bytes, self.window_peak_bytes)

    def free(self) -> None:
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def warm_profiler(self) -> None:
        """In a traced run, start and stop the profiler once in set-up: its
        first start in a process (CUPTI's) takes seconds."""
        if self.trace:
            from torch.profiler import profile

            with profile(activities=trace.activities(self.device)):
                torch.ones(1, device=self.device).add_(1)
                self.sync()

    def before_step(self, k: int) -> None:
        """Before the window's step (or batch) k: the profiler starts at the
        first of the traffic's ``trace_steps`` steps, from the second on."""
        if self.traced(k) and self._prof is None:
            from torch.profiler import profile

            self.sync()
            self._prof = profile(activities=trace.activities(self.device))
            self._prof.__enter__()

    def traced(self, k: int) -> bool:
        return self.trace and 1 <= k <= self.traffic["trace_steps"]

    def after_step(self, k: int) -> None:
        if self._prof is not None and not self.traced(k + 1):
            self._stop_profile()

    def _stop_profile(self) -> None:
        self.sync()
        self._prof.__exit__(None, None, None)
        self.profile, self._prof = self._prof, None


def run_cell(workload: str, seed: int, seconds: float, trace_on: bool, *,
             device: str = "cuda", t_start: Optional[float] = None, bench=None,
             cfg: Optional[dict] = None, traffic: Optional[dict] = None) -> dict:
    """The result of one run (without the device checks ``run.py`` makes);
    ``cfg`` and ``traffic`` stand in for the cell's files where given."""
    bench = bench or spec.Spec()
    cell = bench.workload(workload)
    cfg = cfg or bench.config(cell["config"])
    traffic = traffic or bench.traffic(cell["traffic"])
    ctx = Context(cfg, traffic, seed, seconds, trace_on, device,
                  time.perf_counter() if t_start is None else t_start)
    out = bench.load("entries", traffic["entry"]).run(ctx)
    phases = {"setup": ctx.setup_s, "window": ctx.window_end - ctx.window_start,
              "check": time.perf_counter() - ctx.window_end}
    verdict = check.verdict(out["numbers"], bench.limits(workload))
    metrics = {}
    dev = {"platform": "gpu" if ctx.cuda else "cpu",
           "kind": torch.cuda.get_device_name() if ctx.cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": ctx.peak_bytes}
    result = {"correct": verdict["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if not trace_on:
        values = dict(out["e2e"], setup_s=ctx.setup_s)
        for m in bench.end_to_end(workload):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        reduced = trace.reduce(ctx.profile)
        record = {"config": cfg, "traffic": traffic, "workload": workload,
                  "steps": out["steps"], "trace": reduced,
                  "peak_bytes": ctx.window_peak_bytes}
        for m in bench.per_layer(workload):
            value = bench.load("metrics", m["name"]).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev.update(busy_s=reduced["busy_s"], window_s=reduced["window_s"])
        result["breakdown"] = {"device_ops": reduced["device_ops"],
                               "idle_gaps": reduced["idle_gaps"]}
    if trace_on:
        phases["trace"] = time.perf_counter() - ctx.window_end - phases["check"]
    result["phases_s"] = phases
    result["checks"] = verdict["checks"]
    return result

