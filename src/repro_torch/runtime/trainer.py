"""Fault-tolerant training runtime, the reference's ``runtime/trainer.py``.

Wraps the train step with the operational machinery a 1000+-node
fleet needs, exercised here single-host:

  * checkpoint/restart: periodic async checkpoints (params, opt state,
    data-pipeline state); on start, resumes from the newest complete one.
  * preemption: SIGTERM/SIGINT triggers checkpoint-then-clean-exit (143);
    the launcher (or a cluster manager) simply restarts the command.
  * straggler telemetry: per-step wall times go into a ring buffer; hosts
    whose rolling median exceeds the fleet median by `mad_k` MADs are
    flagged. Mitigation hooks: (a) deterministic batch re-issue (the data
    pipeline is counter-based, so any host can take over a batch index),
    (b) the EnergyOptimalPlanner is informed so its next re-plan can drop
    the slow pod's frequency/machines from the candidate set.

In the port the step updates the model and optimizer state in place and
returns them; ``try_restore`` copies a checkpoint into them in place. The
elastic re-mesh is ``runtime/elastic.py``'s ``ElasticController``.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

import numpy as np

from repro_torch.checkpoint.manager import CheckpointManager


@dataclasses.dataclass
class StragglerReport:
    host_medians: Dict[int, float]
    fleet_median: float
    stragglers: Dict[int, float]  # host -> slowdown factor


class StragglerDetector:
    """Median-absolute-deviation detector over per-host step times."""

    def __init__(self, n_hosts: int, window: int = 32, mad_k: float = 4.0):
        self.times = {h: deque(maxlen=window) for h in range(n_hosts)}
        self.mad_k = mad_k

    def record(self, host: int, step_time: float):
        self.times[host].append(step_time)

    def report(self) -> StragglerReport:
        med = {
            h: float(np.median(t)) for h, t in self.times.items() if len(t) >= 4
        }
        if not med:
            return StragglerReport({}, 0.0, {})
        fleet = float(np.median(list(med.values())))
        mad = float(np.median([abs(v - fleet) for v in med.values()])) or 1e-9
        stragglers = {
            h: v / fleet
            for h, v in med.items()
            if v - fleet > self.mad_k * mad and v > 1.05 * fleet
        }
        return StragglerReport(med, fleet, stragglers)


class PreemptionHandler:
    """SIGTERM/SIGINT -> set flag; trainer checkpoints and exits cleanly."""

    def __init__(self):
        self.requested = False
        self._installed = False

    def install(self):
        if self._installed:
            return

        def handler(signum, frame):
            self.requested = True

        signal.signal(signal.SIGTERM, handler)
        signal.signal(signal.SIGINT, handler)
        self._installed = True


class Trainer:
    def __init__(
        self,
        *,
        train_step: Callable,  # (model, opt_state, batch) -> (model, opt_state, metrics)
        params,
        opt_state,
        pipeline,
        ckpt_dir: str,
        ckpt_every: int = 50,
        keep: int = 3,
        n_hosts: int = 1,
        on_metrics: Optional[Callable[[int, Dict[str, Any]], None]] = None,
    ):
        self.train_step = train_step
        self.params = params
        self.opt_state = opt_state
        self.pipeline = pipeline
        self.ckpt = CheckpointManager(ckpt_dir, keep=keep)
        self.ckpt_every = ckpt_every
        self.step = 0
        self.preempt = PreemptionHandler()
        self.stragglers = StragglerDetector(n_hosts)
        self.on_metrics = on_metrics
        self.history: list = []

    # -- checkpoint/restart -------------------------------------------------

    def _state(self):
        return {
            "params": self.params,
            "opt_state": self.opt_state,
        }

    def try_restore(self) -> bool:
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        self.ckpt.restore(latest, self._state())  # in place
        man = self.ckpt.manifest(latest)
        self.step = int(man["step"])
        if "pipeline" in man:
            self.pipeline.load_state_dict(man["pipeline"])
        return True

    def save(self, asynchronous: bool = True):
        meta = {"pipeline": self.pipeline.state_dict()}
        if asynchronous:
            self.ckpt.save_async(self.step, self._state(), meta)
        else:
            self.ckpt.save(self.step, self._state(), meta)

    # -- main loop -----------------------------------------------------------

    def run(self, n_steps: int, install_signals: bool = True) -> Dict[str, Any]:
        if install_signals:
            self.preempt.install()
        exit_reason = "completed"
        while self.step < n_steps:
            if self.preempt.requested:
                exit_reason = "preempted"
                break
            batch = self.pipeline.next()
            t0 = time.time()
            self.params, self.opt_state, metrics = self.train_step(
                self.params, self.opt_state, batch
            )
            loss = float(metrics["loss"])
            dt = time.time() - t0
            self.step += 1
            self.stragglers.record(0, dt)
            self.history.append({"step": self.step, "loss": loss, "t": dt})
            if self.on_metrics:
                self.on_metrics(self.step, {**metrics, "step_time_s": dt})
            if self.step % self.ckpt_every == 0:
                self.save(asynchronous=True)
        self.ckpt.wait()
        self.save(asynchronous=False)
        return {
            "exit": exit_reason,
            "step": self.step,
            "straggler_report": self.stragglers.report(),
            "history": self.history,
        }
