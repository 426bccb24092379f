"""Simulator of the paper's case-study node (2× Xeon E5-2698v3, 32 cores).

This container has one CPU core and no IPMI power sensors, so the paper's
measurement substrate — wall-clock times and power draws over the
(frequency × cores × input) grid — is simulated (repro band: "hardware gate
→ simulate"). Ground truth:

* POWER: paper Eq. (9) exactly, plus IPMI-like measurement noise
  (σ = 2.4 W, matching the paper's reported RMSE).
* TIME: a work/span model per application,
      T(f, p, N) = W(N) · (serial(N) + (1-serial(N))/p + χ·(p-1)/p) · κ(f)
  with κ(f) = α/f + (1-α)/f_max  — α is the frequency-scaling (core-bound)
  fraction, (1-α) the memory-bound fraction that does not speed up with the
  clock (the mechanism von DVFS exploits, paper §1); χ a synchronisation/
  contention tax per extra core; serial(N) an Amdahl fraction that shrinks
  with input size (Gustafson). Profiles below are calibrated so the energy
  surfaces reproduce the paper's qualitative results (Figs. 6-9: race-to-idle
  optimum, scalability-dependent optimal core count; Tables 2-5 bands).

Everything the methodology does downstream (stress-fit the power model,
characterize, SVR, minimize, governor comparison) treats this simulator as
an opaque machine: swap `Node` for a real host and nothing else changes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from repro_torch.core.power import PAPER_COEFFS, PowerModel

F_MIN, F_MAX = 1.2, 2.3  # GHz (governors may use turbo-adjacent 2.3)
FREQ_GRID = np.round(np.arange(1.2, 2.25, 0.1), 2)  # the paper's 1.2..2.2 sweep
CORES_PER_SOCKET = 16
MAX_CORES = 32


@dataclasses.dataclass(frozen=True)
class AppProfile:
    """Performance profile of one case-study application."""

    name: str
    work_base_s: float  # seconds of work at f_max, 1 core, input size 1
    work_exp: float  # W(N) = work_base · N^work_exp
    serial0: float  # Amdahl serial fraction at N=1
    serial_shrink: float  # serial(N) = serial0 · N^-serial_shrink
    alpha: float  # core-bound fraction (scales with f)
    chi: float  # per-core sync/contention tax
    util_stall: float  # stall fraction visible to the governor at p=MAX

    def work(self, n: float) -> float:
        return self.work_base_s * float(n) ** self.work_exp

    def serial(self, n: float) -> float:
        return min(0.95, self.serial0 * float(n) ** (-self.serial_shrink))

    def span_factor(self, p: int, n: float) -> float:
        s = self.serial(n)
        return s + (1.0 - s) / p + self.chi * (p - 1) / p

    def kappa(self, f: float) -> float:
        return self.alpha / f + (1.0 - self.alpha) / F_MAX

    def time(self, f: float, p: int, n: float) -> float:
        return self.work(n) * self.span_factor(p, n) * self.kappa(f) * F_MAX

    def utilization(self, f: float, p: int, n: float) -> float:
        """Busy fraction the kernel's governor would observe: memory stalls
        and sync waits idle the core. Higher f => more stall-dominated."""
        busy = self.alpha / f
        stall = (1.0 - self.alpha) / F_MAX + self.util_stall * (p - 1) / (
            MAX_CORES - 1
        ) / f
        return float(np.clip(busy / (busy + stall), 0.05, 1.0))


# Calibrated to reproduce the paper's qualitative behaviour:
#  - blackscholes: embarrassingly parallel, strongly core-bound, tiny inputs
#    -> optimum at ~30 cores / max f; Ondemand best-case occasionally beats
#    the model (paper Table 5 has negative savings).
#  - fluidanimate: scalable but sync-taxed (SPH neighbour lists).
#  - raytrace: memory-bound (scene traversal), scalability grows with input
#    (paper Table 3: optimal cores 6 -> 26 as input grows).
#  - swaptions: MC pricing, compute-bound, near-perfect scaling.
PROFILES = {
    "blackscholes": AppProfile(
        name="blackscholes",
        work_base_s=260.0,
        work_exp=1.0,
        serial0=0.015,
        serial_shrink=0.3,
        alpha=0.92,
        chi=0.004,
        util_stall=0.05,
    ),
    "fluidanimate": AppProfile(
        name="fluidanimate",
        work_base_s=1500.0,
        work_exp=1.0,
        serial0=0.03,
        serial_shrink=0.2,
        alpha=0.80,
        chi=0.006,
        util_stall=0.25,
    ),
    "raytrace": AppProfile(
        name="raytrace",
        work_base_s=1900.0,
        work_exp=0.8,
        serial0=0.40,
        serial_shrink=1.1,
        alpha=0.75,
        chi=0.003,
        util_stall=0.45,
    ),
    "swaptions": AppProfile(
        name="swaptions",
        work_base_s=2600.0,
        work_exp=0.35,
        serial0=0.01,
        serial_shrink=0.1,
        alpha=0.95,
        chi=0.002,
        util_stall=0.03,
    ),
}

INPUT_SIZES = (1.0, 2.0, 3.0, 4.0, 5.0)


@dataclasses.dataclass
class RunResult:
    time_s: float
    energy_j: float
    mean_freq_ghz: float
    mean_power_w: float
    freq_trace: np.ndarray
    power_trace: np.ndarray


class Node:
    """The simulated machine: run stress tests, run applications (under a
    fixed frequency or a governor), return IPMI-like measurements."""

    def __init__(
        self,
        seed: int = 0,
        power_coeffs=PAPER_COEFFS,
        power_noise_w: float = 2.4,
        time_noise: float = 0.01,
        cores_per_socket: int = CORES_PER_SOCKET,
    ):
        self._truth = PowerModel(*power_coeffs)
        self.rng = np.random.default_rng(seed)
        self.power_noise_w = power_noise_w
        self.time_noise = time_noise
        # the static-power granularity of Eq. 7's s(p) term: cores per
        # socket on the Xeon node (16), chips per pod when the same truth
        # model stands in for a TPU slice (fleet mixed pools)
        self.cores_per_socket = int(cores_per_socket)

    # -- measurement substrate -------------------------------------------

    def sockets(self, p: int) -> int:
        return int(np.ceil(p / self.cores_per_socket))

    def measure_power(self, f: float, p: int, n_samples: int = 30) -> np.ndarray:
        """IPMI samples (1 Hz) under a full-load stress at (f, p) — §3.3."""
        base = float(self._truth(f, p, self.sockets(p)))
        return base + self.rng.normal(0.0, self.power_noise_w, size=n_samples)

    def stress_grid(self, freqs=FREQ_GRID, cores=range(1, MAX_CORES + 1)):
        """Full §3.3 stress sweep -> (f, p, s, watts) sample arrays."""
        fs, ps, ss, ws = [], [], [], []
        for f in freqs:
            for p in cores:
                samples = self.measure_power(float(f), int(p))
                for w in samples:
                    fs.append(float(f))
                    ps.append(int(p))
                    ss.append(self.sockets(int(p)))
                    ws.append(float(w))
        return (
            np.asarray(fs, np.float32),
            np.asarray(ps, np.float32),
            np.asarray(ss, np.float32),
            np.asarray(ws, np.float32),
        )

    # -- application runs --------------------------------------------------

    def run_fixed(self, app: str, f: float, p: int, n: float) -> RunResult:
        """Run `app` pinned at frequency f with p active cores (Userspace)."""
        prof = PROFILES[app]
        t = prof.time(f, p, n) * (1.0 + self.rng.normal(0.0, self.time_noise))
        t = max(t, 1e-3)
        n_samples = max(2, int(round(t)))
        power_w = float(self._truth(f, p, self.sockets(p))) + self.rng.normal(
            0.0, self.power_noise_w, size=n_samples
        )
        e = float(np.mean(power_w) * t)
        return RunResult(
            time_s=t,
            energy_j=e,
            mean_freq_ghz=f,
            mean_power_w=float(np.mean(power_w)),
            freq_trace=np.full(n_samples, f),
            power_trace=power_w,
        )

    def run_governor(
        self,
        app: str,
        governor,
        p: int,
        n: float,
        tick_s: float = 1.0,
        max_ticks: int = 500_000,
    ) -> RunResult:
        """Run `app` under a DVFS governor (see core.governor): per tick the
        governor observes utilization and picks the next frequency; work
        progresses at the profile's rate for that frequency."""
        prof = PROFILES[app]
        total = prof.time(F_MAX, p, n) * (
            1.0 + self.rng.normal(0.0, self.time_noise)
        )  # work expressed as seconds-at-f_max
        done = 0.0
        t = 0.0
        freqs, powers = [], []
        governor.reset()
        f = governor.initial_frequency()
        for _ in range(max_ticks):
            util = prof.utilization(f, p, n) * (
                1.0 + self.rng.normal(0.0, 0.02)
            )
            f = governor.next_frequency(min(max(util, 0.0), 1.0))
            # progress: time-at-fmax equivalent accomplished this tick
            rate = prof.kappa(F_MAX) / prof.kappa(f)
            step = min(tick_s * rate, total - done)
            done += step
            t += step / rate
            freqs.append(f)
            powers.append(
                float(self._truth(f, p, self.sockets(p)))
                + float(self.rng.normal(0.0, self.power_noise_w))
            )
            if done >= total - 1e-12:
                break
        freqs_arr = np.asarray(freqs)
        powers_arr = np.asarray(powers)
        # mean power × exact elapsed time (handles the last partial tick)
        e = float(np.mean(powers_arr) * t)
        return RunResult(
            time_s=t,
            energy_j=e,
            mean_freq_ghz=float(np.mean(freqs_arr)),
            mean_power_w=float(np.mean(powers_arr)),
            freq_trace=freqs_arr,
            power_trace=powers_arr,
        )
