"""Linux cpufreq governor simulators (paper §3.2, §4.2 baseline).

Implements the decision rules of the stock `acpi-cpufreq` governors the
paper compares against:

* **Performance / Powersave** — static max / min frequency.
* **Userspace** — fixed user-chosen frequency.
* **Ondemand** — the kernel's rule: if observed load meets or exceeds
  ``up_threshold`` jump straight to f_max; otherwise pick the lowest
  frequency that keeps the projected load under the threshold
  (f = f_max · load / up_threshold, snapped up to the frequency table).
  At a load of exactly ``up_threshold`` the proportional target equals
  f_max only up to floating-point rounding — taking the jump branch keeps
  the governor pinned instead of dithering between adjacent table entries.
* **Conservative** — graceful stepping: load above ``up_threshold`` steps
  up by ``freq_step``·range, below ``down_threshold`` steps down.

Governors consume a utilization sample per tick and emit the next
frequency; `node_sim.Node.run_governor` wires them to the machine model.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.node_sim import F_MAX, F_MIN


class Governor:
    name = "base"

    def __init__(self, freq_table=None):
        table = (
            np.round(np.arange(F_MIN, F_MAX + 1e-9, 0.1), 2)
            if freq_table is None
            else np.asarray(freq_table, float)
        )
        self.table = np.sort(table)

    def reset(self) -> None:  # pragma: no cover - stateless default
        pass

    def initial_frequency(self) -> float:
        return float(self.table[-1])

    def snap_up(self, f: float) -> float:
        """Lowest table frequency >= f (kernel CPUFREQ_RELATION_L)."""
        idx = np.searchsorted(self.table, f - 1e-9)
        idx = min(idx, len(self.table) - 1)
        return float(self.table[idx])

    def next_frequency(self, utilization: float) -> float:
        raise NotImplementedError


class PerformanceGovernor(Governor):
    name = "performance"

    def next_frequency(self, utilization: float) -> float:
        return float(self.table[-1])


class PowersaveGovernor(Governor):
    name = "powersave"

    def initial_frequency(self) -> float:
        return float(self.table[0])

    def next_frequency(self, utilization: float) -> float:
        return float(self.table[0])


class UserspaceGovernor(Governor):
    name = "userspace"

    def __init__(self, frequency_ghz: float, freq_table=None):
        super().__init__(freq_table)
        self.frequency = self.snap_up(frequency_ghz)

    def initial_frequency(self) -> float:
        return self.frequency

    def next_frequency(self, utilization: float) -> float:
        return self.frequency


class OndemandGovernor(Governor):
    """The kernel ondemand rule (drivers/cpufreq/cpufreq_ondemand.c)."""

    name = "ondemand"

    def __init__(self, up_threshold: float = 0.95, freq_table=None):
        super().__init__(freq_table)
        self.up_threshold = up_threshold
        self._f = self.initial_frequency()

    def reset(self) -> None:
        self._f = self.initial_frequency()

    def next_frequency(self, utilization: float) -> float:
        # >= not >: at exactly up_threshold the proportional target is f_max
        # only up to FP rounding — snap_up of (f_max - 1 ulp) vs f_max would
        # oscillate between adjacent table frequencies as noise dithers.
        if utilization >= self.up_threshold:
            self._f = float(self.table[-1])
        else:
            target = float(self.table[-1]) * utilization / self.up_threshold
            self._f = self.snap_up(max(target, float(self.table[0])))
        return self._f


class ConservativeGovernor(Governor):
    name = "conservative"

    def __init__(
        self,
        up_threshold: float = 0.80,
        down_threshold: float = 0.20,
        freq_step: float = 0.05,
        freq_table=None,
    ):
        super().__init__(freq_table)
        self.up = up_threshold
        self.down = down_threshold
        self.step = freq_step * (float(self.table[-1]) - float(self.table[0]))
        self._f = self.initial_frequency()

    def reset(self) -> None:
        self._f = self.initial_frequency()

    def initial_frequency(self) -> float:
        return float(self.table[0])

    def next_frequency(self, utilization: float) -> float:
        if utilization > self.up:
            self._f = self.snap_up(min(self._f + self.step, float(self.table[-1])))
        elif utilization < self.down:
            self._f = self.snap_up(max(self._f - self.step, float(self.table[0])))
        return self._f
