"""TPU-fleet power model: the paper's Eq. (7) with v5e constants.

    P(f, chips, pods) = chips·(c1·f³ + c2·f) + c3 + c4·pods

Assumed ground-truth constants (documented estimates — v5e chip power is not
public; these sit in the plausible envelope and the *methodology* is what is
being reproduced):
  * f_nom = 0.94 GHz (v5e core clock), DVFS range 0.6–1.1 GHz
  * per-chip dynamic power at f_nom ≈ 148 W  (c1 = 150, c2 = 25)
  * fleet static overhead c3 = 500 W; per-pod (hosts, fans, ICI switches)
    c4 = 3000 W
Like the paper's node (Eq. 9), the model is FIT from stress telemetry, not
assumed: ``FleetTelemetry`` plays the role of IPMI, and the same
``core.power.fit_power_model`` OLS recovers the coefficients.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.power import PowerModel, fit_power_model

F_NOM = 0.94  # GHz
F_GRID = np.round(np.arange(0.60, 1.101, 0.05), 3)
TRUE_COEFFS = (150.0, 25.0, 500.0, 3000.0)

PEAK_FLOPS_BF16 = 197e12  # per chip at f_nom
HBM_BW = 819e9  # B/s per chip
ICI_BW = 50e9  # B/s per link
DCN_POD_PENALTY = 8.0  # cross-pod collectives ride DCN ~8x slower


@dataclasses.dataclass
class FleetTelemetry:
    """Simulated fleet power sensors (the IPMI stand-in)."""

    seed: int = 0
    noise_w: float = 25.0  # fleet-level sensor noise

    def stress_grid(self, chip_counts=(16, 32, 64, 128, 256, 512)):
        truth = PowerModel(*TRUE_COEFFS)
        rng = np.random.default_rng(self.seed)
        fs, ps, ss, ws = [], [], [], []
        for f in F_GRID:
            for chips in chip_counts:
                pods = int(np.ceil(chips / 256))
                for _ in range(10):
                    fs.append(float(f))
                    ps.append(float(chips))
                    ss.append(float(pods))
                    ws.append(
                        float(truth(f, chips, pods))
                        + float(rng.normal(0, self.noise_w))
                    )
        return (
            np.asarray(fs, np.float32),
            np.asarray(ps, np.float32),
            np.asarray(ss, np.float32),
            np.asarray(ws, np.float32),
        )


def fit_fleet_power(telemetry: FleetTelemetry | None = None) -> PowerModel:
    t = telemetry or FleetTelemetry()
    return fit_power_model(*t.stress_grid())
