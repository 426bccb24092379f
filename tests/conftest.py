"""Shared test plumbing.

* Optional-dependency shim: ``hypothesis`` is an optional dev dependency
  (real shrinking when installed); when absent, a tiny seeded-sweep shim
  from ``tests/helpers/hypothesis_shim.py`` is registered so collection
  never dies with ModuleNotFoundError.
* Session-scoped fitted-model fixtures: the suite's hotspot is repeated
  ε-SVR fits (Gram build + active-set solve). Characterizations and fitted
  models are built once per session here and shared across test modules.
* ``slow`` marker: full characterization sweeps and the subprocess
  multi-device checks. ``pytest -m "not slow"`` is the sub-minute loop.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(
    0, os.path.join(os.path.dirname(__file__), "..", "src")
)

try:
    import hypothesis  # noqa: F401
except ImportError:
    from helpers import hypothesis_shim

    hypothesis_shim.install()

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running (full sweeps, multi-fit CV, subprocess device "
        "checks); deselect with -m 'not slow' for the sub-minute loop",
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device (the port's Hopper kernels); skips without one",
    )


# ---------------------------------------------------------------------------
# node-level (paper) fitted models
# ---------------------------------------------------------------------------


@pytest.fixture(scope="session")
def stress_samples():
    from repro.core.node_sim import Node

    return Node(seed=7).stress_grid()


@pytest.fixture(scope="session")
def power_model(stress_samples):
    from repro.core import power

    return power.fit_power_model(*stress_samples)


@pytest.fixture(scope="session")
def blackscholes_ch():
    """Reduced-grid blackscholes characterization (benchmarks run §3.4 full)."""
    from repro.core import characterize
    from repro.core.node_sim import FREQ_GRID, Node

    sampler = characterize.NodeSampler(Node(seed=3), "blackscholes")
    return characterize.characterize(
        sampler,
        "blackscholes",
        freqs=FREQ_GRID[::2],
        cores=range(1, 33, 2),
        input_sizes=(1.0, 3.0, 5.0),
    )


@pytest.fixture(scope="session")
def bs_perf(blackscholes_ch):
    """The fitted SVR performance model — the expensive shared artifact."""
    return blackscholes_ch.fit_svr()


# ---------------------------------------------------------------------------
# TPU-fleet planning
# ---------------------------------------------------------------------------


@pytest.fixture(scope="session")
def fleet_pm():
    from repro.core.tpu_power import FleetTelemetry, fit_fleet_power

    return fit_fleet_power(FleetTelemetry(seed=1))


@pytest.fixture(scope="session")
def planner(fleet_pm):
    from repro.core.planner import EnergyOptimalPlanner

    return EnergyOptimalPlanner(fleet_pm, noise=0.01, seed=0)


@pytest.fixture(scope="session")
def engine(fleet_pm):
    from repro.core.engine import PlanningEngine

    return PlanningEngine(fleet_pm, noise=0.01, seed=0)
