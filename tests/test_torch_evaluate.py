"""Port parity, the paper's closed loop: ``repro_torch.core.evaluate`` and
``energy`` (device="cpu") against the live ``repro.core`` at the sizes of
``tests/test_evaluate.py``, plus the entry points' device rule.

The simulator draws are bitwise identical in both packages, so once the
chosen configurations agree, every measured time, energy and ratio is
equal too. Predicted energies differ by the SVR fits' float32 Gram bits
(PRED_REL, as in ``test_torch_svr``).
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import evaluate as jev
from repro.core.node_sim import FREQ_GRID, MAX_CORES, Node as JNode
from repro_torch.core import energy as tenergy
from repro_torch.core import evaluate as tev
from repro_torch.core.node_sim import Node as TNode
from repro_torch.device import resolve_device

QUICK = dict(
    char_freqs=FREQ_GRID[::3],
    char_cores=range(1, MAX_CORES + 1, 4),
    char_inputs=(1.0, 3.0),
    input_sizes=(3.0,),
    governor_cores=(4, 32),
)
APPS = ("blackscholes", "raytrace")
PRED_REL = 2e-4


@pytest.fixture(scope="module")
def reports():
    ref = jev.compare_governors(JNode(seed=42), apps=APPS, **QUICK)
    port = tev.compare_governors(TNode(seed=42), apps=APPS, device="cpu", **QUICK)
    return ref, port


def test_same_chosen_configs_and_predicted_energies(reports):
    ref, port = reports
    assert len(port.plans) == len(ref.plans) == 2
    for a, b in zip(port.plans, ref.plans):
        assert (a.app, a.input_size, a.frequency_ghz, a.cores) == (
            b.app, b.input_size, b.frequency_ghz, b.cores)
        assert a.predicted_energy_j == pytest.approx(b.predicted_energy_j, rel=PRED_REL)
        assert (a.time_s, a.energy_j) == (b.time_s, b.energy_j)


def test_governor_runs_and_ratios_are_identical(reports):
    ref, port = reports
    assert len(port.runs) == len(ref.runs) == 16
    assert [dataclasses.astuple(r) for r in port.runs] == [
        dataclasses.astuple(r) for r in ref.runs]
    assert port.worst_case_ratio == ref.worst_case_ratio
    assert port.ratios_by_governor() == ref.ratios_by_governor()


def test_paper_ordering_holds_on_the_port(reports):
    _, port = reports
    assert port.worst_case_ratio > 2.0
    assert port.mean_ratio > 1.1
    assert port.plan_beats_all(tol=0.08)


def test_report_table_and_json_roundtrip(reports):
    _, port = reports
    for g in tev.STOCK_GOVERNORS:
        assert g in port.table()
    payload = json.loads(json.dumps(port.to_json()))
    back = tev.ComparisonReport.from_json(payload)
    assert back.plans == port.plans and back.runs == port.runs


@pytest.mark.parametrize("objective", ["energy", "edp", "ed2p"])
def test_minimize_energy_matches_reference(bs_perf, power_model, objective):
    """The node entry point over the reference's own blackscholes fit."""
    from repro.core import energy as jenergy
    from repro_torch import convert

    fields = {k: (np.asarray(v) if not isinstance(v, (float, bool)) else v)
              for k, v in dataclasses.asdict(bs_perf).items()}
    perf = convert.svr_params_from_reference(fields, device="cpu")
    pm = convert.power_model_from_reference(power_model.coeffs())
    kw = dict(frequencies=tuple(FREQ_GRID), cores=range(1, 33), input_size=3.0,
              objective=objective)
    a = tenergy.minimize_energy(pm, perf, **kw)
    b = jenergy.minimize_energy(power_model, bs_perf, **kw)
    assert (a.frequency_ghz, a.cores, a.sockets) == (b.frequency_ghz, b.cores, b.sockets)
    assert a.predicted_power_w == b.predicted_power_w
    assert a.predicted_energy_j == pytest.approx(b.predicted_energy_j, rel=PRED_REL)


def test_evaluate_cli_parses_help():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.evaluate", "--help"],
        capture_output=True, text=True, timeout=120,
        env={**os.environ,
             "PYTHONPATH": os.path.join(os.path.dirname(__file__), "..", "src")},
    )
    assert proc.returncode == 0, proc.stderr
    assert "--device" in proc.stdout and "--quick" in proc.stdout


def test_entry_points_default_to_the_card():
    """``device=None`` means CUDA. Where there is no card (as on the CPU test
    hosts) every entry point raises instead of falling back to the host."""
    from repro_torch.core import engine, svr
    from repro_torch.core.power import PowerModel

    x = np.array([[1.2, 4.0], [1.8, 8.0], [2.2, 16.0]], np.float32)
    calls = [
        lambda: engine.PlanningEngine(PowerModel(0.29, 0.97, 198.59, 9.18)),
        lambda: svr.fit_many([(x, np.array([4.0, 2.0, 1.0], np.float32))]),
        lambda: tev.compare_governors(TNode(seed=0), apps=("swaptions",), **QUICK),
        lambda: tev.main(["--quick"]),
    ]
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert resolve_device("cpu").type == "cpu"
