"""Write tests/data/torch_port_eval_golden.json from the JAX package.

The paper loop at the settings the port's ``chip_smoke.py`` drives: full
characterization (11 frequencies x 32 cores x 5 inputs, 4 apps), seed 42,
energy objective, all 20 (app, input) plans, governors at the ``--quick``
settings (cores 1, 8, 32; one repeat). The simulator's draws are the same
in both packages, so where the plans agree the governor ratios agree bit
for bit. JAX runs on the CPU:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/helpers/make_torch_port_golden.py
"""

import json
import os
import sys

from repro.core import evaluate
from repro.core.node_sim import Node

SEED = 42
GOVERNOR_CORES = (1, 8, 32)
OUT = os.path.join(
    os.path.dirname(__file__), "..", "data", "torch_port_eval_golden.json"
)


def main() -> int:
    report = evaluate.compare_governors(
        Node(seed=SEED), governor_cores=GOVERNOR_CORES, repeats=1)
    payload = {
        "source": "repro.core.evaluate.compare_governors(Node(seed=42), "
                  "governor_cores=(1, 8, 32), repeats=1) on the JAX CPU backend",
        "seed": SEED,
        "governor_cores": list(GOVERNOR_CORES),
        "objective": report.objective,
        "worst_case_ratio": report.worst_case_ratio,
        "best_case_ratio": report.best_case_ratio,
        "mean_ratio": report.mean_ratio,
        "plans": [
            {
                "app": p.app,
                "input_size": p.input_size,
                "frequency_ghz": p.frequency_ghz,
                "cores": p.cores,
                "predicted_energy_j": p.predicted_energy_j,
            }
            for p in report.plans
        ],
    }
    with open(OUT, "w") as f:
        json.dump(payload, f, indent=1)
        f.write("\n")
    print(f"wrote {len(payload['plans'])} plans to {os.path.normpath(OUT)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
