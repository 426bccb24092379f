"""Write tests/data/torch_port_table1_golden.json from the JAX package.

The paper's Table 1 (§3.4) at the settings the port's ``chip_smoke.py``
drives, and the cross-validation pieces around it:

* ``table1``: 10-fold ``Characterization.cross_validate`` (MAE, PAE) of
  the four apps at full characterization (11 frequencies x 32 cores x 5
  inputs = 1,760 samples each), one ``Node(seed=42)`` in the apps' order,
  as ``benchmarks/bench_paper_repro.table1_svr_cv`` runs it;
* ``grid_search``: ``svr.grid_search`` (its default grid, k = 5) on the
  quick blackscholes characterization of ``tests/conftest.py``
  (``Node(seed=3)``, every other frequency, odd core counts, inputs 1, 3,
  5), whose grid the file records as ``quick_grid``;
* ``fit_many_ista``: ``svr.fit_many(iters=50)`` on the four apps' quick
  characterizations (a fresh ``Node(seed=42)``, the same reduced grid), and
  each model's predictions over the 11 x 32 (f, p) grid at input 3.

JAX runs on the CPU:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/helpers/make_torch_port_table1_golden.py
"""

import json
import os
import sys
import time

import numpy as np

from repro.core import characterize, svr
from repro.core.node_sim import FREQ_GRID, MAX_CORES, Node

APPS = ("blackscholes", "fluidanimate", "raytrace", "swaptions")
SEED = 42
GRID_SEARCH_SEED = 3
ISTA_ITERS = 50
PREDICT_INPUT = 3.0
# tests/conftest.py's blackscholes_ch grid
QUICK_GRID = {"freqs": [float(f) for f in FREQ_GRID[::2]], "cores": list(range(1, 33, 2)),
              "input_sizes": [1.0, 3.0, 5.0]}
OUT = os.path.join(
    os.path.dirname(__file__), "..", "data", "torch_port_table1_golden.json"
)


def quick_characterization(node, app):
    return characterize.characterize(characterize.NodeSampler(node, app), app, **QUICK_GRID)


def predict_grid():
    """The (f, p) grid at input ``PREDICT_INPUT``, frequency-major."""
    F, P = np.meshgrid(FREQ_GRID, np.arange(1, MAX_CORES + 1), indexing="ij")
    n = np.full(F.size, PREDICT_INPUT)
    return np.stack([F.ravel(), P.ravel(), n], 1).astype(np.float32)


def main() -> int:
    t0 = time.perf_counter()
    node = Node(seed=SEED)
    table1 = {}
    for app in APPS:
        ch = characterize.characterize(characterize.NodeSampler(node, app), app)
        mae, pae = ch.cross_validate(k=10)
        table1[app] = {"mae": mae, "pae": pae, "n": int(len(ch.times))}
        print(f"table1 {app}: mae {mae!r} pae {pae!r} n {len(ch.times)} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)

    bs = quick_characterization(Node(seed=GRID_SEARCH_SEED), "blackscholes")
    gs = svr.grid_search(bs.features, bs.times)
    print(f"grid_search: {gs}", flush=True)

    node = Node(seed=SEED)
    quick = [quick_characterization(node, app) for app in APPS]
    models = svr.fit_many(quick, iters=ISTA_ITERS)
    grid = predict_grid()
    ista = {
        app: {"bias": m.bias, "pred": np.asarray(svr.predict(m, grid), np.float64).tolist()}
        for app, m in zip(APPS, models)
    }
    payload = {
        "source": "repro.core (JAX CPU backend): Characterization.cross_validate(k=10) at "
                  "full characterization, Node(seed=42); svr.grid_search on the quick "
                  "blackscholes characterization, Node(seed=3); svr.fit_many(iters=50) on "
                  "the four quick characterizations, Node(seed=42), predicted over the "
                  "(f, p) grid at input 3",
        "apps": list(APPS),
        "seed": SEED,
        "quick_grid": QUICK_GRID,
        "table1": table1,
        "grid_search": {"seed": GRID_SEARCH_SEED, **gs},
        "fit_many_ista": {"iters": ISTA_ITERS, "input_size": PREDICT_INPUT,
                          "models": ista},
    }
    with open(OUT, "w") as f:
        json.dump(payload, f, indent=1)
        f.write("\n")
    print(f"wrote {os.path.normpath(OUT)} in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
