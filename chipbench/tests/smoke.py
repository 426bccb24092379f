"""What the harness's tests share: the cells at SMOKE width on the host.

A SMOKE configuration is the cell's configuration file with its sizes cut
(``data/smoke-*.json``); the traffic is the cell's mix with short
sequences. ``run`` drives the whole harness (set-up, window, check) on the
CPU through ``harness.run_cell``, inside a one-rank gloo world that is torn
down afterwards, so that no process group outlives a test.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
for path in (ROOT, os.path.join(ROOT, "src")):
    if path not in sys.path:
        sys.path.insert(0, path)

from chipbench import harness, spec  # noqa: E402

CONFIGS = {"starcoder2-3b": "smoke-starcoder2.json", "mamba2-130m": "smoke-mamba2.json"}
# the control's test takes a few more layers: fp8's error grows with depth
CONTROL_SIZES = {"starcoder2-3b": {"num_hidden_layers": 4}, "mamba2-130m": {"n_layer": 4}}
TRAIN = {"batch": 2, "seq": 64, "trace_steps": 1}
PREFILL = {"buckets": [{"batch": 4, "prompt": 16, "share": 2}, {"batch": 2, "prompt": 32, "share": 1}],
           "check_requests": {"16": 4, "32": 2}, "trace_steps": 2}


def config(name: str, **changes) -> dict:
    with open(os.path.join(HERE, "data", CONFIGS[name])) as f:
        return dict(json.load(f), **changes)


def traffic(bench, name: str) -> dict:
    return dict(bench.traffic(name), **(TRAIN if name == "train_4k" else PREFILL))


@contextlib.contextmanager
def one_rank_world():
    """Leave no process group behind (other tests in the process need to
    bring up worlds of their own)."""
    import torch.distributed as dist

    was_up = dist.is_initialized()
    try:
        yield
    finally:
        if dist.is_initialized() and not was_up:
            dist.destroy_process_group()


def run(workload: str, seed: int = 20260101, *, trace: bool = False, dtype: str = "float32",
        bench=None, **cfg_changes) -> dict:
    """One run of ``workload`` at SMOKE width on the CPU (a window of one
    step or block)."""
    bench = bench or spec.Spec(ROOT)
    cell = bench.workload(workload)
    with one_rank_world():
        return harness.run_cell(workload, seed, 0.0, trace, device="cpu", bench=bench,
                                cfg=config(cell["config"], torch_dtype=dtype, **cfg_changes),
                                traffic=traffic(bench, cell["traffic"]))
