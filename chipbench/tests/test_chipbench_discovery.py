"""A later change adds a configuration, a traffic mix or a per-layer metric
by adding files and entries in ``BENCHMARK.json``: the harness finds each
by its name, with no other file edited."""

import json
import os
import shutil

from chipbench import spec
from chipbench.tests import smoke


def _tree(root):
    out = {}
    for base, _, files in os.walk(root):
        if "__pycache__" in base:
            continue
        for f in files:
            path = os.path.join(base, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def test_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(smoke.ROOT, "chipbench"), root / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(smoke.ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    before = _tree(root / "chipbench")

    cfg = smoke.config("starcoder2-3b", num_hidden_layers=3, torch_dtype="float32")
    (root / "chipbench" / "configs" / "tiny-dense.json").write_text(json.dumps(cfg))
    traffic = dict(json.loads((root / "chipbench" / "traffic" / "train_4k.json").read_text()),
                   batch=2, seq=32, trace_steps=1)
    (root / "chipbench" / "traffic" / "train_tiny.json").write_text(json.dumps(traffic))
    (root / "chipbench" / "metrics" / "steps_seen.train.py").write_text(
        '"""Steps the traced window ran."""\n\n\ndef read(rec):\n    return len(rec["steps"])\n')
    data = json.loads((root / "BENCHMARK.json").read_text())
    data["configs"].append({"name": "tiny-dense", "source": cfg["source"],
                            "file": "chipbench/configs/tiny-dense.json",
                            "reduced": cfg["reduced"], "why": "a test's own configuration"})
    data["workloads"].append({"name": "tiny-dense.train_tiny", "config": "tiny-dense",
                              "traffic": "train_tiny", "chips": 1, "why": "a test's own cell"})
    data["end_to_end"][0]["workloads"].append("tiny-dense.train_tiny")
    data["per_layer"].append({"name": "steps_seen.train", "unit": "steps", "better": "higher",
                              "source": "program_counter", "layer": "training step",
                              "moves": "train_tokens_per_s",
                              "workloads": ["tiny-dense.train_tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(data))

    after = _tree(root / "chipbench")
    assert {k: v for k, v in after.items() if k in before} == before
    assert sorted(set(after) - set(before)) == ["configs/tiny-dense.json",
                                                 "metrics/steps_seen.train.py",
                                                 "traffic/train_tiny.json"]
    bench = spec.Spec(str(root))
    with smoke.one_rank_world():
        from chipbench import harness

        traced = harness.run_cell("tiny-dense.train_tiny", 5, 0.0, True, device="cpu",
                                  bench=bench)
        plain = harness.run_cell("tiny-dense.train_tiny", 5, 0.0, False, device="cpu",
                                 bench=bench)
    assert traced["metrics"]["steps_seen.train"]["value"] >= 1
    assert set(plain["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert plain["checks"]["loss_gap"]["value"] < 1e-6  # float32: round-off
