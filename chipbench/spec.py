"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration and a traffic mix. The
configuration's file is the ``file`` of its ``configs`` entry; the mix is
``chipbench/traffic/<traffic>.json``; a per-layer metric ``<name>`` is read
by ``chipbench/metrics/<name>.py``; a traffic mix's ``entry`` is driven by
``chipbench/entries/<entry>.py``; a cell's limits are
``chipbench/limits/<workload>.json``. Adding any of them is adding a file
and an entry, never editing one.
"""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Spec:
    def __init__(self, root: str = ROOT):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.data = json.load(f)

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        with open(self.path("traffic", f"{name}.json")) as f:
            return json.load(f)

    def limits(self, workload: str) -> dict:
        """{number: limit} of the cell's check ({} before it has limits)."""
        path = self.path("limits", f"{workload}.json")
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            return {k: float(v["limit"]) for k, v in json.load(f).items()}

    def path(self, kind: str, filename: str) -> str:
        return os.path.join(self.root, "chipbench", kind, filename)

    def load(self, kind: str, name: str) -> ModuleType:
        """``chipbench/<kind>/<name>.py`` as a module (names may hold dots)."""
        spec = importlib.util.spec_from_file_location(
            f"chipbench.{kind}._{name.replace('.', '_').replace('-', '_')}",
            self.path(kind, f"{name}.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    def end_to_end(self, workload: str) -> List[dict]:
        return [m for m in self.data["end_to_end"] if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> List[dict]:
        """The cell's per-layer metrics: those that list it, and those that
        list no cells, where the cell reports the metric they move."""
        moved = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.data["per_layer"]
                if (workload in m["workloads"] if "workloads" in m else m["moves"] in moved)]

