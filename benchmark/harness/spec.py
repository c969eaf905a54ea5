"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  Everything that belongs to one of them sits in files of its own:

- ``configs/<config>.json`` (the ``file`` of the configuration's entry),
- ``traffic/<traffic>.json``: the mix's parameters, whose ``kind`` names
  the general driver ``drivers/<kind>.py`` that reads them,
- ``limits/<cell>.json``: the limit of each number the check compares,
- ``metrics/<metric>.py``: the reader of one metric.

So a later change adds a configuration, a mix, a cell or a metric as new
files and new entries, and edits none of these.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]  # the checkout: BENCHMARK.json sits here
BENCH = "benchmark"  # the benchmark's folder, relative to the root


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    """``BENCHMARK.json`` under ``root``, with lookups by name."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.bench = self.root / BENCH
        self.data = load_json(self.root / "BENCHMARK.json")

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        known = ", ".join(w["name"] for w in self.data["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (known: {known})")

    def config(self, cell: dict) -> dict:
        for c in self.data["configs"]:
            if c["name"] == cell["config"]:
                return load_json(self.root / c["file"])
        raise KeyError(f"workload {cell['name']!r} names no known config {cell['config']!r}")

    def traffic(self, cell: dict) -> dict:
        return load_json(self.bench / "traffic" / f"{cell['traffic']}.json")

    def limits(self, cell: dict) -> dict:
        return load_json(self.bench / "limits" / f"{cell['name']}.json")

    def driver(self, kind: str):
        return load_module(self.bench / "drivers" / f"{kind}.py", f"bench_driver_{kind}")

    def metrics(self, cell: dict, traced: bool) -> list[dict]:
        """The cell's end-to-end metrics (untraced) or per-layer metrics
        (traced), in the order ``BENCHMARK.json`` lists them."""
        e2e = [m for m in self.data["end_to_end"]
               if cell["name"] in m.get("workloads", [cell["name"]])]
        if not traced:
            return e2e
        return [m for m in self.data["per_layer"] if cell["name"] in m["workloads"]]

    def reader(self, metric: str):
        """The module of ``metrics/<metric>.py``; its ``read(run)`` gives the
        metric's value, or None where it finds nothing to read."""
        return load_module(self.bench / "metrics" / f"{metric}.py",
                           "bench_metric_" + metric.replace(".", "_").replace("-", "_"))


def load_module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
