"""Everything a run needs, found by name: the cell in ``BENCHMARK.json``,
its configuration file, its traffic mix ``traffic/<name>.json``, its
limits ``limits/<cell>.json``, the configuration's family
``families/<family>.py``, the mix's generator ``traffic/<generator>.py``
and each per-layer metric's reader ``metrics/<metric>.py``.  A new cell,
configuration, mix or metric is new files and new entries, with no file
edited.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of ``BENCHMARK.json`` with all it names."""

    def __init__(self, name: str, bench_path: str = "BENCHMARK.json"):
        bench = read_json(bench_path)
        root = os.path.dirname(os.path.abspath(bench_path))
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in {bench_path}")
        self.name = name
        self.entry = cells[name]
        self.chips = int(self.entry["chips"])
        cfgs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = cfgs[self.entry["config"]]
        self.config = read_json(os.path.join(root, self.config_entry["file"]))
        self.mix = read_json(os.path.join(HERE, "traffic",
                                          self.entry["traffic"] + ".json"))
        self.limits = read_json(os.path.join(HERE, "limits", name + ".json"))
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]

    def family(self):
        return importlib.import_module(
            f"portbench.families.{self.config['family']}")

    def generator(self):
        return importlib.import_module(
            f"portbench.traffic.{self.mix['generator']}")


def metric_reader(name: str):
    """The module of ``metrics/<name>.py``: LAYER, UNIT, MOVES and
    ``read(ctx)``, which returns a number or None."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
