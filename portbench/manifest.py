"""What ``BENCHMARK.json`` names, found by name under ``portbench/``.

A cell names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``); its correctness limits sit in
``limits/<cell>.json`` and each per-layer metric's reader in
``metrics/<metric>.py``, a module with ``read(run) -> number or None``.
A later cell, mix or metric is a new file and a new entry, never an edit.
"""
from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load(root=ROOT) -> dict:
    return _json(root, "BENCHMARK.json")


class Cell:
    """One workload of the manifest with its files."""

    def __init__(self, manifest: dict, name: str, here=HERE):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(there are {sorted(cells)})")
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config = _json(os.path.dirname(here), configs[self.entry["config"]]["file"])
        self.traffic = _json(here, "traffic", f"{self.entry['traffic']}.json")
        self.limits = _json(here, "limits", f"{name}.json")
        self.here = here
        self.end_to_end = [m for m in manifest["end_to_end"] if self._reports(m)]
        self.per_layer = [m for m in manifest["per_layer"] if self._reports(m)]

    def _reports(self, metric):
        return "workloads" not in metric or self.name in metric["workloads"]

    def reader(self, metric_name):
        """The ``read`` function of ``metrics/<metric_name>.py``."""
        path = os.path.join(self.here, "metrics", f"{metric_name}.py")
        spec = importlib.util.spec_from_file_location(
            "portbench.metrics." + metric_name.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
