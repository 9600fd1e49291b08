"""A cell, found by its name: its entry in ``BENCHMARK.json``, the
configuration's file (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), the driver of the mix's kind
(``drivers/<kind>.py``) and the readers of its metrics
(``metrics/<metric>.py``).  Nothing here names a cell: a later cell, mix,
kind of traffic, configuration or metric is a new file and a new entry.
A configuration or mix that states what its driver does not do is refused
(``drivers.validate``)."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
from typing import Callable, Dict, List, Optional

from jpegbench import drivers

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]    # the cell's end-to-end metrics, BENCHMARK.json's entries
    per_layer: List[dict]     # the cell's per-layer metrics

    @property
    def driver(self):
        """``drivers/<kind>.py`` of the cell's traffic."""
        return drivers.load(self.traffic["kind"])

    def reader(self, metric: str) -> Callable:
        """``read(trace)`` of ``metrics/<metric>.py``."""
        path = HERE / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"jpegbench_metric_{metric}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``bench``)."""
    if bench is None:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    by_name: Dict[str, dict] = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = by_name[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    drivers.validate(drivers.load(traffic["kind"]), config, traffic)
    return Cell(name=name, chips=w["chips"], config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)])
