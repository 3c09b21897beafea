"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of `workloads`) names a configuration and a traffic
mix; the configuration's `file` holds its sizes and parameters, the
traffic mix is traffic/<traffic>.json, whose `loop` names the module of
loops/ that drives its window, each metric is read by
metrics/<metric name>.py, and the kernels of a roofline's step are the
union of the lists in kernels/<step>/*.json.  Adding a cell, a metric, a
kind of traffic or a kernel name adds files and edits none.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(spec: Dict, name: str) -> Dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(spec: Dict, cell_: Dict, root: Path = ROOT) -> Dict:
    for c in spec["configs"]:
        if c["name"] == cell_["config"]:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration named {cell_['config']!r}")


def traffic(cell_: Dict) -> Dict:
    with open(HERE / "traffic" / f"{cell_['traffic']}.json") as f:
        return json.load(f)


def loop(traffic_: Dict) -> ModuleType:
    """loops/<loop>.py, the window loop the traffic names."""
    return importlib.import_module(f"{__package__}.loops.{traffic_['loop']}")


def metrics(spec: Dict, cell_: Dict, trace: bool) -> List[Dict]:
    """The end-to-end metrics of the cell (trace off) or its per-layer
    ones (trace on): those whose `workloads` list it, or that have none."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group
            if cell_["name"] in m.get("workloads", [cell_["name"]])]


def reader(metric: str) -> ModuleType:
    """metrics/<metric>.py, loaded by path (a metric's name has dots)."""
    path = HERE / "metrics" / f"{metric}.py"
    spec_ = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


def kernel_names(step: str) -> List[str]:
    """Device kernel names (substrings of the profiler's names) that make
    up a roofline's step: the union of kernels/<step>/*.json."""
    names: List[str] = []
    for p in sorted((HERE / "kernels" / step).glob("*.json")):
        with open(p) as f:
            names.extend(json.load(f)["kernels"])
    return sorted(set(names))


def peaks() -> Dict:
    with open(HERE / "work" / "peaks.json") as f:
        return json.load(f)
