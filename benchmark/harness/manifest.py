"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration (``configs[].file``) and a traffic mix
(``benchmark/traffic/<traffic>.json``); a metric is read by
``benchmark/metrics/<metric name>.py``. Adding any of them is a new file
and a new entry: nothing here lists them.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def with_pending(manifest: dict, name: str) -> dict:
    """The manifest with the entries of ``benchmark/pending/<name>.json``
    added, as a later PR adds them: a cell built and tested but not yet
    in BENCHMARK.json. A metric the manifest has already gains the
    pending entry's cells in its ``workloads``."""
    with open(os.path.join(BENCH_DIR, "pending", f"{name}.json")) as f:
        pending = json.load(f)
    out = json.loads(json.dumps(manifest))
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        have = {e["name"]: e for e in out[key]}
        for entry in pending.get(key, []):
            if entry["name"] in have:
                have[entry["name"]]["workloads"] += entry["workloads"]
            else:
                out[key].append(entry)
    return out


def traffic_path(name: str) -> str:
    return os.path.join(BENCH_DIR, "traffic", f"{name}.json")


def metric_path(name: str) -> str:
    return os.path.join(BENCH_DIR, "metrics", f"{name}.py")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(manifest: dict, name: str, root: str = ROOT) -> Cell:
    """The cell called ``name`` with its configuration, traffic and
    metrics loaded; KeyError for a name the manifest does not have."""
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    with open(os.path.join(root, cfg_entry["file"])) as f:
        config = json.load(f)
    with open(traffic_path(entry["traffic"])) as f:
        traffic = json.load(f)
    return Cell(name, entry["chips"], config, traffic,
                [m for m in manifest["end_to_end"] if applies(m, name)],
                [m for m in manifest["per_layer"] if applies(m, name)])


def reader(metric: str) -> Callable:
    """The ``read`` function of ``benchmark/metrics/<metric>.py``."""
    path = metric_path(metric)
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(metrics: List[dict], window) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of every metric whose reader found
    something to read."""
    out = {}
    for m in metrics:
        value = reader(m["name"])(window)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
