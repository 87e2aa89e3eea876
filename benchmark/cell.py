"""A cell of ``BENCHMARK.json`` and the files it names, found by name:
the configuration's file (its ``file`` entry), ``traffic/<mix>.json`` and,
for each per-layer metric the cell reports, ``metrics/<metric>.py``.  A
cell, configuration, mix or metric is added with files and entries alone.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, object] = field(default_factory=dict)


def load_reader(path: Path):
    """A metric's reader module, loaded from its file (metric names hold
    dots, so the file is no importable module name)."""
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reports(metric: dict, cell: str, e2e_names: List[str]) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    lists, or, without the key, every cell (an end-to-end metric) or every
    cell that reports the metric it moves (a per-layer metric)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def load(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root``'s ``BENCHMARK.json``, its data
    files read from ``root`` and its readers loaded."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                         f"({', '.join(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    data = root / HERE.name
    mix = json.loads((data / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if reports(m, workload, [])]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"]
                 if reports(m, workload, names)]
    cell = Cell(workload, int(w["chips"]), config, mix, e2e, per_layer)
    for m in per_layer:
        cell.readers[m["name"]] = load_reader(
            data / "metrics" / f"{m['name']}.py")
    return cell
