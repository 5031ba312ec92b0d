"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration (``configs`` entry,
whose ``file`` is ``rtbench/configs/<config>.json``), a traffic mix
(``rtbench/traffic/<traffic>.json``, which names its drive,
``rtbench/drives/<drive>.py``) and, through the metrics that list it or
list no cells, its end-to-end metrics and its per-layer metrics
(``rtbench/metrics/<metric>.py``). The limits that decide ``correct`` for
a cell are ``rtbench/limits/<cell>.json``. The configuration names the
reference's scene builder and rules (``rtbench/reference/``). No list of
names lives in code: a new cell, mix, drive, configuration or metric is a
new file and a new entry.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

from . import plugins

ROOT = pathlib.Path(__file__).resolve().parent
BENCHMARK = ROOT.parent / "BENCHMARK.json"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    drive: type           # the traffic's drive class (``DRIVE`` of its file)
    end_to_end: list      # BENCHMARK.json entries reported with --trace 0
    per_layer: list       # (entry, reader module) reported with --trace 1


def load_benchmark(path: pathlib.Path = BENCHMARK) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def metric_module(name: str, root: pathlib.Path = ROOT):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``."""
    return plugins.load(root, "metrics", name)


def resolve(bench: dict, workload: str, root: pathlib.Path = ROOT) -> Cell:
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have: {', '.join(sorted(cells))})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root.parent / configs[w["config"]]["file"], encoding="utf-8") as f:
        config = json.load(f)
    with open(root / "traffic" / f"{w['traffic']}.json", encoding="utf-8") as f:
        traffic = json.load(f)
    with open(root / "limits" / f"{workload}.json", encoding="utf-8") as f:
        limits = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    layer = [(m, metric_module(m["name"], root)) for m in bench["per_layer"]
             if _applies(m, workload)]
    drive = plugins.load(root, "drives", traffic["drive"]).DRIVE
    return Cell(workload, int(w["chips"]), config, traffic, limits, drive,
                e2e, layer)
