"""Cells of BENCHMARK.json cut to sizes the CPU runs in seconds: the same
drives, configurations and checks, on the program's plain versions."""

from __future__ import annotations

import copy

from rtbench import spec

TINY = {
    "renders": {"camera": {"image_width": 64}, "spp": 4, "max_depth": 8,
                "warmup_spp": 1,
                "check": {"renders": 2, "pixels": 16, "segment_paths": 65536}},
    "ray_batches": {"camera": {"image_width": 128}, "max_depth": 8, "pool": 2,
                    "check": {"every": 1, "batches": 2, "rays": 8192}},
    "orbit_frames": {"camera": {"image_width": 96}, "spp": 2, "max_depth": 4,
                     "warmup_frames": 3, "check": {"frames": 3, "cells": 16}},
}
# One cell of each drive.
CELLS = ("cover.north_star", "mesh3.render", "mesh3.rays", "cover.orbit")


def tiny_cell(name: str, bench=None):
    cell = spec.resolve(bench or spec.load_benchmark(), name)
    t = copy.deepcopy(cell.traffic)
    for k, v in TINY[t["drive"]].items():
        t[k] = {**t.get(k, {}), **v} if isinstance(v, dict) else v
    cell.traffic = t
    return cell
