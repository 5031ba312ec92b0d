"""Files found by name: ``<folder>/<name>.py`` under a root, loaded by path
(names may hold dots). The harness finds its drives, per-layer metric
readers and the reference's scene builders, hit rules and albedo rules so:
a new one is a new file, named where it is used (``BENCHMARK.json``, a
traffic file, a configuration file)."""

from __future__ import annotations

import importlib.util
import pathlib
import re


def load(root: pathlib.Path, folder: str, name: str):
    """The module in ``root/folder/name.py``, loaded anew."""
    path = pathlib.Path(root) / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder} file for {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(
        "rtbench_" + re.sub(r"\W", "_", f"{folder}_{name}"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
