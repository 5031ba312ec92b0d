"""The drives: what turns a traffic file's parameters into the requests of a
cell's window, sent to the program through its own entries. A traffic file
names its drive (``"drive": "<name>"``), and the harness loads
``rtbench/drives/<name>.py``, whose ``DRIVE`` is a ``Drive``. A new kind of
traffic is a new drive file; a new mix of a known kind is a traffic file
alone.

Each drive reads the traffic keys it knows (``KNOWN``) and hands every
other key of the file on, as a keyword, to the program entry it builds
(``Drive.passed``), so a mix can set an option of the entry by data.

Every request's inputs come from the run's seed (``sub_seed``). The
checks run after the window on the reference (``rtbench/reference``),
which builds its own tables from the configuration file.
"""

from __future__ import annotations

import functools
import hashlib
import time

import numpy as np
import torch

from .. import tracing
from ..reference import scene as rscene
from ..reference import trace as rref

# Keys of every traffic file that no entry takes.
COMMON = ("drive", "why", "camera", "check")


def sub_seed(seed: int, label: str, bits: int = 31) -> int:
    h = hashlib.blake2b(f"{seed}/{label}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") & ((1 << bits) - 1)


def now() -> float:
    return time.perf_counter()


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def camera_dict(config: dict, traffic: dict) -> dict:
    cam = dict(config["camera"])
    cam.update(traffic.get("camera", {}))
    return cam


def camera_params(cam: dict):
    from raytracing_tpu_torch import CameraParameters

    return CameraParameters(**{k: tuple(v) if isinstance(v, list) else v
                               for k, v in cam.items()})


def program_scene(config: dict):
    """The configuration's scene through the program's own builders:
    ``world_from_dict`` builds the configuration's ``world`` with its
    ``grid_seed``; any other entry is a builder of the package, called with
    ``kwargs``."""
    import raytracing_tpu_torch as rtt
    from raytracing_tpu_torch.scene import config as rconfig

    p = config["program"]
    if p["entry"] == "world_from_dict":
        world = rconfig.world_from_dict(config["world"])
        return rconfig.build_world(world, seed=int(config["grid_seed"]))[1]
    return getattr(rtt, p["entry"])(**p.get("kwargs", {}))[1]


def reference_tables(config: dict, device, dtype=torch.float32):
    sph, tri = rscene.scene_of(config)
    return rref.on_device(rscene.sphere_table(sph),
                          None if tri is None else rscene.triangle_table(tri),
                          device, dtype, config)


def chosen(n: int, k: int, seed: int, label: str) -> list[int]:
    """``k`` of ``range(n)`` (all when ``n <= k``), drawn from the seed."""
    if n <= k:
        return list(range(n))
    rng = np.random.default_rng(sub_seed(seed, label))
    return sorted(int(i) for i in rng.choice(n, size=k, replace=False))


class Drive:
    """One cell's run: ``setup()``, ``window(seconds, trace)``, then
    ``results()`` (the end-to-end metrics), ``release()`` and ``checks()``
    (the numbers compared, each ``(name, value, limit)``). ``plan()`` draws
    the requests' inputs without the program; ``control_observed`` gives
    what the window would have produced with the control in the program's
    place."""

    kind = ""
    count_key = ""   # the key of ``check`` that counts the checked requests
    KNOWN: tuple = ()

    def __init__(self, cell, seed: int, device, log=print) -> None:
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.check = cell.traffic["check"]
        self.seed = int(seed)
        self.device = torch.device(device)
        self.log = log
        self.build_ms = 0.0
        self.window_s = 0.0
        self.record = None

    def passed(self) -> dict:
        """The traffic keys this drive does not read: keywords of the
        program entry it builds."""
        return {k: v for k, v in self.traffic.items()
                if k not in COMMON and k not in self.KNOWN}

    @functools.cached_property
    def scene_counts(self) -> dict:
        """The configuration's real rows, counted by the reference's scene
        build: spheres, their padded rows, triangles."""
        sph, tri = rscene.scene_of(self.config)
        n = len(sph.radii)
        return dict(n_actual=n, n_pad=rscene.pad_rows(n),
                    m_actual=0 if tri is None else tri.v0.shape[0])

    def run_window(self, seconds: float, trace: bool) -> None:
        with tracing.Profiler(trace) as prof:
            self.window(seconds, trace)
        self.record = prof.record

    @property
    def attempted(self) -> int:
        return len(self.requests)

    def limits(self) -> dict:
        return self.cell.limits["limits"]


def make(cell, seed: int, device, log=print) -> Drive:
    return cell.drive(cell, seed, device, log)
