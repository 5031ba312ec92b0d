"""``orbit_frames``: ``InteractiveSession.step`` with the camera orbiting
one step a frame (a fresh pose every frame), presenting to an in-memory
stream; each step returns after one more frame was presented. Reports
``frames_per_s``: the frames presented in the window over the window's
time. The intervals between presented frames are kept for the per-layer
``frame_p95_ms``.

Traffic keys: ``spp`` (a frame), ``max_depth``, ``pipeline``, ``keys``
(the session's keys a step), ``warmup_frames``; every other key is a
keyword of ``InteractiveSession`` (``backend``, ``converge_spp``).
Checks: ``frames`` presented frames x ``cells`` preview cells against the
reference's render of that frame's pose."""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from rtbench import tracing
from rtbench.drives import (Drive, camera_dict, camera_params, chosen, now,
                            program_scene, reference_tables, sub_seed, sync)
from rtbench.reference import scene as rscene
from rtbench.reference import trace as rref
from rtbench.yardstick import beyond, percentile


class _Sink:
    """The presenter's stream: keeps nothing."""

    def write(self, s: str) -> int:
        return len(s)

    def flush(self) -> None:
        pass


# The session's orbit rig (runtime/interactive.py at commit a1403821e8fd:
# OrbitState, _orbit_from_params, AZ_STEP, and the preview's box of
# runtime/renderer.py::_preview_shape / _device_preview), for the
# reference's poses and previews.
AZ_STEP = math.radians(6.0)


def start_pose(cam: dict, seed: int) -> dict:
    """The camera turned about its look-at point by a seeded azimuth."""
    lf = np.asarray(cam["lookfrom"], np.float64)
    la = np.asarray(cam["lookat"], np.float64)
    v = lf - la
    a = 2.0 * math.pi * (sub_seed(seed, "azimuth") / 2.0 ** 31)
    c, s = math.cos(a), math.sin(a)
    out = dict(cam)
    out["lookfrom"] = [float(la[0] + c * v[0] - s * v[2]), float(lf[1]),
                       float(la[2] + s * v[0] + c * v[2])]
    return out


def orbit_cameras(cam: dict, frames: int) -> list:
    """The camera of frame ``k``: the orbit's azimuth advanced ``k + 1``
    steps from the pose of ``cam`` (one ``d`` key a frame)."""
    lf = np.asarray(cam["lookfrom"], np.float64)
    la = np.asarray(cam["lookat"], np.float64)
    v = lf - la
    dist = float(np.linalg.norm(v))
    az = math.atan2(v[2], v[0])
    el = math.asin(float(v[1]) / max(dist, 1e-9))
    lookat = tuple(float(x) for x in la)
    out = []
    for _ in range(frames):
        az += AZ_STEP
        ce = math.cos(el)
        c = dict(cam)
        c["lookfrom"] = (lookat[0] + dist * ce * math.cos(az),
                         lookat[1] + dist * math.sin(el),
                         lookat[2] + dist * ce * math.sin(az))
        c["lookat"] = lookat
        out.append(c)
    return out


def preview_shape(h: int, w: int, rows: int = 136, cols: int = 240):
    fy = -(-h // min(rows, h))
    fx = -(-w // min(cols, w))
    return fy, fx, -(-h // fy), -(-w // fx)


class OrbitFrames(Drive):
    kind = "orbit_frames"
    count_key = "frames"
    KNOWN = ("spp", "max_depth", "pipeline", "keys", "warmup_frames")

    def plan(self) -> None:
        t = self.traffic
        self.cam = start_pose(camera_dict(self.config, t), self.seed)
        self.width = int(self.cam["image_width"])
        self.height = rscene.image_height(self.cam)
        self.spp, self.depth = int(t["spp"]), int(t["max_depth"])

    def setup(self) -> None:
        from raytracing_tpu_torch.runtime.interactive import InteractiveSession

        t = self.traffic
        # The presenter sizes itself from the terminal: fix it.
        os.environ["COLUMNS"], os.environ["LINES"] = "100", "40"
        self.plan()
        self.sink = _Sink()
        sync(self.device)
        t0 = now()
        scene = program_scene(self.config)
        params = camera_params(dict(self.cam, samples_per_pixel=self.spp,
                                    max_depth=self.depth))
        self.session = InteractiveSession(
            scene, params, seed=sub_seed(self.seed, "session"),
            device=self.device, spp=self.spp, pipeline=int(t["pipeline"]),
            stream=self.sink, **self.passed())
        sync(self.device)
        self.build_ms = (now() - t0) * 1e3
        self.lag = int(t["pipeline"])
        self.steps = 0
        for _ in range(int(t["warmup_frames"])):
            self.session.step(t["keys"])
            self.steps += 1
        sync(self.device)

    def window(self, seconds: float, trace: bool) -> None:
        self.requests = []   # (frame index, interval s)
        self.frames = {}     # frame index -> presented preview
        keys = self.traffic["keys"]
        t0 = prev = now()
        while True:
            with tracing.span("rtbench.step", trace):
                img = self.session.step(keys)
            b = now()
            frame = self.steps - self.lag
            self.steps += 1
            self.requests.append((frame, b - prev))
            self.frames[frame] = img
            prev = b
            if b - t0 >= seconds:
                break
        self.window_s = b - t0

    def results(self) -> dict:
        n = len(self.requests)
        self.frame_p95_ms = percentile([q[1] * 1e3 for q in self.requests], 95)
        self.log(f"frames_per_s: {n} frames in {self.window_s:.4f} s; "
                 f"frame_p95_ms {self.frame_p95_ms:.4f} ({beyond(n, 95)} "
                 "beyond the 95th percentile"
                 + (")" if beyond(n, 95) >= 10 else ", fewer than ten)"))
        return {"frames_per_s": n / self.window_s}

    def release(self) -> None:
        self.session.flush()
        del self.session

    def _cells(self, f: int):
        fy, fx, ph, pw = preview_shape(self.height, self.width)
        rng = np.random.default_rng(sub_seed(self.seed, f"cells{f}"))
        flat = rng.choice(ph * pw, int(self.check["cells"]), replace=False)
        return flat // pw, flat % pw

    def observed(self, ref) -> list:
        frames = sorted(self.frames)
        idx = chosen(len(frames), int(self.check["frames"]), self.seed, "check")
        out = []
        for j in idx:
            f = frames[j]
            ci, cj = self._cells(f)
            out.append((f, ci, cj, self.frames[f][ci, cj]))
        return out

    def _reference_cells(self, ref, f: int, ci, cj, cam: dict):
        fy, fx, _, _ = preview_shape(self.height, self.width)
        rows = np.minimum(ci[:, None] * fy + np.arange(fy), self.height - 1)
        cols = np.minimum(cj[:, None] * fx + np.arange(fx), self.width - 1)
        py = np.repeat(rows, fx, axis=1).reshape(-1)
        px = np.tile(cols, (1, fy)).reshape(-1)
        uniq, inv = np.unique(py * self.width + px, return_inverse=True)
        slots = rref.slot_of_pixel(torch.from_numpy(uniq % self.width),
                                   torch.from_numpy(uniq // self.width),
                                   self.width)
        rad, _ = rref.camera_paths(
            ref, torch.from_numpy(rscene.camera_vector(cam)), self.width,
            self.session_seed, slots.repeat_interleave(self.spp),
            torch.arange(self.spp).repeat(len(uniq)), self.depth)
        u8 = rref.to_u8(rref.pixel_sums(rad, self.spp)
                        * float(np.float32(1.0) / np.float32(self.spp))).cpu()
        box = u8[torch.from_numpy(inv)].to(torch.float32).view(len(ci), -1, 3)
        return (box.sum(dim=1) / float(fy * fx) + 0.5).to(torch.uint8)

    @property
    def session_seed(self) -> int:
        return sub_seed(self.seed, "session")

    def checks(self, observed=None, ref=None) -> list:
        ref = ref or reference_tables(self.config, self.device)
        observed = observed if observed is not None else self.observed(ref)
        cams = orbit_cameras(self.cam, max(q[0] for q in observed) + 1)
        gaps = []
        for f, ci, cj, vals in observed:
            cells = self._reference_cells(ref, f, ci, cj, cams[f])
            gaps.append((cells.int() - torch.from_numpy(vals).int()).abs())
        return [("frame_gap", float(torch.cat(gaps).float().mean()),
                 self.limits()["frame_gap"])]

    def control_observed(self, ref_low, n: int) -> list:
        cams = orbit_cameras(self.cam, n)
        out = []
        for f in range(n):
            ci, cj = self._cells(f)
            out.append((f, ci, cj,
                        self._reference_cells(ref_low, f, ci, cj,
                                              cams[f]).numpy()))
        return out


DRIVE = OrbitFrames
