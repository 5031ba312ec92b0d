"""``ray_batches``: one caller in a closed loop of ``trace_rays_fused``
calls, each a whole frame of jittered camera rays from a pool made on the
card before the window, with its own seed and tile offset, from the call
to the radiance ready on the card (the trace entry). Reports
``trace_p95_ms``: the nearest-rank 95th percentile over every batch of the
window.

Traffic keys: ``max_depth``, ``pool`` (frames made before the window),
``tile_rays``; every other key is a keyword of ``trace_rays_fused``
(``cull_hint``, ``gather``). Checks: ``batches`` of the batches kept (one
in ``every``, drawn from the seed) x ``rays`` rays against the reference,
and the program's segment count of those batches against an estimate
from the same rays."""

from __future__ import annotations

import numpy as np
import torch

from rtbench import tracing
from rtbench.drives import (Drive, camera_dict, chosen, now, program_scene,
                            reference_tables, sub_seed, sync)
from rtbench.reference import scene as rscene
from rtbench.reference import trace as rref
from rtbench.yardstick import beyond, percentile

# The tolerance of one ray's radiance (the kernel's guard against its
# plain version in the program's card checks).
RAY_ATOL, RAY_RTOL = 2e-4, 1e-3


def camera_ray_pool(cam: dict, count: int, seed: int, device):
    """``count`` frames of jittered camera rays (one a pixel, row-major),
    drawn on ``device`` from ``seed``: (origins, directions) lists of
    float32 [W * H, 3]."""
    v = torch.from_numpy(rscene.camera_vector(cam)).to(device)
    w = int(cam["image_width"])
    h = rscene.image_height(cam)
    pix = torch.arange(w * h, device=device)
    px = (pix % w).to(torch.float32)
    py = (pix // w).to(torch.float32)
    g = torch.Generator(device=device).manual_seed(seed)
    origins, dirs = [], []
    for _ in range(count):
        j = torch.rand((4, w * h), generator=g, device=device)
        dr = torch.sqrt(j[2])
        th = rref.TWO_PI * j[3]
        lu = dr * torch.cos(th) if float(v[18]) > 0 else torch.zeros_like(dr)
        lv = dr * torch.sin(th) if float(v[18]) > 0 else torch.zeros_like(dr)
        o = torch.stack([v[9 + k] + lu * v[12 + k] + lv * v[15 + k]
                         for k in range(3)], dim=1)
        fx, fy = px + j[0] - 0.5, py + j[1] - 0.5
        d = torch.stack([v[k] + fx * v[3 + k] + fy * v[6 + k] for k in range(3)],
                        dim=1) - o
        origins.append(o.contiguous())
        dirs.append(d.contiguous())
    return origins, dirs


class RayBatches(Drive):
    kind = "ray_batches"
    count_key = "batches"
    KNOWN = ("max_depth", "pool", "tile_rays")

    def plan(self) -> None:
        t = self.traffic
        self.cam = camera_dict(self.config, t)
        self.depth = int(t["max_depth"])
        self.tile_rays = int(t["tile_rays"])
        self.pool_o, self.pool_d = camera_ray_pool(
            self.cam, int(t["pool"]), sub_seed(self.seed, "pool"), self.device)
        self.n = self.pool_o[0].shape[0]

    def setup(self) -> None:
        from raytracing_tpu_torch.ops import trace as ptrace

        self.plan()
        sync(self.device)
        t0 = now()
        scene = program_scene(self.config).to(self.device)
        origin = torch.from_numpy(rscene.camera_vector(self.cam)[9:12])
        self.tables = ptrace.pack_scene(scene, origin=origin)
        sync(self.device)
        self.build_ms = (now() - t0) * 1e3
        self.trace = ptrace.trace_rays_fused
        self.extra = self.passed()
        self.trace(self.tables, self.pool_o[0], self.pool_d[0], 1, 0,
                   self.depth, tile_rays=self.tile_rays, **self.extra)
        sync(self.device)

    def _batch(self, i: int):
        return (i % len(self.pool_o), sub_seed(self.seed, f"batch{i}", 32),
                sub_seed(self.seed, f"tiles{i}", 20))

    def _rays(self, i: int) -> torch.Tensor:
        rng = np.random.default_rng(sub_seed(self.seed, f"rays{i}"))
        return torch.from_numpy(rng.choice(self.n, int(self.check["rays"]),
                                           replace=False)).to(self.device)

    def _checked(self, i: int) -> bool:
        return sub_seed(self.seed, f"check{i}") % int(self.check["every"]) == 0

    def window(self, seconds: float, trace: bool) -> None:
        self.requests = []   # (batch index, latency s, segments)
        self.kept = {}       # batch index -> (ray indices, radiance there)
        t0 = now()
        while True:
            i = len(self.requests)
            k, s, off = self._batch(i)
            a = now()
            with tracing.span("rtbench.batch", trace):
                rad, seg = self.trace(self.tables, self.pool_o[k],
                                      self.pool_d[k], s, off, self.depth,
                                      tile_rays=self.tile_rays, **self.extra)
                sync(self.device)
            b = now()
            self.requests.append((i, b - a, int(seg)))
            if self._checked(i):
                idx = self._rays(i)
                self.kept[i] = (idx, rad[idx])
            if b - t0 >= seconds:
                break
        self.window_s = b - t0

    def results(self) -> dict:
        lat = [q[1] * 1e3 for q in self.requests]
        n = len(lat)
        self.log(f"trace_p95_ms: {n} batches of {self.n} rays, "
                 f"{beyond(n, 95)} beyond the 95th percentile"
                 + ("" if beyond(n, 95) >= 10 else " (fewer than ten)"))
        self.segments = sum(q[2] for q in self.requests)
        return {"trace_p95_ms": percentile(lat, 95)}

    def release(self) -> None:
        del self.tables

    def observed(self, ref) -> list:
        segs = {q[0]: q[2] for q in self.requests if q[0] in self.kept}
        idx = chosen(len(self.kept), int(self.check["batches"]), self.seed,
                     "check")
        keys = sorted(self.kept)
        return [(keys[j], self.kept[keys[j]][0], self.kept[keys[j]][1],
                 segs[keys[j]]) for j in idx]

    def checks(self, observed=None, ref=None) -> list:
        ref = ref or reference_tables(self.config, self.device)
        observed = observed if observed is not None else self.observed(ref)
        off, total, prog, est = 0, 0, 0, 0.0
        for i, idx, prad, psegs in observed:
            k, s, toff = self._batch(i)
            rad, seg = rref.caller_paths(
                ref, self.pool_o[k][idx], self.pool_d[k][idx], idx, s, toff,
                self.tile_rays, self.depth)
            bad = ((prad - rad).abs() > RAY_ATOL + RAY_RTOL * rad.abs()).any(1)
            off += int(bad.sum())
            total += idx.numel()
            prog += psegs
            est += self.n * float(seg.double().mean())
        lim = self.limits()
        return [("ray_off_share", off / total, lim["ray_off_share"]),
                ("seg_gap", abs(prog - est) / est, lim["seg_gap"])]

    def control_observed(self, ref_low, n: int) -> list:
        out = []
        for i in range(n):
            k, s, toff = self._batch(i)
            idx = self._rays(i)
            rad, seg = rref.caller_paths(
                ref_low, self.pool_o[k][idx], self.pool_d[k][idx], idx, s,
                toff, self.tile_rays, self.depth)
            out.append((i, idx, rad, round(self.n * float(seg.double().mean()))))
        return out


DRIVE = RayBatches
