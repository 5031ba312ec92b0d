"""``renders``: ``Renderer.render()`` back to back, each under a fresh seed,
each from the call to the u8 image on the host (the wave loop, the regen
entry, readback). Reports ``mpaths_per_s``: the paths the cell asks for
(width x height x spp a render, counted by the benchmark) of every render
of the window over the window's time, renders counted whole.

Traffic keys: ``spp``, ``max_depth``, ``warmup_spp`` (the set-up render);
every other key is a keyword of ``Renderer`` (``max_rays_per_batch``,
``backend``, ...). Checks: ``renders`` renders x ``pixels`` pixels, every
sample of each, against the u8 the program returned; the program's
segment count against an estimate from ``segment_paths`` paths."""

from __future__ import annotations

import numpy as np
import torch

from rtbench import tracing
from rtbench.drives import (Drive, camera_dict, camera_params, chosen, now,
                            program_scene, reference_tables, sub_seed, sync)
from rtbench.reference import scene as rscene
from rtbench.reference import trace as rref


class Renders(Drive):
    kind = "renders"
    count_key = "renders"
    KNOWN = ("spp", "max_depth", "warmup_spp")

    def plan(self) -> None:
        t = self.traffic
        self.cam = camera_dict(self.config, t)
        self.width = int(self.cam["image_width"])
        self.height = rscene.image_height(self.cam)
        self.spp, self.depth = int(t["spp"]), int(t["max_depth"])
        self.slots = rref.num_slots(self.width, self.height)

    def setup(self) -> None:
        from raytracing_tpu_torch import Renderer

        self.plan()
        sync(self.device)
        t0 = now()
        scene = program_scene(self.config)
        self.renderer = Renderer(
            scene, camera_params(self.cam), seed=sub_seed(self.seed, "warm"),
            device=self.device, **self.passed())
        sync(self.device)
        self.build_ms = (now() - t0) * 1e3
        self.renderer.render(spp=int(self.traffic["warmup_spp"]),
                             max_depth=self.depth)
        sync(self.device)

    def _pixels(self, i: int):
        rng = np.random.default_rng(sub_seed(self.seed, f"pixels{i}"))
        flat = rng.choice(self.width * self.height, int(self.check["pixels"]),
                          replace=False)
        return flat % self.width, flat // self.width

    def window(self, seconds: float, trace: bool) -> None:
        r = self.renderer
        self.requests = []  # (seed, segments, px, py, u8 at those pixels)
        t0 = now()
        while True:
            s = sub_seed(self.seed, f"render{len(self.requests)}")
            r.reseed(s)
            with tracing.span("rtbench.render", trace):
                img = r.render(spp=self.spp, max_depth=self.depth)
            segments = r.segments_traced
            t1 = now()
            px, py = self._pixels(len(self.requests))
            self.requests.append((s, segments, px, py, img[py, px].copy()))
            if t1 - t0 >= seconds:
                break
        self.window_s = t1 - t0

    def results(self) -> dict:
        n = len(self.requests)
        paths = n * self.width * self.height * self.spp
        self.segments = sum(q[1] for q in self.requests)
        self.log(f"mpaths_per_s: {n} renders, {paths} paths ({self.segments} "
                 f"segments by the program's count) in {self.window_s:.4f} s")
        return {"mpaths_per_s": paths / self.window_s / 1e6}

    def release(self) -> None:
        del self.renderer

    def observed(self, ref) -> list:
        """What the window produced, for the checked renders: (seed, the
        program's segments, px, py, u8)."""
        idx = chosen(len(self.requests), int(self.check["renders"]),
                     self.seed, "check")
        return [self.requests[i] for i in idx]

    def _u8(self, ref, s: int, px, py) -> torch.Tensor:
        """The reference's u8 at pixels (px, py) of the render under seed
        ``s``: every sample of each pixel, summed in sample order."""
        cam_v = torch.from_numpy(rscene.camera_vector(self.cam))
        slots = rref.slot_of_pixel(torch.from_numpy(px), torch.from_numpy(py),
                                   self.width)
        rad, _ = rref.camera_paths(
            ref, cam_v, self.width, s, slots.repeat_interleave(self.spp),
            torch.arange(self.spp).repeat(len(px)), self.depth)
        inv = torch.reciprocal(torch.tensor(float(self.spp),
                                            device=self.device))
        return rref.to_u8(rref.pixel_sums(rad, self.spp) * inv).cpu()

    def _segments(self, ref, s: int, k: int, n: int) -> tuple[float, float]:
        """The render's segments estimated from ``n`` (slot, sample) paths
        drawn uniformly over every slot of the image's whole 32 x 32 tiles
        and every sample: over all those slots, and over the image's own
        pixels alone (the paths that fall on them)."""
        g = torch.Generator().manual_seed(sub_seed(self.seed, f"segs{k}"))
        slots = torch.randint(self.slots, (n,), generator=g)
        samples = torch.randint(self.spp, (n,), generator=g)
        _, seg = rref.camera_paths(
            ref, torch.from_numpy(rscene.camera_vector(self.cam)), self.width,
            s, slots, samples, self.depth)
        seg = seg.double().cpu()
        px, py = rref.pixel_of_slot(slots, self.width)
        own = (px < self.width) & (py < self.height)
        return (self.slots * self.spp * float(seg.mean()),
                self.width * self.height * self.spp * float(seg[own].mean()))

    def checks(self, observed=None, ref=None) -> list:
        ref = ref or reference_tables(self.config, self.device)
        observed = observed if observed is not None else self.observed(ref)
        n_seg = max(1, int(self.check["segment_paths"]) // len(observed))
        gaps, prog, est_all, est_own = [], 0, 0.0, 0.0
        for k, (s, segments, px, py, vals) in enumerate(observed):
            u8 = self._u8(ref, s, px, py)
            gaps.append((u8.int() - torch.from_numpy(vals).int()).abs())
            prog += int(segments)
            a, b = self._segments(ref, s, k, n_seg)
            est_all += a
            est_own += b
        lim = self.limits()
        # The program may trace the padding slots of the last tiles or not.
        seg_gap = min(abs(prog - est_all) / est_all,
                      abs(prog - est_own) / est_own)
        return [("u8_gap", float(torch.cat(gaps).float().mean()),
                 lim["u8_gap"]),
                ("seg_gap", seg_gap, lim["seg_gap"])]

    def control_observed(self, ref_low, n: int) -> list:
        """The checked renders' records with the control in the program's
        place: its pixels and its segment estimate over every slot."""
        n_seg = max(1, int(self.check["segment_paths"]) // n)
        out = []
        for k in range(n):
            s = sub_seed(self.seed, f"render{k}")
            px, py = self._pixels(k)
            out.append((s, round(self._segments(ref_low, s, k, n_seg)[0]), px,
                        py, self._u8(ref_low, s, px, py).numpy()))
        return out


DRIVE = Renders
