"""``culled_renders``: the ``renders`` drive on a table that the program
culls, keeping beside each render of the window the program's counts of
the cull's work (``Renderer.cull_counts``, taken in the render's own wait
for its segments; None from a program without them). The readers of the
cull's metrics also take, once and lazily, the reference's count of the
same work: the gate's passing blocks per segment over ``cull_paths``
(slot, sample) paths of the window's first render, drawn uniformly over
every slot and sample as the segment estimate draws its paths, replayed
by ``reference/cull.py`` (the box cull at one box a block, blocks ordered
from the camera centre).

Traffic keys: those of ``renders``; ``check.cull_paths`` the paths of the
reference's count. The checks are ``renders``'s: the cull's counts are
the program's own business, which a better cull may change."""

from __future__ import annotations

import dataclasses
import functools

import torch

from rtbench import plugins, spec
from rtbench.drives import reference_tables, sub_seed
from rtbench.reference import cull as rcull
from rtbench.reference import scene as rscene
from rtbench.reference import trace as rref

Renders = plugins.load(spec.ROOT, "drives", "renders").DRIVE


class CulledRenders(Renders):
    def window(self, seconds: float, trace: bool) -> None:
        r = self.renderer
        render = r.render
        self.cull = []  # each render's cull_counts (None without them)

        def counted(*a, **k):
            img = render(*a, **k)
            self.cull.append(getattr(r, "cull_counts", None))
            return img

        r.render = counted
        try:
            super().window(seconds, trace)
        finally:
            del r.render

    @functools.cached_property
    def reference_passes(self) -> tuple[int, int, int]:
        """(segments, passing (segment, block) pairs, real rows of those
        blocks) of the reference's replay over ``cull_paths`` paths of the
        window's first render."""
        ref = reference_tables(self.config, self.device)
        cam_v = torch.from_numpy(rscene.camera_vector(self.cam))
        order, rows = rcull.block_bounds(ref.sph, cam_v[9:12])
        counter = rcull.Replay(ref.sphere_rule, order, rows)
        g = torch.Generator().manual_seed(sub_seed(self.seed, "cull"))
        n = int(self.check["cull_paths"])
        slots = torch.randint(self.slots, (n,), generator=g)
        samples = torch.randint(self.spp, (n,), generator=g)
        rref.camera_paths(dataclasses.replace(ref, sphere_rule=counter),
                          cam_v, self.width, self.requests[0][0], slots,
                          samples, self.depth)
        return counter.segments, counter.passes, counter.swept


DRIVE = CulledRenders
