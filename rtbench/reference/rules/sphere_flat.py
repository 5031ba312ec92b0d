"""The flat sphere rule: every row of the table swept for every ray, the
smallest key kept with its row id in the low bits (raytracing_tpu_torch at
commit a1403821e8fd, ``ops/trace.py::sphere_stage1`` without blocks). The
program takes it for sphere tables below 8,192 rows (``two_level_rule``);
its cull changes no bit (a culled block holds no key below a ray's best)."""

from __future__ import annotations

import torch

from rtbench.reference.trace import (BIGF_BITS, PAIRS, T_MIN, _bits,
                                     _pack_bits, _sphere_key)


def winner(t, rays):
    """Flat rule: min over rows of ``(bits(key) & ~mask) | row``; returns
    (hit, row)."""
    s = t.sph
    ox, oy, oz, dx, dy, dz = rays
    a = dx * dx + dy * dy + dz * dz
    terms = (ox, oy, oz, dx, dy, dz, a, dx * ox + dy * oy + dz * oz,
             ox * ox + oy * oy + oz * oz, T_MIN * a)
    n_pad = s.n_pad
    mask = (1 << _pack_bits(n_pad)) - 1
    c = (s.cx, s.cy, s.cz, -2.0 * s.cx, -2.0 * s.cy, -2.0 * s.cz, s.cm2)
    ids = torch.arange(n_pad, dtype=torch.int32, device=t.device)
    best = torch.empty(ox.shape, dtype=torch.int32, device=t.device)
    step = max(1, PAIRS // n_pad)
    for r0 in range(0, ox.shape[0], step):
        rs = slice(r0, r0 + step)
        key = _sphere_key(c, [x[rs, None] for x in terms])
        best[rs] = ((_bits(key) & ~mask) | ids).min(dim=1).values
    return best < (BIGF_BITS & ~mask), (best & mask).long()
