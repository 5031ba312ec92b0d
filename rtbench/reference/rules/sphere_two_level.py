"""The two-level sphere rule (raytracing_tpu_torch at commit 22b7b5f1dcb6,
``ops/trace.py``'s ``sphere_stage1`` under the two-level rule, without
blocks, and ``sphere_stage2_keys``): the program takes it for sphere
tables from 8,192 rows (``two_level_rule``). Near ties go as the packed
keys decide them: stage 1 packs window ids, not row ids, so the flat rule
can pick another winner. The program's cull changes no bit (a culled
block holds no key below a ray's best) and its stage 2, folded into stage
1, keeps the same key."""

from __future__ import annotations

import torch

from rtbench.reference.trace import (BIGF_BITS, PAIRS, T_MIN, WIN, _bits,
                                     _pack_bits, _sphere_key)


def winner(t, rays):
    """Two-level rule: stage 1 takes each 128-row window's key minimum with
    its window id in the low ``_pack_bits(windows)`` bits; stage 2 sweeps
    the winning window (window 0 without a hit) again with 7-bit row ids.
    Returns (hit, row)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    s = t.sph
    n_pad = s.n_pad
    if n_pad < 2 * WIN:
        raise ValueError("the two-level rule needs two windows")
    dev = t.device
    ox, oy, oz, dx, dy, dz = rays
    a = dx * dx + dy * dy + dz * dz
    terms = (ox, oy, oz, dx, dy, dz, a, dx * ox + dy * oy + dz * oz,
             ox * ox + oy * oy + oz * oz, T_MIN * a)
    nw = n_pad // WIN
    mask = (1 << _pack_bits(nw)) - 1
    rmask = WIN - 1
    wids = torch.arange(nw, dtype=torch.int32, device=dev)
    rids = torch.arange(WIN, dtype=torch.int32, device=dev)
    c = (s.cx, s.cy, s.cz, -2.0 * s.cx, -2.0 * s.cy, -2.0 * s.cz, s.cm2)
    n = ox.shape[0]
    best = torch.empty(n, dtype=torch.int32, device=dev)
    step = max(1, PAIRS // n_pad)
    for r0 in range(0, n, step):
        rs = slice(r0, r0 + step)
        key = _sphere_key(c, [x[rs, None] for x in terms])
        wmin = key.view(key.shape[0], nw, WIN).amin(dim=2)
        best[rs] = ((_bits(wmin) & ~mask) | wids).min(dim=1).values
    start = (best & mask).long() * WIN
    kmin = torch.empty_like(best)
    step = max(1, PAIRS // WIN)
    for r0 in range(0, n, step):
        rs = slice(r0, r0 + step)
        rows = start[rs, None] + rids
        cw = tuple(col[rows] for col in c)
        key = _sphere_key(cw, [x[rs, None] for x in terms])
        kmin[rs] = ((_bits(key) & ~rmask) | rids).min(dim=1).values
    return kmin < (BIGF_BITS & ~rmask), start + (kmin & rmask).long()
