"""The two-level triangle rule with its bfloat16 reciprocal key
(raytracing_tpu_torch at commit a1403821e8fd, ``ops/trace.py``'s
``tri_stage1``, ``tri_stage2_keys``): the program takes it for triangle
tables past 512 rows (``two_level_rule``)."""

from __future__ import annotations

import torch

from rtbench.reference.trace import (BIGF_BITS, PAIRS, WIN, _bits,
                                     _pack_bits, _tri_keys)


def winner(t, rays):
    """Two-level rule: stage 1 takes each 128-row window's key minimum with
    its window id in the low bits; stage 2 sweeps the winning window (window
    0 without a hit) again with 7-bit row ids. Returns (hit, row)."""
    tri = t.tri
    m_pad = tri.m_pad
    if m_pad <= 512:
        raise ValueError("the reference has only the two-level triangle rule "
                         "(tables past 512 rows)")
    dev = t.device
    nw = m_pad // WIN
    mask = (1 << _pack_bits(nw)) - 1
    rmask = WIN - 1
    wids = torch.arange(nw, dtype=torch.int32, device=dev)
    rids = torch.arange(WIN, dtype=torch.int32, device=dev)
    n = rays[0].shape[0]
    best = torch.empty(n, dtype=torch.int32, device=dev)
    step = max(1, PAIRS // m_pad)
    for r0 in range(0, n, step):
        rs = slice(r0, r0 + step)
        key = _tri_keys(tri.cols, *[x[rs, None] for x in rays])
        wmin = key.view(key.shape[0], nw, WIN).amin(dim=2)
        best[rs] = ((_bits(wmin) & ~mask) | wids).min(dim=1).values
    start = (best & mask).long() * WIN
    kmin = torch.empty_like(best)
    step = max(1, PAIRS // WIN)
    for r0 in range(0, n, step):
        rs = slice(r0, r0 + step)
        rows = start[rs, None] + rids
        key = _tri_keys([col[rows] for col in tri.cols],
                        *[x[rs, None] for x in rays])
        kmin[rs] = ((_bits(key) & ~rmask) | rids).min(dim=1).values
    return kmin < (BIGF_BITS & ~rmask), start + (kmin & rmask).long()
