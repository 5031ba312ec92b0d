"""The program's per-block box cull worked out again, and a replay of it:
the benchmark's own count of the sphere sweep's work that the cull leaves.

Frozen copies (raytracing_tpu_torch at commit 22b7b5f1dcb6,
``ops/cull.py``), of the box kind at one box a block, the program's
default (``RT_CULL=1``, ``RT_CULL_SUB=1``): ``_f32``, ``_sqrt``,
``_norm3``, ``box_block_bounds`` and ``block_bounds`` (boxes over the
rows' ``c -+ r``, widened, ordered front to back from an origin),
``_safe_inv``, ``gate_pre``, ``_upper_bound`` and ``cull_gate_box`` for
sphere keys (the unscaled roots ``a * t``). The bounding-sphere kind
(``order_bounds``) and more boxes a block are other settings, not copied.

``replay`` visits a table's 512-row blocks in the bound tables' order, as
``ops/trace.py::sphere_stage1`` does, gating each against the ray's
running stage-1 key of the two-level rule (each window's key minimum
packed with its window id) and sweeping the blocks that pass. Which
(segment, block) pairs pass depends on the rays and the table alone, not
on how the kernel schedules them.
"""

from __future__ import annotations

import struct

import torch

from .trace import (BIGF_BITS, PAIRS, T_MIN, WIN, _bits, _pack_bits,
                    _sphere_key)

BLOCK_ROWS = 512        # the sphere sweep's and the cull's block rows
CULL_GRAZE_EPS = 5.0e-3
CULL_SLAB_EPS = 1.0e-5
_BIG_BOX = 3.0e37
_FAR = 3.0e38


def _f32(x: float) -> float:
    return struct.unpack("<f", struct.pack("<f", x))[0]


_TF_MIN_SPHERE = _f32(T_MIN * 0.999)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root (taken in f64, rounded once)."""
    return torch.sqrt(x.double()).to(x.dtype)


def _norm3(v: torch.Tensor) -> torch.Tensor:
    return _sqrt(
        v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]
    )


def box_block_bounds(row_lo, row_hi, n_valid: int, blk: int, origin):
    """Per-block AABBs over ``blk`` rows, widened, in visit order (front
    to back from ``origin``); rows from ``n_valid`` on are padding.
    Returns (order i32[nb], rows f32[nb, 8]: lo xyz, hi xyz, bmag,
    valid)."""
    n_pad = row_lo.shape[0]
    nb = n_pad // blk
    dev = row_lo.device
    valid = (torch.arange(n_pad, device=dev) < n_valid).reshape(nb, blk, 1)
    lo = torch.where(valid, row_lo.reshape(nb, blk, 3), _BIG_BOX).amin(dim=1)
    hi = torch.where(valid, row_hi.reshape(nb, blk, 3), -_BIG_BOX).amax(dim=1)
    has = valid.any(dim=1)[:, 0]
    pad = (
        1.0e-3
        + 1.0e-6 * torch.maximum(lo.abs(), hi.abs())
        + 1.0e-3 * (hi - lo)
    )
    lo_w = torch.where(has[:, None], lo - pad, 0.0)
    hi_w = torch.where(has[:, None], hi + pad, 0.0)
    bmag = _norm3(torch.maximum(lo_w.abs(), hi_w.abs()))
    org = origin[None, :]
    gap = torch.clamp(torch.maximum(lo_w - org, org - hi_w), min=0.0)
    d = torch.where(has, _norm3(gap), _FAR)
    order = torch.argsort(d, stable=True)
    rows = torch.cat(
        [lo_w, hi_w, bmag[:, None], has.to(lo_w.dtype)[:, None]], dim=1
    )
    return order.to(torch.int32), rows[order].contiguous()


def block_bounds(sph, origin):
    """The sphere table's block boxes over ``c -+ r`` (``sph`` a
    ``SphereTable``), ordered from ``origin`` (the camera centre)."""
    centers = torch.stack([sph.cx, sph.cy, sph.cz], dim=1)
    r3 = sph.r[:, None]
    return box_block_bounds(centers - r3, centers + r3, sph.n_actual,
                            min(sph.n_pad, BLOCK_ROWS),
                            origin.to(centers.device, centers.dtype))


def _safe_inv(c: torch.Tensor) -> torch.Tensor:
    """1 / c with |c| clamped to at least 1e-30 and its sign kept."""
    sign = c.view(torch.int32) & -0x80000000
    mag = torch.clamp(c.abs(), min=1.0e-30)
    return 1.0 / (mag.view(torch.int32) | sign).view(torch.float32)


def gate_pre(rays):
    """|o|, the safe reciprocals of d and o * (1/d) of each ray."""
    ox, oy, oz, dx, dy, dz = rays
    so = _sqrt(ox * ox + oy * oy + oz * oz)
    iv = (_safe_inv(dx), _safe_inv(dy), _safe_inv(dz))
    return so, iv, (ox * iv[0], oy * iv[1], oz * iv[2])


def _upper_bound(carry, id_mask: int):
    return (carry | id_mask).view(torch.float32)


def cull_gate_box(pre, bound, a, carry, id_mask: int):
    """Per-ray pass mask of one block's margined box (``bound``: its 8
    floats) below the ray's current best (``carry``, the packed stage-1
    key, whose low ``id_mask`` bits are ids). A NaN lane passes."""
    so, iv, oi = pre
    cur_hi = _upper_bound(carry, id_mask)
    lo, hi, bmag, bval = bound[0:3], bound[3:6], bound[6], bound[7]
    ds = CULL_GRAZE_EPS * (so + bmag)
    tn = tf = None
    for j in range(3):
        t1 = lo[j] * iv[j] - oi[j]
        t2 = hi[j] * iv[j] - oi[j]
        m = ds * iv[j].abs() + CULL_SLAB_EPS * (
            t1.abs() + t2.abs() + 2.0 * oi[j].abs()
        )
        tn_j = torch.minimum(t1, t2) - m
        tf_j = torch.maximum(t1, t2) + m
        tn = tn_j if tn is None else torch.maximum(tn, tn_j)
        tf = tf_j if tf is None else torch.minimum(tf, tf_j)
    rej = (
        (tn > tf)
        | (tf <= _TF_MIN_SPHERE)
        | (tn * a > cur_hi + 1.0e-3 + 1.0e-3 * cur_hi.abs())
    )
    return ~rej & (bval > 0.5)


def replay(t, rays, order, rows):
    """The gate's votes of ``rays`` (float32 tensors [R] each) on the
    sphere table of ``t`` (the reference's ``Tables``): bool [R, nb], True
    where the ray's gate passes table block b, each block visited in the
    bound tables' ``order`` against the running stage-1 key of the
    two-level rule, which the blocks that pass update."""
    s = t.sph
    dev = t.device
    ox, oy, oz, dx, dy, dz = rays
    a = dx * dx + dy * dy + dz * dz
    terms = (ox, oy, oz, dx, dy, dz, a, dx * ox + dy * oy + dz * oz,
             ox * ox + oy * oy + oz * oz, T_MIN * a)
    blk = min(s.n_pad, BLOCK_ROWS)
    wpb = blk // WIN
    mask = (1 << _pack_bits(s.n_pad // WIN)) - 1
    best = torch.full(ox.shape, BIGF_BITS & ~mask, dtype=torch.int32,
                      device=dev)
    pre = gate_pre(rays)
    c_all = (s.cx, s.cy, s.cz, -2.0 * s.cx, -2.0 * s.cy, -2.0 * s.cz, s.cm2)
    passed = torch.zeros((ox.shape[0], s.n_pad // blk), dtype=torch.bool,
                         device=dev)
    step = max(1, PAIRS // blk)
    for v, b in enumerate(order.tolist()):
        p = cull_gate_box(pre, rows[v], a, best, mask)
        passed[:, b] = p
        idx = torch.nonzero(p).squeeze(1)
        c = tuple(col[b * blk:(b + 1) * blk] for col in c_all)
        ids = torch.arange(b * wpb, (b + 1) * wpb, dtype=torch.int32,
                           device=dev)
        for r0 in range(0, idx.numel(), step):
            rs = idx[r0:r0 + step]
            key = _sphere_key(c, [x[rs, None] for x in terms])
            wmin = key.view(key.shape[0], wpb, WIN).amin(dim=2)
            ki = ((_bits(wmin) & ~mask) | ids).min(dim=1).values
            best[rs] = torch.minimum(best[rs], ki)
    return passed


def real_rows(sph) -> torch.Tensor:
    """The real rows of each table block (int64 [nb])."""
    blk = min(sph.n_pad, BLOCK_ROWS)
    first = torch.arange(0, sph.n_pad, blk)
    return torch.clamp(sph.n_actual - first, 0, blk)


class Replay:
    """A sphere rule that replays the gate on the rays it is given (one a
    segment: ``trace.bounce`` asks for each bounce's rays) and adds up the
    segments, their passing (segment, block) pairs and the real rows of
    those blocks, then lets ``rule`` pick the winners."""

    def __init__(self, rule, order, rows) -> None:
        self.rule = rule
        self.order = order
        self.rows = rows
        self.segments = 0
        self.passes = 0
        self.swept = 0

    def winner(self, t, rays):
        p = replay(t, rays, self.order, self.rows)
        self.segments += p.shape[0]
        self.passes += int(p.sum())
        self.swept += int((p.sum(dim=0).cpu() * real_rows(t.sph)).sum())
        return self.rule.winner(t, rays)
