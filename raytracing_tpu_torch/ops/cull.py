"""Per-block conservative box cull of the stage-1 sweeps: the bound tables
and the gate, plain PyTorch.

Counterpart of the AABB cull of ``raytracing_tpu/ops/pallas/trace.py``
(``_order_bounds``, ``_box_block_bounds``, ``_block_bounds``,
``_tri_block_bounds``, ``_gate_pre``, ``_cull_gate_box``). A sweep over
several blocks of table rows visits them front to back from an origin
proxy (the camera center) and skips a block for a ray when the ray cannot
produce a candidate key inside the block's widened box strictly closer
than its current best. The skip is bit-transparent: the stage-1 minimum,
and so the image, is the same with the cull on or off. Visit order never
changes the bits (the minimum is an integer minimum); it only tightens the
current best early.

The JAX package votes once per (t_sub, 128) ray tile; here the gate returns
a per-ray pass mask (the kernel votes per thread and per block of threads),
so the margins alone carry conservativeness: no other lane can rescue a
wrong reject. The expressions and their order are the JAX package's; the
reject test is written negated, so a NaN from slab-product overflow passes
(fail-closed).

Bound table layout (``box_block_bounds``): one row of 8 f32 per block, in
VISIT order: ``lox, loy, loz, hix, hiy, hiz, bmag, valid``, where ``bmag``
bounds ``|p|`` over the widened box and ``valid`` is 1.0 for a block with
any live primitive (an all-padding block never passes); ``order[v]`` is
the table block visited at step ``v``.
"""

from __future__ import annotations

import struct

import torch

# Margins of the box gate (the JAX package's _CULL_GRAZE_EPS and
# _CULL_SLAB_EPS): the per-axis window grows by GRAZE * (|o| + bmag) *
# |1/d_axis| for sweep-side root rounding (grazing discriminant flips), and
# by SLAB * (|t1| + |t2| + 2|o/d_axis|) for the gate's own cancelling slab
# arithmetic.
CULL_GRAZE_EPS = 5.0e-3
CULL_SLAB_EPS = 1.0e-5

_T_MIN = 1.0e-4
_BIG_BOX = 3.0e37      # empty-reduction seed of the per-block min / max
_FAR = 3.0e38          # visit distance of an all-padding block


def _f32(x: float) -> float:
    """``x`` rounded to float32, as the JAX package's weak-typed Python
    constants are when they meet an f32 array."""
    return struct.unpack("<f", struct.pack("<f", x))[0]


_TF_MIN_SPHERE = _f32(_T_MIN * 0.999)
_TF_MIN_TRI = _f32(_T_MIN * 0.99)


def _norm3(v: torch.Tensor) -> torch.Tensor:
    """Row norms of an [n, 3] tensor, summed x, then y, then z."""
    return torch.sqrt(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1] + v[:, 2] * v[:, 2])


def order_bounds(ctr, rad, has, origin):
    """Front-to-back visit order of bounding-sphere blocks (the JAX
    package's ``_order_bounds``): sort by the origin's distance to each
    bound's near surface, all-padding blocks last; returns
    (order i32[nb], bounds f32[nb * 4] = [C, |C|^2 - R^2] in visit order)."""
    bm2 = torch.where(
        has, ctr[:, 0] * ctr[:, 0] + ctr[:, 1] * ctr[:, 1]
        + ctr[:, 2] * ctr[:, 2] - rad * rad, _FAR,
    )
    bounds = torch.cat([ctr, bm2[:, None]], dim=1)
    d = _norm3(ctr - origin[None, :]) - rad
    d = torch.where(has, d, _FAR)
    order = torch.argsort(d, stable=True)
    return order.to(torch.int32), bounds[order].reshape(-1)


def box_block_bounds(row_lo, row_hi, n_valid: int, blk: int, origin):
    """Per-block AABBs over ``blk`` table rows (the JAX package's
    ``_box_block_bounds`` with one box per block), visit-ordered front to
    back from ``origin``. ``row_lo`` / ``row_hi`` are per-row conservative
    boxes (sphere ``c -+ r``; triangle vertex min / max); rows from
    ``n_valid`` on are padding. Returns (order i32[nb], bounds f32[nb, 8]).

    The box is widened (absolute, coordinate-relative and extent-relative
    pads) so it still holds every primitive after f32 rounding."""
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
    # Visit distance: from the origin to the widened box.
    org = origin[None, :]
    gap = torch.clamp(torch.maximum(lo_w - org, org - hi_w), min=0.0)
    d = torch.where(has, _norm3(gap), _FAR)
    order = torch.argsort(d, stable=True)
    rows = torch.cat(
        [lo_w, hi_w, bmag[:, None], has.to(lo_w.dtype)[:, None]], dim=1
    )
    return order.to(torch.int32), rows[order].contiguous()


def block_bounds(centers, radii, n_valid: int, blk: int, origin):
    """Sphere blocks (the JAX package's ``_block_bounds``, box kind)."""
    r3 = radii[:, None]
    return box_block_bounds(centers - r3, centers + r3, n_valid, blk, origin)


def tri_block_bounds(v0, e1, e2, m_valid: int, blk: int, origin):
    """Triangle blocks over the vertices v0, v0 + e1, v0 + e2 (the JAX
    package's ``_tri_block_bounds``, box kind)."""
    p1 = v0 + e1
    p2 = v0 + e2
    tlo = torch.minimum(torch.minimum(v0, p1), p2)
    thi = torch.maximum(torch.maximum(v0, p1), p2)
    return box_block_bounds(tlo, thi, m_valid, blk, origin)


def _safe_inv(c: torch.Tensor) -> torch.Tensor:
    """1 / c with |c| clamped to at least 1e-30 and its sign kept (through
    the bit pattern, so -0.0 gives -1e30): an exactly axis-parallel ray
    gets a huge but finite window on that axis."""
    sign = c.view(torch.int32) & -0x80000000
    mag = torch.clamp(c.abs(), min=1.0e-30)
    return 1.0 / (mag.view(torch.int32) | sign).view(torch.float32)


def gate_pre(rays):
    """Per-ray precomputes of the gate (``_gate_pre``, box kind), hoisted
    out of the block loop: |o|, the safe reciprocals of d, o * (1/d)."""
    ox, oy, oz, dx, dy, dz = rays
    so = torch.sqrt(ox * ox + oy * oy + oz * oz)
    iv = (_safe_inv(dx), _safe_inv(dy), _safe_inv(dz))
    oi = (ox * iv[0], oy * iv[1], oz * iv[2])
    return so, iv, oi


def cull_gate_box(pre, bound, a, carry, id_mask: int, *, scaled_key: bool,
                  hint=None):
    """Per-ray pass mask of one block (``_cull_gate_box``'s vote before the
    any-reduction): True where the ray may produce a candidate key inside
    the block's margined box below its current best.

    ``pre`` is ``gate_pre`` of the rays, ``bound`` the block's 8-float row,
    ``a`` = |d|^2, ``carry`` the int32 packed-key minimum so far (its low
    ``id_mask`` bits are ids, so ``carry | id_mask`` as f32 bounds the
    winning key from above). ``scaled_key``: sphere keys are unscaled roots
    ``a * t``; triangle keys are approximate t (1% compare slack). ``hint``:
    an external per-ray upper bound in the key's units (the sphere
    winner's exact t, for the triangle gate)."""
    so, iv, oi = pre
    lo, hi, bmag, bval = bound[0:3], bound[3:6], bound[6], bound[7]
    ds = CULL_GRAZE_EPS * (so + bmag)
    tn = tf = None
    for k in range(3):
        t1 = lo[k] * iv[k] - oi[k]
        t2 = hi[k] * iv[k] - oi[k]
        m = ds * iv[k].abs() + CULL_SLAB_EPS * (
            t1.abs() + t2.abs() + 2.0 * oi[k].abs()
        )
        tn_k = torch.minimum(t1, t2) - m
        tf_k = torch.maximum(t1, t2) + m
        tn = tn_k if tn is None else torch.maximum(tn, tn_k)
        tf = tf_k if tf is None else torch.minimum(tf, tf_k)
    cur_hi = (carry | id_mask).view(torch.float32)
    if hint is not None:
        cur_hi = torch.minimum(cur_hi, hint)
    # Negated reject form: a NaN lane compares false everywhere and passes.
    if scaled_key:
        rej = (
            (tn > tf)
            | (tf <= _TF_MIN_SPHERE)
            | (tn * a > cur_hi + 1.0e-3 + 1.0e-3 * cur_hi.abs())
        )
    else:
        rej = (
            (tn > tf)
            | (tf <= _TF_MIN_TRI)
            | (tn > cur_hi + 0.01 * cur_hi.abs() + 1.0e-3)
        )
    return ~rej & (bval > 0.5)
