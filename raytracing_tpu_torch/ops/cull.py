"""Per-block conservative cull of the stage-1 sweeps: the bound tables and
the gate, plain PyTorch.

Counterpart of the cull of ``raytracing_tpu/ops/pallas/trace.py``
(``_cull_kind``, ``_cull_sub``, ``_cull_hint``, ``_order_bounds``,
``_box_block_bounds``, ``_block_bounds``, ``_tri_block_bounds``,
``_gate_pre``, ``_cull_gate_box``, ``_cull_gate``). A sweep over several
blocks of table rows visits them front to back from an origin proxy (the
camera center, or the mean ray origin) and skips a block for a ray when
the ray cannot produce a candidate key inside the block's widened bound
strictly closer than its current best. The skip is bit-transparent: the
stage-1 minimum, and so the image, is the same with the cull on or off.
Visit order never changes the bits (the minimum is an integer minimum); it
only tightens the current best early.

Two bound shapes, as the JAX package has them (``RT_CULL``):

* ``"box"`` (the default): ``sub`` axis-aligned boxes per block
  (``RT_CULL_SUB``), one row of ``8 * sub`` f32 per block in VISIT order:
  ``sub`` records ``lox, loy, loz, hix, hiy, hiz, bmag, valid``, one per
  contiguous ``blk // sub``-row sub-range, where ``bmag`` bounds ``|p|``
  over the widened sub-box and ``valid`` is 1.0 for a sub-box with any live
  primitive (an all-padding sub-box never passes). A block passes when any
  of its sub-boxes passes. NaN from slab-product overflow passes
  (fail-closed: the reject test is written negated).
* ``"sphere"``: one bounding sphere per block, a row of 4 f32 ``cx, cy,
  cz, |C|^2 - R^2`` in visit order (an all-padding block has ``+3e38`` as
  its last column, so its discriminant is never positive). Its NaN
  convention is the opposite of the box gate's: a NaN discriminant means
  no intersection and rejects.

``order[v]`` is the table block visited at step ``v``.

The JAX package votes once per (t_sub, 128) ray tile; here the gate returns
a per-ray pass mask (the kernel votes per thread and per block of threads),
so the margins alone carry conservativeness: no other lane can rescue a
wrong reject. The expressions and their order are the JAX package's.
"""

from __future__ import annotations

import os
import struct

import torch

# Margins of the box gate (the JAX package's _CULL_GRAZE_EPS and
# _CULL_SLAB_EPS): the per-axis window grows by GRAZE * (|o| + bmag) *
# |1/d_axis| for sweep-side root rounding (grazing discriminant flips), and
# by SLAB * (|t1| + |t2| + 2|o/d_axis|) for the gate's own cancelling slab
# arithmetic.
CULL_GRAZE_EPS = 5.0e-3
CULL_SLAB_EPS = 1.0e-5
# Margin of the sphere gate (_CULL_DELTA_EPS): the bound's quadratic is a
# cancellation of |C|^2-scale terms, so its discriminant and root are
# widened at the uncancelled magnitude scale (Cauchy-Schwarz bounds).
CULL_DELTA_EPS = 1.0e-5

KINDS = ("box", "sphere")

_T_MIN = 1.0e-4
_BIG_BOX = 3.0e37      # empty-reduction seed of the per-block min / max
_FAR = 3.0e38          # visit distance of an all-padding block


def _f32(x: float) -> float:
    """``x`` rounded to float32, as the JAX package's weak-typed Python
    constants are when they meet an f32 array."""
    return struct.unpack("<f", struct.pack("<f", x))[0]


_TF_MIN_SPHERE = _f32(_T_MIN * 0.999)
_TF_MIN_TRI = _f32(_T_MIN * 0.99)


def env_settings() -> tuple[str | None, int, bool]:
    """The cull defaults from the environment, read and validated as the
    JAX package reads them (``_cull_kind``, ``_cull_sub``, ``_cull_hint``),
    so the same environment picks the same gate in both packages:

    * ``RT_CULL``: "0" (off: None), "1" (the default: "box"), "box" or
      "sphere";
    * ``RT_CULL_SUB``: sub-boxes per block of the box kind, a power of two
      in [1, 8] (default 1; ``clamp_sub`` fits it to a block);
    * ``RT_CULL_HINT``: "1" (default) or "0": whether the sphere winner's
      exact t bounds the triangle gate.

    Returns (kind, sub, hint); a bad value raises ``ValueError``."""
    v = os.environ.get("RT_CULL", "1")
    if v not in ("0", "1", "sphere", "box"):
        raise ValueError(
            f"RT_CULL={v!r} must be one of '0', '1', 'sphere', 'box'"
        )
    kind = None if v == "0" else ("box" if v == "1" else v)
    sub = int(os.environ.get("RT_CULL_SUB", "1"))
    if sub < 1 or sub > 8 or (sub & (sub - 1)) != 0:
        raise ValueError(f"RT_CULL_SUB={sub} must be a power of two in [1, 8]")
    h = os.environ.get("RT_CULL_HINT", "1")
    if h not in ("0", "1"):
        raise ValueError(f"RT_CULL_HINT={h!r} must be '0' or '1'")
    return kind, sub, h == "1"


def clamp_sub(sub: int, blk: int) -> int:
    """Sub-boxes per ``blk``-row block: ``sub`` halved until each sub-box
    covers at least 64 rows (the JAX package's ``_cull_sub``)."""
    while sub > 1 and blk // sub < 64:
        sub //= 2
    return sub


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root on every device, as XLA and
    CUDA's ``sqrtf`` give it: torch's float32 CPU kernel can be an ulp off.
    The root is taken in f64 and rounded once (f64 carries more than 2 * 24
    + 2 bits, so rounding twice gives the same f32)."""
    return torch.sqrt(x.double()).to(x.dtype)


def _norm3(v: torch.Tensor) -> torch.Tensor:
    """Norms over the last axis of [..., 3], summed x, then y, then z."""
    return _sqrt(
        v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]
    )


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


def box_block_bounds(row_lo, row_hi, n_valid: int, blk: int, origin,
                     sub: int = 1):
    """Per-block AABBs over ``blk`` table rows (the JAX package's
    ``_box_block_bounds``), ``sub`` sub-boxes of ``blk // sub`` rows each,
    visit-ordered front to back from ``origin`` by the nearest of a block's
    sub-boxes. ``row_lo`` / ``row_hi`` are per-row conservative boxes
    (sphere ``c -+ r``; triangle vertex min / max); rows from ``n_valid``
    on are padding. Returns (order i32[nb], bounds f32[nb, 8 * sub]).

    The box is widened (absolute, coordinate-relative and extent-relative
    pads) so it still holds every primitive after f32 rounding."""
    n_pad = row_lo.shape[0]
    nb = n_pad // blk
    nsb = nb * sub
    sblk = blk // sub
    dev = row_lo.device
    valid = (torch.arange(n_pad, device=dev) < n_valid).reshape(nsb, sblk, 1)
    lo = torch.where(valid, row_lo.reshape(nsb, sblk, 3), _BIG_BOX).amin(dim=1)
    hi = torch.where(valid, row_hi.reshape(nsb, sblk, 3), -_BIG_BOX).amax(dim=1)
    has = valid.any(dim=1)[:, 0]
    pad = (
        1.0e-3
        + 1.0e-6 * torch.maximum(lo.abs(), hi.abs())
        + 1.0e-3 * (hi - lo)
    )
    lo_w = torch.where(has[:, None], lo - pad, 0.0)
    hi_w = torch.where(has[:, None], hi + pad, 0.0)
    bmag = _norm3(torch.maximum(lo_w.abs(), hi_w.abs()))
    # Visit distance: from the origin to the block's nearest sub-box.
    org = origin[None, :]
    gap = torch.clamp(torch.maximum(lo_w - org, org - hi_w), min=0.0)
    d = torch.where(has, _norm3(gap), _FAR)
    order = torch.argsort(d.reshape(nb, sub).amin(dim=1), stable=True)
    rows = torch.cat(
        [lo_w, hi_w, bmag[:, None], has.to(lo_w.dtype)[:, None]], dim=1
    ).reshape(nb, 8 * sub)
    return order.to(torch.int32), rows[order].contiguous()


def _sphere_rows(ctr, rad, has, origin):
    order, bounds = order_bounds(ctr, rad, has, origin)
    return order, bounds.reshape(-1, 4).contiguous()


def block_bounds(centers, radii, n_valid: int, blk: int, origin,
                 kind: str = "box", sub: int = 1):
    """Sphere blocks (the JAX package's ``_block_bounds``): ``sub`` boxes
    over ``c -+ r`` per block (``kind`` "box"), or one bounding sphere
    (``kind`` "sphere": the center of the block's box, radius the farthest
    ``|c - C| + r``, widened to ``1.001 R + 1e-3`` so the f32 gate stays
    conservative). Returns (order i32[nb], bounds f32[nb, 8 * sub] or
    f32[nb, 4])."""
    r3 = radii[:, None]
    if kind == "box":
        return box_block_bounds(centers - r3, centers + r3, n_valid, blk,
                                origin, sub)
    n_pad = centers.shape[0]
    nb = n_pad // blk
    valid = (torch.arange(n_pad, device=centers.device) < n_valid).reshape(
        nb, blk, 1)
    c = centers.reshape(nb, blk, 3)
    r = radii.reshape(nb, blk, 1)
    lo = torch.where(valid, c - r, _BIG_BOX).amin(dim=1)
    hi = torch.where(valid, c + r, -_BIG_BOX).amax(dim=1)
    has = valid.any(dim=1)[:, 0]
    ctr = torch.where(has[:, None], 0.5 * (lo + hi), 0.0)
    dist = _norm3(c - ctr[:, None, :])[..., None] + r
    rad = torch.where(valid, dist, 0.0).amax(dim=1)[:, 0]
    rad = rad * 1.001 + 1.0e-3
    return _sphere_rows(ctr, rad, has, origin)


def tri_block_bounds(v0, e1, e2, m_valid: int, blk: int, origin,
                     kind: str = "box", sub: int = 1):
    """Triangle blocks over the vertices v0, v0 + e1, v0 + e2 (the JAX
    package's ``_tri_block_bounds``): ``sub`` boxes per block, or one
    bounding sphere around the center of the block's box through the
    farthest corner of each triangle's box."""
    p1 = v0 + e1
    p2 = v0 + e2
    tlo = torch.minimum(torch.minimum(v0, p1), p2)
    thi = torch.maximum(torch.maximum(v0, p1), p2)
    if kind == "box":
        return box_block_bounds(tlo, thi, m_valid, blk, origin, sub)
    m_pad = v0.shape[0]
    nb = m_pad // blk
    valid = (torch.arange(m_pad, device=v0.device) < m_valid).reshape(
        nb, blk, 1)
    blo = tlo.reshape(nb, blk, 3)
    bhi = thi.reshape(nb, blk, 3)
    lo = torch.where(valid, blo, _BIG_BOX).amin(dim=1)
    hi = torch.where(valid, bhi, -_BIG_BOX).amax(dim=1)
    has = valid.any(dim=1)[:, 0]
    ctr = torch.where(has[:, None], 0.5 * (lo + hi), 0.0)
    dlo = (blo - ctr[:, None, :]).abs()
    dhi = (bhi - ctr[:, None, :]).abs()
    dist = _norm3(torch.maximum(dlo, dhi))[..., None]
    rad = torch.where(valid, dist, 0.0).amax(dim=1)[:, 0]
    rad = rad * 1.001 + 1.0e-3
    return _sphere_rows(ctr, rad, has, origin)


def _safe_inv(c: torch.Tensor) -> torch.Tensor:
    """1 / c with |c| clamped to at least 1e-30 and its sign kept (through
    the bit pattern, so -0.0 gives -1e30): an exactly axis-parallel ray
    gets a huge but finite window on that axis."""
    sign = c.view(torch.int32) & -0x80000000
    mag = torch.clamp(c.abs(), min=1.0e-30)
    return 1.0 / (mag.view(torch.int32) | sign).view(torch.float32)


def gate_pre(rays, kind: str = "box"):
    """Per-ray precomputes of the gate (``_gate_pre``), hoisted out of the
    block loop. Box kind: |o|, the safe reciprocals of d, o * (1/d). Sphere
    kind: a = |d|^2, d.o, o.o, T_MIN * a, sqrt(a), |o|."""
    ox, oy, oz, dx, dy, dz = rays
    o_dot_o = ox * ox + oy * oy + oz * oz
    so = _sqrt(o_dot_o)
    if kind == "sphere":
        a = dx * dx + dy * dy + dz * dz
        return (a, dx * ox + dy * oy + dz * oz, o_dot_o, _T_MIN * a,
                _sqrt(a), so)
    iv = (_safe_inv(dx), _safe_inv(dy), _safe_inv(dz))
    oi = (ox * iv[0], oy * iv[1], oz * iv[2])
    return so, iv, oi


def _upper_bound(carry, id_mask: int, hint):
    """``carry | id_mask`` as f32 (the packed key's upper bound on the
    winning key), min'd with the external ``hint`` when there is one."""
    cur_hi = (carry | id_mask).view(torch.float32)
    if hint is not None:
        cur_hi = torch.minimum(cur_hi, hint)
    return cur_hi


def cull_gate_box(pre, bound, a, carry, id_mask: int, *, scaled_key: bool,
                  hint=None):
    """Per-ray pass mask of one block (``_cull_gate_box``'s vote before the
    any-reduction): True where the ray may produce a candidate key inside
    any of the block's margined sub-boxes below its current best.

    ``pre`` is ``gate_pre`` of the rays, ``bound`` the block's 8 * sub
    floats, ``a`` = |d|^2, ``carry`` the int32 packed-key minimum so far
    (its low ``id_mask`` bits are ids, so ``carry | id_mask`` as f32 bounds
    the winning key from above). ``scaled_key``: sphere keys are unscaled
    roots ``a * t``; triangle keys are approximate t (1% compare slack).
    ``hint``: an external per-ray upper bound in the key's units (the
    sphere winner's exact t, for the triangle gate)."""
    so, iv, oi = pre
    cur_hi = _upper_bound(carry, id_mask, hint)
    passed = None
    for k in range(bound.shape[0] // 8):
        box = bound[8 * k:8 * (k + 1)]
        lo, hi, bmag, bval = box[0:3], box[3:6], box[6], box[7]
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
        # Negated reject form: a NaN lane compares false everywhere and
        # passes.
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
        p = ~rej & (bval > 0.5)
        passed = p if passed is None else passed | p
    return passed


def cull_gate_sphere(rays, pre, bound, carry, id_mask: int, *,
                     scaled_key: bool, hint=None):
    """Per-ray pass mask of one block against its bounding sphere (the
    sphere-bound branch of ``_cull_gate``): the block's quadratic in the
    sphere key's unscaled-root units, with the discriminant and root
    widened by ``CULL_DELTA_EPS`` times Cauchy-Schwarz magnitude bounds of
    their uncancelled terms. A NaN discriminant (a miss) rejects.

    ``rays`` are (ox, oy, oz, dx, dy, dz), ``pre`` is ``gate_pre(rays,
    "sphere")``, ``bound`` the block's 4 floats; the other arguments are
    ``cull_gate_box``'s."""
    ox, oy, oz, dx, dy, dz = rays
    a, d_dot_o, o_dot_o, ta, sa, so = pre
    bcx, bcy, bcz, bm2 = bound[0], bound[1], bound[2], bound[3]
    bc_abs = _sqrt(bcx * bcx + bcy * bcy + bcz * bcz)
    bm2_abs = bm2.abs()
    h_b = bcx * dx + bcy * dy + bcz * dz - d_dot_o
    cq_b = bm2 - 2.0 * (bcx * ox + bcy * oy + bcz * oz) + o_dot_o
    hh = h_b * h_b
    acq = a * cq_b
    mh = bc_abs * sa + d_dot_o.abs()
    mc = (bm2_abs + 2.0 * bc_abs * so) + o_dot_o
    delta_b = hh - acq + CULL_DELTA_EPS * (mh * mh + a * mc)
    sq_b = _sqrt(delta_b) + CULL_DELTA_EPS * mh  # NaN on a miss
    near_b = h_b - sq_b
    far_b = h_b + sq_b
    cur_hi = _upper_bound(carry, id_mask, hint)
    if scaled_key:
        return (far_b > ta * 0.999) & (
            near_b <= cur_hi + 1.0e-3 + 1.0e-3 * cur_hi.abs()
        )
    thr = a * cur_hi
    return (far_b > ta * 0.99) & (near_b <= thr + 0.01 * thr.abs() + 1.0e-3)


def cull_gate(kind: str, rays, pre, bound, a, carry, id_mask: int, *,
              scaled_key: bool, hint=None):
    """The per-ray pass mask of one block under bound kind ``kind``
    (``_cull_gate``); ``pre`` is ``gate_pre(rays, kind)``."""
    if kind == "sphere":
        return cull_gate_sphere(rays, pre, bound, carry, id_mask,
                                scaled_key=scaled_key, hint=hint)
    return cull_gate_box(pre, bound, a, carry, id_mask,
                         scaled_key=scaled_key, hint=hint)
