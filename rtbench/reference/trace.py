"""The reference's path tracer: independent paths in plain PyTorch.

Frozen copies (raytracing_tpu_torch at commit a1403821e8fd,
``ops/trace.py`` unless named): the counter-hash RNG (``_mul32``,
``_fmix32``, ``_slot_hash``, ``_uniform01_keyed``, ``_lane_hash``,
``_uniform01_from``, ``_trace_stream``), the tiled slot order
(``_slot_pixels``, ``runtime/tiling.py``), the thin-lens camera ray
(``_camera_rays``), the flat sphere rule (``sphere_stage1`` without
blocks), the triangle key with its bfloat16 reciprocal (``_tri_keys``) and exact
re-test (``_tri_exact``), the bounce (``_bounce``) and the colour pipe
(``core/color.py``) with the frame preview's box
(``runtime/renderer.py::_device_preview``).

The closest-hit rules and the albedo rules are files of their own, named
by the configuration's ``reference`` entry: ``rules/<name>.py`` (a
``winner(t, rays)`` for the spheres, and one for the triangles) and
``albedo/<name>.py`` (an ``albedo(t, row, point, rgb)`` applied to the
sphere winner's albedo, in the order listed).

What it leaves out, because it changes no bit: the per-block cull (a
culled block holds no key below a ray's best), the fetch routes, the
sweep-order bookkeeping. Every sample of a pixel and every caller ray is
traced as its own path; a pixel's samples are summed in sample order
afterwards, as the running sums add them.

``dtype`` is the precision of the path arithmetic: float32 is the
reference; bfloat16 is the control (the same paths with every float
operation of the camera, the sweeps and the shading in bfloat16; the
sums over samples and the colour pipe stay float32).
"""

from __future__ import annotations

import dataclasses
import pathlib
import struct

import torch

from rtbench import plugins

from .scene import SphereTable, TriangleTable

ROOT = pathlib.Path(__file__).resolve().parent

T_MIN = 1.0e-4
BIGF = 3.0e38
SELF_HIT_OFFSET = 1.0e-3
TWO_PI = 6.2831853071795864
WIN = 128
GOLD = 0x9E3779B9
SLOT_MUL = 0x9E3779B1
K_SAMPLE = 0x85EBCA77
K_BOUNCE = 0xC2B2AE3D
K_DRAW = 0x632BE5AB
M32 = 0xFFFFFFFF
BIGF_BITS = struct.unpack("<i", struct.pack("<f", BIGF))[0]
TILE = 32
# (ray, row) pairs evaluated at once.
PAIRS = 1 << 23


# -- RNG (uint32 arithmetic in int64 tensors) -------------------------------


def mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & M32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _seed_hash(seed: int, device) -> torch.Tensor:
    return fmix32(torch.tensor((seed + GOLD) & M32, dtype=torch.int64)
                  ).to(device)


def slot_hash(slot: torch.Tensor, seed: int) -> torch.Tensor:
    return (mul32(slot & M32, SLOT_MUL) + _seed_hash(seed, slot.device)) & M32


def uniform_keyed(slot_h, sample, bounce, j: int) -> torch.Tensor:
    h = (slot_h + mul32(sample & M32, K_SAMPLE) + mul32(bounce & M32, K_BOUNCE)
         + ((j * K_DRAW) & M32)) & M32
    return (fmix32(h) & 0xFFFFFF).to(torch.float32) * (1.0 / (1 << 24))


def lane_hash(lane: torch.Tensor) -> torch.Tensor:
    return mul32(lane & M32, SLOT_MUL)


def uniform_from(lane_h, stream_key, j: int) -> torch.Tensor:
    h = fmix32((lane_h + stream_key + ((j * K_DRAW) & M32)) & M32)
    return (h & 0xFFFFFF).to(torch.float32) * (1.0 / (1 << 24))


def trace_stream(tile: torch.Tensor, bounce: int, seed: int) -> torch.Tensor:
    return fmix32((mul32(tile & M32, GOLD) + bounce
                   + _seed_hash(seed, tile.device)) & M32)


# -- slots and pixels -------------------------------------------------------


def tiles_per_row(width: int) -> int:
    return -(-width // TILE)


def num_slots(width: int, height: int) -> int:
    return tiles_per_row(width) * (-(-height // TILE)) * TILE * TILE


def slot_of_pixel(px: torch.Tensor, py: torch.Tensor, width: int):
    tile = (py // TILE) * tiles_per_row(width) + px // TILE
    return tile * (TILE * TILE) + (py % TILE) * TILE + px % TILE


def pixel_of_slot(slot: torch.Tensor, width: int):
    tpr = tiles_per_row(width)
    tile, within = slot >> 10, slot & 1023
    ty = tile // tpr
    return (tile - ty * tpr) * TILE + (within & 31), ty * TILE + (within >> 5)


# -- colour ---------------------------------------------------------------


def to_u8(linear: torch.Tensor) -> torch.Tensor:
    g = torch.where(linear > 0.0, torch.sqrt(torch.clamp(linear, min=0.0)),
                    torch.zeros_like(linear))
    return (torch.clamp(g, 0.0, 0.999) * 256.0).to(torch.uint8)


# -- the scene on a device, in the working precision ------------------------


@dataclasses.dataclass
class Tables:
    """The tables in the working precision, with the rules (modules) that
    the configuration names and the configuration itself, from which a
    rule may work out more of the scene (a texture, say)."""

    sph: SphereTable
    tri: TriangleTable | None
    dtype: torch.dtype
    device: torch.device
    sphere_rule: object
    triangle_rule: object
    albedo_rules: tuple
    config: dict


def on_device(sph: SphereTable, tri: TriangleTable | None, device,
              dtype, config: dict) -> Tables:
    """The tables on ``device`` in ``dtype``, with the rules that the
    configuration's ``reference`` entry names (``spheres``, ``triangles``,
    ``albedo``: file names under ``rules/`` and ``albedo/``)."""
    names = config["reference"]
    def mv(x):
        if isinstance(x, list):
            return [mv(v) for v in x]
        if x.is_floating_point():
            return x.to(device=device, dtype=dtype)
        return x.to(device)

    s = SphereTable(*(mv(getattr(sph, f.name)) if f.name != "n_actual"
                      else sph.n_actual for f in dataclasses.fields(sph)))
    t = None
    if tri is not None:
        t = TriangleTable(mv(tri.cols), mv(tri.albedo), mv(tri.param),
                          tri.m_actual)
    rule = names.get("triangles")
    if (rule is None) != (t is None):
        raise ValueError("a triangle rule is named exactly where there are "
                         "triangles")
    return Tables(
        s, t, dtype, torch.device(device),
        plugins.load(ROOT, "rules", names["spheres"]),
        None if rule is None else plugins.load(ROOT, "rules", rule),
        tuple(plugins.load(ROOT, "albedo", a) for a in names["albedo"]),
        config)


def _bits(key: torch.Tensor) -> torch.Tensor:
    return key.to(torch.float32).view(torch.int32)


def _pack_bits(n: int) -> int:
    return max((n - 1).bit_length(), 1)


# -- camera rays ----------------------------------------------------------


def camera_rays(cam, pxf, pyf, j1, j2, u3, u4):
    """Thin-lens ray of the 20-float camera vector ``cam`` (a list of
    0-d tensors in the working precision)."""
    dr = torch.sqrt(u3)
    dth = TWO_PI * u4
    if float(cam[18]) > 0.0:
        lens_u = dr * torch.cos(dth)
        lens_v = dr * torch.sin(dth)
    else:
        lens_u = torch.zeros_like(dr)
        lens_v = torch.zeros_like(dr)
    fx = pxf + j1 - 0.5
    fy = pyf + j2 - 0.5
    ox = cam[9] + lens_u * cam[12] + lens_v * cam[15]
    oy = cam[10] + lens_u * cam[13] + lens_v * cam[16]
    oz = cam[11] + lens_u * cam[14] + lens_v * cam[17]
    dx = cam[0] + fx * cam[3] + fy * cam[6] - ox
    dy = cam[1] + fx * cam[4] + fy * cam[7] - oy
    dz = cam[2] + fx * cam[5] + fy * cam[8] - oz
    return ox, oy, oz, dx, dy, dz


# -- closest hits ---------------------------------------------------------


def _sphere_key(c, ray):
    cx, cy, cz, m2cx, m2cy, m2cz, cm2 = c
    ox, oy, oz, dx, dy, dz, a, ddo, odo, ta = ray
    h = cx * dx + cy * dy + cz * dz - ddo
    cq = cm2 + m2cx * ox + m2cy * oy + m2cz * oz + odo
    delta = h * h - a * cq
    sq = torch.sqrt(delta)
    n1 = h - sq
    n2 = h + sq
    nroot = torch.where(n1 > ta, n1, n2)
    return torch.where(nroot > ta, nroot, torch.full_like(nroot, BIGF))


def _tri_keys(c, ox, oy, oz, dx, dy, dz):
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = c
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    det = e1x * hx + e1y * hy + e1z * hz
    one = torch.ones_like(det)
    g_s = torch.where(det < 0.0, -one, one)
    dabs = det * g_s
    sx = ox - v0x
    sy = oy - v0y
    sz = oz - v0z
    u_s = (sx * hx + sy * hy + sz * hz) * g_s
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v_s = (dx * qx + dy * qy + dz * qz) * g_s
    t_s = (e2x * qx + e2y * qy + e2z * qz) * g_s
    # 1 / bf16(x): the key's reciprocal, in either working precision.
    rcp = 1.0 / torch.clamp(dabs, min=1e-30).to(torch.bfloat16).to(dabs.dtype)
    t_apx = t_s * rcp
    valid = ((dabs > 1e-12) & (u_s >= 0.0) & (v_s >= 0.0) & (u_s + v_s <= dabs)
             & (t_apx > T_MIN) & (t_apx < BIGF))
    return torch.where(valid, t_apx, torch.full_like(t_apx, BIGF))


def _tri_exact(t: Tables, row, hitk, rays):
    ox, oy, oz, dx, dy, dz = rays
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (c[row] for c in t.tri.cols)
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    det = e1x * hx + e1y * hy + e1z * hz
    ok_det = det.abs() > 1e-12
    inv = 1.0 / torch.where(ok_det, det, torch.ones_like(det))
    sx = ox - v0x
    sy = oy - v0y
    sz = oz - v0z
    u = (sx * hx + sy * hy + sz * hz) * inv
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    tt = (e2x * qx + e2y * qy + e2z * qz) * inv
    hit = (hitk & ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (tt > T_MIN))
    t_safe = torch.where(hit, tt, torch.zeros_like(tt))
    p = (ox + t_safe * dx, oy + t_safe * dy, oz + t_safe * dz)
    gx = e1y * e2z - e1z * e2y
    gy = e1z * e2x - e1x * e2z
    gz = e1x * e2y - e1y * e2x
    inv_g = torch.rsqrt(torch.clamp(gx * gx + gy * gy + gz * gz, min=1e-30))
    alb = tuple(c[row] for c in t.tri.albedo)
    return hit, t_safe, p, (gx * inv_g, gy * inv_g, gz * inv_g), alb, \
        t.tri.param[row]


# -- one bounce -----------------------------------------------------------


def bounce(t: Tables, rays, uniforms):
    """Closest hit, shading and scatter of a batch of rays; the port's
    ``_bounce`` on its default route."""
    ox, oy, oz, dx, dy, dz = rays
    u1, u2, u3 = uniforms
    s = t.sph
    a = dx * dx + dy * dy + dz * dz
    d_dot_o = dx * ox + dy * oy + dz * oz
    hitm, row = t.sphere_rule.winner(t, rays)
    cxb, cyb, czb, rb = s.cx[row], s.cy[row], s.cz[row], s.r[row]
    albr, albg, albb = (c[row] for c in s.albedo)
    param = s.param[row]

    hq = cxb * dx + cyb * dy + czb * dz - d_dot_o
    ocx = ox - cxb
    ocy = oy - cyb
    ocz = oz - czb
    cqw = ocx * ocx + ocy * ocy + ocz * ocz - rb * rb
    deltaw = torch.clamp(hq * hq - a * cqw, min=0.0)
    sqw = torch.sqrt(deltaw)
    inv_a = torch.reciprocal(a)
    t1 = (hq - sqw) * inv_a
    t2 = (hq + sqw) * inv_a
    tt = torch.where(t1 > T_MIN, t1, t2)
    zero = torch.zeros_like(tt)
    one = torch.ones_like(tt)
    t_safe = torch.where(hitm, tt, zero)
    invrb = torch.where(rb > 0.0, torch.reciprocal(torch.clamp(rb, min=1e-30)),
                        zero)
    px = ox + t_safe * dx
    py = oy + t_safe * dy
    pz = oz + t_safe * dz
    onx = (px - cxb) * invrb
    ony = (py - cyb) * invrb
    onz = (pz - czb) * invrb

    for rule in t.albedo_rules:
        albr, albg, albb = rule.albedo(t, row, (px, py, pz), (albr, albg, albb))
    if t.tri is not None:
        t_sph = torch.where(hitm, t_safe, torch.full_like(t_safe, BIGF))
        hitk, trow = t.triangle_rule.winner(t, rays)
        hit_t, t_t, tp, tn, ta, tparam = _tri_exact(t, trow, hitk, rays)
        pick = hit_t & (~hitm | (t_t < t_sph))
        hitm = hitm | hit_t
        px, py, pz = (torch.where(pick, x, y) for x, y in zip(tp, (px, py, pz)))
        onx, ony, onz = (torch.where(pick, x, y)
                         for x, y in zip(tn, (onx, ony, onz)))
        albr, albg, albb = (torch.where(pick, x, y)
                            for x, y in zip(ta, (albr, albg, albb)))
        param = torch.where(pick, tparam, param)

    d_dot_n = dx * onx + dy * ony + dz * onz
    front = d_dot_n < 0.0
    sgn = torch.where(front, one, -one)
    nx = onx * sgn
    ny = ony * sgn
    nz = onz * sgn

    inv_len_d = torch.rsqrt(a)
    sky_t = 0.5 * (dy * inv_len_d + 1.0)
    sky_r = 1.0 - sky_t + sky_t * 0.5
    sky_g = 1.0 - sky_t + sky_t * 0.7

    uz = 2.0 * u1 - 1.0
    us = torch.sqrt(torch.clamp(1.0 - uz * uz, min=0.0))
    theta = TWO_PI * u2
    ux = us * torch.cos(theta)
    uy = us * torch.sin(theta)

    ldx = nx + ux
    ldy = ny + uy
    ldz = nz + uz
    tiny = (ldx.abs() < 1e-8) & (ldy.abs() < 1e-8) & (ldz.abs() < 1e-8)
    ldx = torch.where(tiny, nx, ldx)
    ldy = torch.where(tiny, ny, ldy)
    ldz = torch.where(tiny, nz, ldz)

    two_ddn = 2.0 * d_dot_n * sgn
    rfx = dx - two_ddn * nx
    rfy = dy - two_ddn * ny
    rfz = dz - two_ddn * nz
    inv_rf = torch.rsqrt(torch.clamp(rfx * rfx + rfy * rfy + rfz * rfz,
                                     min=1e-20))
    mdx = rfx * inv_rf + param * ux
    mdy = rfy * inv_rf + param * uy
    mdz = rfz * inv_rf + param * uz
    met_ok = (mdx * nx + mdy * ny + mdz * nz) > 0.0

    iorb = param - 4.0
    eta = torch.where(front, torch.reciprocal(iorb), iorb)
    udx = dx * inv_len_d
    udy = dy * inv_len_d
    udz = dz * inv_len_d
    cos_t = torch.clamp(-(udx * nx + udy * ny + udz * nz), max=1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    cannot = (eta * sin_t) > 1.0
    r0 = (1.0 - eta) / (1.0 + eta)
    r0 = r0 * r0
    omc = 1.0 - cos_t
    omc2 = omc * omc
    schlick = r0 + (1.0 - r0) * omc2 * omc2 * omc
    choose_reflect = cannot | (schlick > u3)
    two_udn = 2.0 * (udx * nx + udy * ny + udz * nz)
    rdx = udx - two_udn * nx
    rdy = udy - two_udn * ny
    rdz = udz - two_udn * nz
    ppx = eta * (udx + cos_t * nx)
    ppy = eta * (udy + cos_t * ny)
    ppz = eta * (udz + cos_t * nz)
    k = 1.0 - (ppx * ppx + ppy * ppy + ppz * ppz)
    par = -torch.sqrt(k.abs())
    tdx = ppx + par * nx
    tdy = ppy + par * ny
    tdz = ppz + par * nz
    ddx = torch.where(choose_reflect, rdx, tdx)
    ddy = torch.where(choose_reflect, rdy, tdy)
    ddz = torch.where(choose_reflect, rdz, tdz)

    is_lam = param < -0.5
    is_diel = param > 2.5
    is_met = ~is_lam & ~is_diel
    ndx = torch.where(is_lam, ldx, torch.where(is_diel, ddx, mdx))
    ndy = torch.where(is_lam, ldy, torch.where(is_diel, ddy, mdy))
    ndz = torch.where(is_lam, ldz, torch.where(is_diel, ddz, mdz))
    scat_ok = hitm & ~(is_met & ~met_ok)
    atten = tuple(torch.where(is_diel, one, c) for c in (albr, albg, albb))
    side = torch.where((ndx * nx + ndy * ny + ndz * nz) >= 0.0, one, -one)
    eps = SELF_HIT_OFFSET * side
    return dict(hitm=hitm, scat_ok=scat_ok,
                new=(px + eps * nx, py + eps * ny, pz + eps * nz,
                     ndx, ndy, ndz),
                atten=atten, sky=(sky_r, sky_g, one))


# -- paths ------------------------------------------------------------------


def _trace(t: Tables, rays, draws, max_depth: int):
    """Trace a batch of paths to at most ``max_depth`` segments.
    ``draws(idx, bounce)`` gives the three uniforms (float32) of the paths
    ``idx`` at a bounce. Returns each path's radiance (float32 [B, 3]:
    throughput x sky where it misses) and its segment count (int64 [B])."""
    dt = t.dtype
    n = rays[0].shape[0]
    dev = t.device
    ray = [r.to(dt).clone() for r in rays]
    tp = [torch.ones(n, dtype=dt, device=dev) for _ in range(3)]
    rad = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    seg = torch.zeros(n, dtype=torch.int64, device=dev)
    idx = torch.arange(n, device=dev)
    for b in range(max_depth):
        if idx.numel() == 0:
            break
        r = tuple(c[idx] for c in ray)
        out = bounce(t, r, tuple(u.to(dt) for u in draws(idx, b)))
        seg[idx] += 1
        miss = ~out["hitm"]
        tt = [c[idx] for c in tp]
        contrib = torch.stack([(tt[c] * out["sky"][c]).to(torch.float32)
                               for c in range(3)], dim=1)
        rad[idx] = torch.where(miss[:, None], contrib, rad[idx])
        survives = out["scat_ok"] & (b + 1 < max_depth)
        for c in range(6):
            ray[c][idx] = out["new"][c]
        for c in range(3):
            tp[c][idx] = tt[c] * out["atten"][c]
        idx = idx[survives]
    return rad, seg


def camera_paths(t: Tables, cam: torch.Tensor, width: int, seed: int,
                 slots: torch.Tensor, samples: torch.Tensor, max_depth: int):
    """The regen entry's paths: sample ``samples[i]`` of pixel slot
    ``slots[i]`` (int64 tensors) under ``seed``. Returns (radiance
    float32 [B, 3], segments int64 [B])."""
    dev = t.device
    slots = slots.to(dev)
    samples = samples.to(dev)
    cam_v = [c.to(t.dtype) for c in cam.to(dev).unbind()]
    sh = slot_hash(slots, seed)
    pxi, pyi = pixel_of_slot(slots, width)
    u = [uniform_keyed(sh, samples, torch.zeros_like(samples), j).to(t.dtype)
         for j in (3, 4, 5, 6)]
    rays = camera_rays(cam_v, pxi.to(t.dtype), pyi.to(t.dtype), *u)

    def draws(idx, b):
        bb = torch.full_like(idx, b)
        return [uniform_keyed(sh[idx], samples[idx], bb, j) for j in (0, 1, 2)]

    return _trace(t, rays, draws, max_depth)


def caller_paths(t: Tables, origins, directions, index, seed: int,
                 tile_offset: int, tile_rays: int, max_depth: int):
    """The trace entry's paths: ray ``index[i]`` of a batch (its lane
    within its tile and its absolute tile) from ``origins[i]``,
    ``directions[i]``. Returns (radiance float32 [B, 3], segments int64
    [B])."""
    dev = t.device
    index = index.to(dev)
    lane_h = lane_hash(index % tile_rays)
    tile = tile_offset + index // tile_rays
    rays = [origins[:, k].to(dev) for k in range(3)]
    rays += [directions[:, k].to(dev) for k in range(3)]

    def draws(idx, b):
        s = trace_stream(tile[idx], b, seed)
        return [uniform_from(lane_h[idx], s, j) for j in (0, 1, 2)]

    return _trace(t, [r.to(t.dtype) for r in rays], draws, max_depth)


def pixel_sums(rad: torch.Tensor, spp: int) -> torch.Tensor:
    """Per-pixel running sums of [P * spp, 3] path radiances ordered
    pixel-major, sample-minor, added in sample order as the kernel adds
    them (float32 [P, 3])."""
    per = rad.view(-1, spp, 3)
    acc = torch.zeros_like(per[:, 0])
    for k in range(spp):
        acc = acc + per[:, k]
    return acc
