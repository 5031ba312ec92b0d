"""The segment-split probe: what one segment of the cover scene's
regeneration loop costs, and how the cost splits between its pieces.

Counterpart of the JAX package's probe kernel
(``scripts/probe_segment_split.py``: ``make_kernel``, ``run_variant``). A
lane traces a fixed number of steps with no exit: each step draws three
uniforms, sweeps the flat sphere table, fetches the winner's words, takes
the exact root, shades branchlessly (with the probe's sky and its eta) and
regenerates a camera ray where the path died. Variants take a piece out:

* ``"full"``: all of it, the winner fetched by an indexed load;
* ``"nogather"``: the winner's columns made from its row id (no fetch);
* ``"nosweep"`` and ``"base"``: the key made from dy's bits as well (no
  sweep; the two are the same code, as in the JAX probe);
* ``"full_radix"``: ``"full"`` with the fetch of the JAX package's
  ``RT_GATHER=radix`` route (``ops/fetch.py``'s tournament), the same words
  and so the same bits as ``"full"``.

A slot is a lane's index within its tile of 1,024 lanes (pixel x = slot %
400, y = slot // 400), the RNG and camera keyed as the JAX probe keys them.
Every tile traces the same 1,024 slots.

* ``segment_split_reference`` is the plain PyTorch version;
* ``segment_split`` launches ``csrc/segment_split.cu`` on CUDA tensors (or
  raises) and runs the plain version on CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import cull as rcull
from . import fetch as rfetch
from . import trace as rtrace

VARIANTS = ("full", "nogather", "nosweep", "base", "full_radix")
TILE_SLOTS = 1024
GRID_COLS = 400
# Rows of the staged table (regen_core.cuh kStageRows).
MAX_ROWS = 1024


def _check(tables: rtrace.SceneTables, slots: int, steps: int,
           variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown segment-split variant {variant!r}")
    if tables.textured or tables.tri is not None:
        raise ValueError("the segment-split probe takes an untextured "
                         "sphere-only scene")
    if tables.sphere_rule != "flat" or tables.n_pad > MAX_ROWS:
        raise ValueError(f"the segment-split probe sweeps a flat table of at "
                         f"most {MAX_ROWS} rows, got {tables.n_pad} "
                         f"({tables.sphere_rule})")
    if slots <= 0 or slots % TILE_SLOTS:
        raise ValueError(f"slots {slots} must be a positive multiple of "
                         f"{TILE_SLOTS}")
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")


def segment_split_reference(tables: rtrace.SceneTables, cam, *, seed: int,
                            steps: int, slots: int, variant: str):
    """Plain PyTorch version of the probe on ``tables`` (flat rule, at most
    1,024 rows, untextured) with the camera ``cam`` (a ``DerivedCamera`` or
    its 20-float vector) and the RNG seed ``seed``, for ``steps`` steps over
    ``slots`` lanes. Returns ``(rad f32[3, slots], hits i32[slots])``:
    ``rad`` holds rr, rg and rb + ox + dx; ``hits`` the steps whose key was
    a hit. One tile's 1,024 slots are traced and repeated over the
    tiles."""
    _check(tables, slots, steps, variant)
    dev = tables.device
    cam = rtrace._camera_vector(cam).to(dev)
    use_disk = bool(cam[18] > 0.0)
    f32 = torch.float32
    slot = torch.arange(min(slots, TILE_SLOTS), dtype=torch.int64, device=dev)
    pxf = (slot % GRID_COLS).to(f32)
    pyf = (slot // GRID_COLS).to(f32)
    slot_h = rtrace._slot_hash(slot, seed)
    zero = torch.zeros_like(slot)

    def draws(sample, bounce):
        return [rtrace._uniform01_keyed(slot_h, sample, bounce, j)
                for j in (0, 1, 2)]

    u0 = draws(zero, zero)
    ox, oy, oz, dx, dy, dz = rtrace._camera_rays(
        cam, use_disk, pxf, pyf, u0[0], u0[1], u0[2], u0[2])
    one = torch.ones_like(pxf)
    tpr, tpg, tpb = one, one, one
    rr = rg = rb = torch.zeros_like(pxf)
    hits = torch.zeros(slot.shape, dtype=torch.int32, device=dev)
    pack_mask = (1 << rtrace._pack_bits(tables.n_pad)) - 1
    nohit = rtrace._BIGF_BITS & ~pack_mask
    words = tables.shade.view(torch.int32)[:, :6]
    for it in range(steps):
        depth = zero + it
        u1, u2, u3 = draws(depth, depth)
        a = dx * dx + dy * dy + dz * dz
        d_dot_o = dx * ox + dy * oy + dz * oz
        if variant in ("nosweep", "base"):
            kmin = dy.view(torch.int32)
        else:
            kmin, _ = rtrace.sphere_stage1(tables, (ox, oy, oz, dx, dy, dz))
        hitm = kmin < nohit
        imin = kmin & pack_mask
        hits += hitm.to(torch.int32)
        if variant in ("full", "full_radix"):
            mode = "radix" if variant == "full_radix" else "index"
            w = rfetch.fetch_rows_reference(words, imin.long(), mode)
            wf = w.view(f32)
            cxb, cyb, czb, rb_ = wf[:, 0], wf[:, 1], wf[:, 2], wf[:, 3]
            albr, albg, albb, param = rtrace._mat_decode(w[:, 4], w[:, 5])
        else:
            f = imin.to(f32)
            cxb = f * 0.01
            cyb = f * -0.02
            czb = f * 0.005
            rb_ = f * 1e-4 + 0.2
            albr = f * 1e-5 + 0.3
            albg = albr
            albb = albr
            param = f * 1e-6 - 0.9

        # Exact winner root and the branchless shade (the probe's ops).
        hq = cxb * dx + cyb * dy + czb * dz - d_dot_o
        ocx = ox - cxb
        ocy = oy - cyb
        ocz = oz - czb
        cqw = ocx * ocx + ocy * ocy + ocz * ocz - rb_ * rb_
        deltaw = torch.clamp(hq * hq - a * cqw, min=0.0)
        sqw = rcull._sqrt(deltaw)
        inv_a = 1.0 / a
        t1 = (hq - sqw) * inv_a
        t2 = (hq + sqw) * inv_a
        t = torch.where(t1 > rtrace._T_MIN, t1, t2)
        t_safe = torch.where(hitm, t, 0.0)
        invrb = torch.where(rb_ > 0.0, 1.0 / torch.clamp(rb_, min=1e-30), 0.0)
        px = ox + t_safe * dx
        py = oy + t_safe * dy
        pz = oz + t_safe * dz
        onx = (px - cxb) * invrb
        ony = (py - cyb) * invrb
        onz = (pz - czb) * invrb
        d_dot_n = dx * onx + dy * ony + dz * onz
        front = d_dot_n < 0.0
        sgn = torch.where(front, 1.0, -1.0)
        nx = onx * sgn
        ny = ony * sgn
        nz = onz * sgn
        inv_len_d = torch.rsqrt(a)
        sky_t = 0.5 * (dy * inv_len_d + 1.0)
        sky_r = 1.0 - sky_t + sky_t * 0.5
        sky_g = 1.0 - sky_t + sky_t * 0.7
        uz = 2.0 * u1 - 1.0
        us = rcull._sqrt(torch.clamp(1.0 - uz * uz, min=0.0))
        theta = rtrace._TWO_PI * u2
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
        inv_rf = torch.rsqrt(
            torch.clamp(rfx * rfx + rfy * rfy + rfz * rfz, min=1e-20))
        mdx = rfx * inv_rf + param * ux
        mdy = rfy * inv_rf + param * uy
        mdz = rfz * inv_rf + param * uz
        met_ok = (mdx * nx + mdy * ny + mdz * nz) > 0.0
        iorb = param - 4.0
        eta = torch.where(front, 1.0 / torch.clamp(iorb, min=1e-3), iorb)
        udx = dx * inv_len_d
        udy = dy * inv_len_d
        udz = dz * inv_len_d
        cos_t = torch.clamp(-(udx * nx + udy * ny + udz * nz), max=1.0)
        sin_t = rcull._sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
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
        par = -rcull._sqrt(k.abs())
        tdx = ppx + par * nx
        tdy = ppy + par * ny
        tdz = ppz + par * nz
        ddx = torch.where(choose_reflect, rdx, tdx)
        ddy = torch.where(choose_reflect, rdy, tdy)
        ddz = torch.where(choose_reflect, rdz, tdz)
        is_lam = param < -0.5
        is_diel = param > 2.5
        ndx = torch.where(is_lam, ldx, torch.where(is_diel, ddx, mdx))
        ndy = torch.where(is_lam, ldy, torch.where(is_diel, ddy, mdy))
        ndz = torch.where(is_lam, ldz, torch.where(is_diel, ddz, mdz))
        atr = torch.where(is_diel, 1.0, albr)
        atg = torch.where(is_diel, 1.0, albg)
        atb = torch.where(is_diel, 1.0, albb)
        scat_ok = hitm & ~(~is_lam & ~is_diel & ~met_ok)

        missf = torch.where(hitm, 0.0, 1.0)
        rr = rr + missf * tpr * sky_r
        rg = rg + missf * tpg * sky_g
        rb = rb + missf * tpb * 1.0

        # Camera regeneration for dead lanes, every step.
        j1, j2, c3 = draws(depth + 1, zero)
        cx, cy, cz, cdx, cdy, cdz = rtrace._camera_rays(
            cam, use_disk, pxf, pyf, j1, j2, c3, j1)
        side = torch.where((ndx * nx + ndy * ny + ndz * nz) >= 0.0, 1.0, -1.0)
        eps = rtrace._SELF_HIT_OFFSET * side
        ox = torch.where(scat_ok, px + eps * nx, cx)
        oy = torch.where(scat_ok, py + eps * ny, cy)
        oz = torch.where(scat_ok, pz + eps * nz, cz)
        dx = torch.where(scat_ok, ndx, cdx)
        dy = torch.where(scat_ok, ndy, cdy)
        dz = torch.where(scat_ok, ndz, cdz)
        tpr = torch.where(scat_ok, tpr * atr, 1.0)
        tpg = torch.where(scat_ok, tpg * atg, 1.0)
        tpb = torch.where(scat_ok, tpb * atb, 1.0)
    rad = torch.stack([rr, rg, rb + ox + dx])
    reps = slots // slot.numel()
    return rad.repeat(1, reps), hits.repeat(reps)


def segment_split(tables: rtrace.SceneTables, cam, *, seed: int, steps: int,
                  slots: int, variant: str,
                  clocks: torch.Tensor | None = None):
    """The probe (``segment_split_reference``'s arguments and results):
    CUDA tables launch ``csrc/segment_split.cu`` (or raise), CPU tables run
    the plain version. On CUDA, ``clocks`` (int64 [slots / 32, 3], given by
    the caller) receives each warp's ``clock64()`` before and after the
    loop and its SM id."""
    _check(tables, slots, steps, variant)
    dev = tables.device
    if dev.type == "cuda":
        return _launch_cuda(tables, cam, seed, steps, slots, variant, clocks)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    if clocks is not None:
        raise ValueError("clocks are the kernel's: CUDA tables only")
    return segment_split_reference(tables, cam, seed=seed, steps=steps,
                                   slots=slots, variant=variant)


def _launch_cuda(tables, cam, seed, steps, slots, variant, clocks):
    from . import _build

    dev = tables.device
    rtrace._check_tables(tables, dev)
    if clocks is None:
        clocks = torch.empty((slots // 32, 3), dtype=torch.int64, device=dev)
    if (clocks.device != dev or clocks.dtype != torch.int64
            or tuple(clocks.shape) != (slots // 32, 3)
            or not clocks.is_contiguous()):
        raise ValueError(f"clocks must be a contiguous int64 "
                         f"[{slots // 32}, 3] tensor on {dev}")
    rad = torch.empty((3, slots), dtype=torch.float32, device=dev)
    hits = torch.empty((slots,), dtype=torch.int32, device=dev)
    cam_host = (ctypes.c_float * 20)(*rtrace._camera_vector(cam).tolist())
    _build.launch(
        "segment_split", "rt_segment_split_launch", dev,
        tables.geom_h.data_ptr(), tables.geom_c.data_ptr(),
        tables.shade.data_ptr(), tables.n_pad, cam_host,
        seed & 0xFFFFFFFF, steps, slots, VARIANTS.index(variant),
        rad.data_ptr(), hits.data_ptr(), clocks.data_ptr(),
        count=f"segment_{variant}",
    )
    return rad, hits
