"""Shared fixtures of the ``test_torch_*`` files: scenes built once in the
JAX package and carried into the port through ``interop``, and the JAX side
of a regeneration wave run as the JAX package's own tests run it on the CPU
(TPU-interpret mode)."""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
import os
import struct
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import torch
from jax.experimental.pallas import tpu as pltpu

import raytracing_tpu as rt
from raytracing_tpu.ops.pallas import trace as ptrace
from raytracing_tpu.scene.types import SceneBuilder
from raytracing_tpu_torch import interop
from raytracing_tpu_torch.ops import trace as ttrace
from raytracing_tpu_torch.runtime import tiling

_TESTS = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_TESTS)
COVER = "data/config/world.config.json"
# Radiance tolerance of the JAX package's own kernel-vs-XLA parity test
# (tests/test_pallas.py): f32 transcendentals and XLA-CPU's fused
# multiply-adds round differently from torch's CPU kernels.
ATOL, RTOL = 2e-4, 1e-3

_CAMERA_VECTORS = (
    "pixel00", "pixel_delta_u", "pixel_delta_v", "center",
    "defocus_disk_u", "defocus_disk_v", "defocus_angle",
)


def scene_arrays(scene) -> dict:
    return {
        f.name: np.asarray(getattr(scene, f.name))
        for f in dataclasses.fields(scene)
        if f.name not in ("has_textures", "has_triangles")
    }


def to_port(jscene, jcam=None):
    """JAX Scene (and DerivedCamera) -> the port's objects via interop."""
    ts = interop.scene_from_numpy(
        scene_arrays(jscene), has_textures=jscene.has_textures,
        has_triangles=jscene.has_triangles,
    )
    if jcam is None:
        return ts
    cam = interop.camera_from_numpy(
        {n: np.asarray(getattr(jcam, n)) for n in _CAMERA_VECTORS},
        image_width=jcam.image_width, image_height=jcam.image_height,
    )
    return ts, cam


def metal_scene_jax():
    """All-metal fuzz-0 scene of tests/test_pallas.py: no RNG on any path."""
    b = SceneBuilder()
    b.add_metallic_sphere((0.0, -100.5, -1.0), 100.0, (0.5, 0.5, 0.5), 0.0)
    b.add_metallic_sphere((0.0, 0.0, -1.0), 0.5, (0.8, 0.6, 0.2), 0.0)
    b.add_metallic_sphere((1.2, 0.0, -1.5), 0.7, (0.9, 0.9, 0.9), 0.0)
    return b.build()


def golden_scene_jax():
    """The golden scene of tests/test_golden.py."""
    b = SceneBuilder()
    b.add_metallic_sphere((0.0, -100.5, -1.0), 100.0, (0.5, 0.5, 0.5), 0.0)
    b.add_lambertian_sphere((0.0, 0.0, -1.2), 0.5, (0.7, 0.3, 0.3))
    b.add_metallic_sphere((1.1, 0.0, -1.4), 0.5, (0.9, 0.9, 0.9), 0.0)
    b.add_dielectric_sphere((-1.1, 0.0, -1.2), 0.5, 1.5)
    return b.build()


def full_materials_scene_jax():
    """tests/test_pallas.py's full-materials scene: lambertian ground and
    sphere, a fuzz-0.2 metal and a glass sphere."""
    b = SceneBuilder()
    b.add_lambertian_sphere((0.0, -100.5, -1.0), 100.0, (0.5, 0.5, 0.5))
    b.add_lambertian_sphere((0.0, 0.0, -1.0), 0.5, (0.7, 0.3, 0.3))
    b.add_metallic_sphere((1.0, 0.0, -1.0), 0.5, (0.8, 0.8, 0.8), 0.2)
    b.add_dielectric_sphere((-1.0, 0.0, -1.0), 0.5, 1.5)
    return b.build()


def golden_textured_scene_jax():
    """The textured golden scene of tests/test_golden.py."""
    from test_golden import _textured_scene

    return _textured_scene()


def golden_mesh_scene_jax():
    """The mesh golden scene of tests/test_golden.py (80 triangles)."""
    from test_golden import _mesh_scene

    return _mesh_scene()


def near_tie_scene_jax():
    """(params, scene): 40 pairs of concentric fuzz-0 metal spheres in front
    of the camera, each a red sphere of radius 0.5 around a blue one 0.1%
    smaller, inserted first so that it keeps the lower row id after the
    stable Morton sort; 4,100 small spheres far overhead pad the table to
    8,192 rows. Along the primary rays the two near roots differ by about
    1e-4 relative: the flat rule's 13 id bits (2^-10) cannot tell them
    apart and take the inner sphere by its lower id; the two-level rule's
    6 + 7 bits (about 2^-16) take the nearer, outer one."""
    b = SceneBuilder()
    for i in range(8):
        for j in range(5):
            c = ((i - 3.5) * 1.3, (j - 2.0) * 1.3, -6.0)
            b.add_metallic_sphere(c, 0.5 * (1.0 - 1.0e-3), (0.2, 0.3, 0.9), 0.0)
            b.add_metallic_sphere(c, 0.5, (0.9, 0.3, 0.2), 0.0)
    rng = np.random.default_rng(2)
    for p in rng.uniform(-150.0, 150.0, size=(4100, 3)):
        b.add_lambertian_sphere((p[0], p[1] + 400.0, p[2]), 0.05,
                                (0.5, 0.5, 0.5))
    params = golden_params(
        aspect_ratio=2.0, image_width=64, max_depth=4, vertical_fov=70.0,
        lookfrom=(0.0, 0.0, 0.0), lookat=(0.0, 0.0, -1.0),
    )
    return params, b.build()


def metal_cloud_scene_jax():
    """(params, scene): the all-metal fuzz-0 scene of 600 spheres
    (tests/test_pallas.py, larger than one sweep window: 1,024 rows) seen
    from its middle: no RNG on any path."""
    rng = np.random.default_rng(12)
    b = SceneBuilder()
    for _ in range(600):
        b.add_metallic_sphere(rng.normal(size=3) * 8, rng.uniform(0.2, 0.6),
                              (0.9, 0.9, 0.9), 0.0)
    params = golden_params(
        aspect_ratio=2.0, image_width=64, max_depth=4, vertical_fov=70.0,
        lookfrom=(0.0, 0.0, 0.0), lookat=(0.0, 0.0, -1.0),
    )
    return params, b.build()


def write_icosphere_glb(path, subdivisions=1, *, metallic=True):
    """A .glb holding one icosphere mesh (u32 indices) under a node with a
    rotation, scale and translation, and a pbr material; the glb layout of
    tests/test_mesh.py's writer."""
    from raytracing_tpu.scene import mesh as jmesh

    verts, faces = jmesh.make_icosphere(subdivisions)
    pos = np.ascontiguousarray(verts, np.float32)
    idx = np.ascontiguousarray(faces.reshape(-1), np.uint32)
    blob = pos.tobytes() + idx.tobytes()
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{
            "mesh": 0, "translation": [0.2, 0.5, -1.0],
            "rotation": [0.0, 0.3826834, 0.0, 0.9238795],
            "scale": [0.6, 0.6, 0.6],
        }],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0}, "indices": 1, "material": 0,
        }]}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorFactor": [0.8, 0.5, 0.3, 1.0],
            "metallicFactor": 1.0 if metallic else 0.0,
            "roughnessFactor": 0.15,
        }}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": len(pos),
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5125, "count": idx.size,
             "type": "SCALAR"},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": pos.nbytes},
            {"buffer": 0, "byteOffset": pos.nbytes, "byteLength": idx.nbytes},
        ],
        "buffers": [{"byteLength": len(blob)}],
    }
    js = json.dumps(doc).encode()
    js += b" " * ((-len(js)) % 4)
    blob += b"\x00" * ((-len(blob)) % 4)
    body = (
        struct.pack("<II", len(js), 0x4E4F534A) + js
        + struct.pack("<II", len(blob), 0x004E4942) + blob
    )
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, 12 + len(body)) + body)
    return path


def golden_params(**kw):
    base = dict(
        aspect_ratio=2.0, image_width=64, samples_per_pixel=1, max_depth=6,
        vertical_fov=55.0, defocus_angle=0.0, focus_distance=1.0,
        lookfrom=(0.0, 0.3, 1.2), lookat=(0.0, 0.0, -1.2),
    )
    base.update(kw)
    return rt.CameraParameters(**base)


def slots_of(jcam, order: str):
    w, h = jcam.image_width, jcam.image_height
    if order == "tiled":
        return tiling.num_slots(w, h), tiling.tiles_per_row(w)
    return -(-w * h // 1024) * 1024, w


def render_jax(jscene, params, *, spp, depth, seed, order="tiled"):
    """One full-budget JAX regeneration wave (interpret mode): (rad, seg)."""
    jcam = rt.derive(params)
    s, mp = slots_of(jcam, order)
    with pltpu.force_tpu_interpret_mode():
        rad, seg = ptrace.render_pixels_fused(
            jscene, jcam.pixel00, jcam.pixel_delta_u, jcam.pixel_delta_v,
            jcam.center, jcam.defocus_disk_u, jcam.defocus_disk_v,
            jcam.defocus_angle, jnp.int32(mp), jnp.int32(0),
            jnp.int32(seed), jnp.int32(0), s, spp, depth, pixel_order=order,
        )
    return np.asarray(rad), int(seg)


def render_port(jscene, params, *, spp, depth, seed, order="tiled"):
    """The same wave through the port on the same tables: (rad, seg, done)."""
    jcam = rt.derive(params)
    s, mp = slots_of(jcam, order)
    ts, cam = to_port(jscene, jcam)
    r2, s2, d2 = ttrace.render_pixels_fused(
        ts, cam, slot_base=0, map_param=mp, seed=seed, sample_start=0,
        spp=spp, max_depth=depth, t_end=spp,
        done=torch.zeros(s, dtype=torch.int32), num_slots=s,
        pixel_order=order,
    )
    return r2.numpy(), int(s2), d2.numpy()


def render_both(jscene, params, *, spp, depth, seed, order="tiled"):
    """One full-budget wave through both packages on the same tables.
    Returns ((rad, seg) JAX, (rad, seg, done) port) as numpy/ints."""
    kw = dict(spp=spp, depth=depth, seed=seed, order=order)
    return render_jax(jscene, params, **kw), render_port(jscene, params, **kw)


# XLA-CPU always lets LLVM contract a multiply and an add into one fused
# multiply-add where the host has FMA; torch's CPU kernels round each op.
# Capping the target ISA at AVX (which has no FMA) takes the contraction
# away, so the JAX side rounds as the port does.
NO_FMA_FLAG = "--xla_cpu_max_isa=AVX"


def wave_jax_without_fma(tmp_path, scene_expr: str, *, width, spp, depth, seed,
                         env=None):
    """``render_jax`` of the scene that the Python expression ``scene_expr``
    builds as (params, scene) with ``rt`` (the JAX package) and ``np`` in
    scope, at ``width``, in a fresh process whose XLA-CPU target has no FMA
    (the flag is read once, when the backend starts) and whose environment
    adds ``env`` (e.g. the JAX package's trace-time knobs). Returns (rad,
    seg)."""
    code = (
        "import dataclasses, raytracing_tpu as rt\n"
        f"p, s = {scene_expr}\n"
        f"p = dataclasses.replace(p, image_width={width})\n"
        f"r, n = h.render_jax(s, p, spp={spp}, depth={depth}, seed={seed})\n"
        "out = {'rad': r, 'seg': np.asarray(n)}"
    )
    data = jax_arrays_without_fma(tmp_path, code, env)
    return data["rad"], int(data["seg"])


def cover_wave_jax_without_fma(tmp_path, *, width, spp, depth, seed):
    """``wave_jax_without_fma`` of the cover scene."""
    return wave_jax_without_fma(
        tmp_path, f"rt.load_and_build({COVER!r})", width=width, spp=spp,
        depth=depth, seed=seed,
    )


def trace_jax(jscene, o, d, *, depth, seed, tile_offset=0, tile_rays=1024):
    """The JAX package's ``trace_rays_fused`` on numpy rays (interpret
    mode): (radiance, segments) as numpy/int."""
    with pltpu.force_tpu_interpret_mode():
        rad, seg = ptrace.trace_rays_fused(
            jscene, jnp.asarray(o), jnp.asarray(d), jnp.int32(seed),
            jnp.int32(tile_offset), depth, tile_rays=tile_rays,
        )
    return np.asarray(rad), int(seg)


def trace_port(jscene, o, d, *, depth, seed, tile_offset=0, tile_rays=1024):
    """The port's ``trace_rays_fused`` on the same scene and numpy rays."""
    rad, seg = ttrace.trace_rays_fused(
        to_port(jscene), torch.from_numpy(o), torch.from_numpy(d), seed,
        tile_offset, depth, tile_rays=tile_rays,
    )
    return rad.numpy(), int(seg)


def trace_jax_without_fma(tmp_path, scene_expr: str, o, d, *, depth, seed,
                          env=None):
    """``trace_jax`` of the scene the expression ``scene_expr`` builds (with
    ``h``, this module, in scope) in a fresh process whose XLA-CPU target
    has no FMA (see ``wave_jax_without_fma``) and whose environment adds
    ``env``. Returns (rad, seg)."""
    rays = tmp_path / "rays.npz"
    np.savez(rays, o=o, d=d)
    code = (
        f"r = np.load({str(rays)!r})\n"
        f"rad, n = h.trace_jax({scene_expr}, r['o'], r['d'], depth={depth}, "
        f"seed={seed})\n"
        "out = {'rad': rad, 'seg': np.asarray(n)}"
    )
    data = jax_arrays_without_fma(tmp_path, code, env)
    return data["rad"], int(data["seg"])


def close_share(a, b) -> float:
    """Share of slots whose radiance agrees within ATOL/RTOL."""
    return float(np.isclose(a, b, atol=ATOL, rtol=RTOL).all(axis=1).mean())


def bits(x) -> np.ndarray:
    """The raw bits of a torch tensor or a JAX / numpy array, as int16 or
    int32 numpy (2- or 4-byte elements), for bit-for-bit comparisons."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        return x.view(torch.int16 if x.element_size() == 2
                      else torch.int32).numpy()
    x = np.asarray(x)
    return x.view(np.int16 if x.itemsize == 2 else np.int32)


@functools.lru_cache(maxsize=None)
def probe_script(name: str):
    """The JAX package's probe script ``scripts/<name>.py``, imported by
    path (its kernels run from the tests as they stand)."""
    path = os.path.join(_ROOT, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_arrays_without_fma(tmp_path, code: str, env=None) -> dict:
    """Run ``code`` in a fresh process whose XLA-CPU target has no FMA (see
    ``NO_FMA_FLAG``; the flag is read once, when the backend starts) and
    whose environment adds ``env``, with this module as ``h`` and ``np``
    in scope; ``code`` leaves a dict of numpy arrays in ``out``, which is
    returned."""
    path = tmp_path / "arrays_no_fma.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env or {}))
    env["XLA_FLAGS"] = f"{env.get('XLA_FLAGS', '')} {NO_FMA_FLAG}".strip()
    env["PYTHONPATH"] = os.pathsep.join([_ROOT, _TESTS])
    script = (
        "import numpy as np, torch_port_helpers as h\n"
        f"{code}\n"
        f"np.savez({str(path)!r}, **out)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=_ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


# The segment-split probe's hit camera: cover's camera looking down on the
# spheres (ops/segment_split.py; tools/probe_segment_split.py).
PROBE_HIT_CAMERA = dict(lookfrom=(0.0, 12.0, 0.5), lookat=(0.0, 0.0, 0.0))


def probe_camera_params(camera: str):
    """Cover's camera parameters ("cover"), or the probe's hit camera."""
    params, _ = rt.load_and_build(COVER)
    if camera == "hit":
        params = dataclasses.replace(params, **PROBE_HIT_CAMERA)
    return params


def probe_camera_vector(camera: str) -> np.ndarray:
    """The 20-float camera operand as ``probe_segment_split.main`` builds
    it from the JAX package's derived camera."""
    params = probe_camera_params(camera)
    frame = rt.derive(params)
    parts = [np.asarray(getattr(frame, n), np.float32).reshape(-1)
             for n in _CAMERA_VECTORS[:-1]]
    parts.append(np.asarray([params.defocus_angle, 0.0], np.float32))
    return np.concatenate(parts).astype(np.float32)


def segment_probe_jax(variant: str, camera: str, *, steps: int, seed: int,
                      tiles: int = 1) -> np.ndarray:
    """``probe_segment_split``'s kernel (``make_kernel``) on the cover scene
    in TPU-interpret mode, wrapped as ``run_variant`` wraps it: f32[3,
    tiles * 1024]."""
    import jax
    from jax.experimental import pallas as pl

    m = probe_script("probe_segment_split")
    _, scene = rt.load_and_build(COVER)
    geom_h, geom_c, shade, _ = ptrace.pack_scene(scene)
    planes = ptrace.pack_scene(scene, with_planes=6)[4]
    fn = pl.pallas_call(
        m.make_kernel(variant, steps, geom_h.shape[0]),
        grid=(tiles,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)] * 2
        + [pl.BlockSpec(memory_space=pltpu.VMEM)] * 4,
        out_specs=pl.BlockSpec((3, 8, 128), lambda i: (0, i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((3, tiles * 8, 128), jnp.float32),
        interpret=pltpu.InterpretParams(),
    )
    out = fn(jnp.full((1,), seed, jnp.int32),
             jnp.asarray(probe_camera_vector(camera)), geom_h, geom_c, shade,
             planes)
    return np.asarray(out).reshape(3, -1)


class _Interpret:
    """A stand-in for a probe script's ``pl`` whose ``pallas_call`` runs in
    TPU-interpret mode and keeps the callable it built."""

    def __init__(self, pl):
        self._pl = pl
        self.built = None

    def __getattr__(self, name):
        return getattr(self._pl, name)

    def pallas_call(self, kernel, **kw):
        kw["interpret"] = pltpu.InterpretParams()
        self.built = self._pl.pallas_call(kernel, **kw)
        return self.built


class _Built(Exception):
    pass


class _NoJit:
    """A stand-in for a probe script's ``jax`` whose ``jit`` stops the
    probe right after its kernel is built."""

    def __init__(self, jax_mod):
        self._jax = jax_mod

    def __getattr__(self, name):
        return getattr(self._jax, name)

    def jit(self, fn):
        raise _Built


def rate_probe_kernel(mod, dtype, op: str, iters: int):
    """The kernel that ``scripts/probe_dtype.py``'s ``rate_probe(dtype, op,
    iters)`` builds, in TPU-interpret mode: the probe runs as it stands up
    to its ``jax.jit`` (it times the kernel under jit and never returns
    its output), and the ``pallas_call`` it made is returned to be called
    on any ``(a, b)`` of its tile's shape."""
    saved_pl, saved_jax = mod.pl, mod.jax
    mod.pl, mod.jax = _Interpret(saved_pl), _NoJit(saved_jax)
    try:
        mod.rate_probe(dtype, op, iters=iters)
    except _Built:
        pass
    finally:
        built = mod.pl.built
        mod.pl, mod.jax = saved_pl, saved_jax
    assert built is not None, "rate_probe built no pallas_call"
    return built


def sweep_edge_scene_jax():
    """The three spheres of the sweep's edge-case rays
    (``raytracing_tpu_torch/tools/sweep_edges.py``) in the JAX package."""
    from raytracing_tpu_torch.tools import sweep_edges

    return sweep_edges.add_spheres(SceneBuilder()).build()
