"""The kernel module's ``RT_*`` knobs: one environment, the same winner
rules in both packages, or an error in both.

The port reads the knobs in one place (``ops/trace.py::env_settings``, at
``pack_scene``), with the JAX package's bounds and messages:
``RT_TWO_LEVEL_MIN`` picks both rules as ``_two_level_enabled`` does; a
value the port cannot honour raises (non-default ``RT_SWEEP_ROWS`` /
``RT_WIN``, ``RT_TRI_FORM=triple``, ``RT_SWEEP_FMA=1``), as does a bad
value of any knob; the knobs that change no bit of the image
(``RT_FLAT_BLK``, ``RT_TRI_BLK``, ``RT_SWEEP_LOAD``) are validated only.
Every test here sets the environment alone, for both packages.
"""

import importlib.util

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import raytracing_tpu as rt  # noqa: E402
from raytracing_tpu.ops.pallas import trace as ptrace  # noqa: E402

from raytracing_tpu_torch.ops import trace as ttrace  # noqa: E402

from torch_port_helpers import (  # noqa: E402
    close_share, golden_mesh_scene_jax, golden_scene_jax,
    metal_cloud_scene_jax, to_port, trace_jax, trace_port,
)

ROWS = (128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768)


@pytest.fixture(scope="module")
def mesh3():
    """mesh:3 in the port (2,048 triangle rows) and its tables packed with
    the default knobs."""
    _, mesh = rt.make_world_mesh(image_width=32, subdivisions=3)
    ts = to_port(mesh)
    return ts, ttrace.pack_scene(ts)


@pytest.mark.parametrize("value", [None, "0", "256", "257", "513", "1024",
                                   "4096", "8192", "8193", str(1 << 30)])
def test_two_level_min_picks_the_jax_rules(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("RT_TWO_LEVEL_MIN", raising=False)
    else:
        monkeypatch.setenv("RT_TWO_LEVEL_MIN", value)
    sph_min, tri_min = ttrace.env_settings()
    for rows in ROWS:
        assert (ttrace.two_level_rule(rows, sph_min) == "2l") == \
            ptrace._two_level_enabled(rows)
        assert (ttrace.two_level_rule(rows, tri_min) == "2l") == \
            ptrace._two_level_enabled(rows, tri=True)


def test_two_level_min_513_on_the_metal_cloud(monkeypatch):
    # The 600-sphere metal cloud pads to 1,024 rows: the flat rule by
    # default, the two-level rule from RT_TWO_LEVEL_MIN=513 in both.
    _, js = metal_cloud_scene_jax()
    ts = to_port(js)
    assert ttrace.pack_scene(ts).sphere_rule == "flat"
    monkeypatch.setenv("RT_TWO_LEVEL_MIN", "513")
    tables = ttrace.pack_scene(ts)
    assert tables.n_pad == 1024 and ptrace._two_level_enabled(1024)
    assert tables.sphere_rule == "2l"
    assert ttrace.kernel_variant(tables) == "regen_sph2l"
    # Two 512-row cull blocks, as the JAX package builds them.
    assert tables.sph_bounds is not None and tables.sph_bounds.shape[0] == 2


def test_triangle_rule_follows_the_environment(monkeypatch, mesh3):
    ts, tables = mesh3
    assert (tables.m_pad, tables.tri_rule) == (2048, "2l")
    assert tables.tri_bounds is not None
    monkeypatch.setenv("RT_TWO_LEVEL_MIN", str(1 << 30))
    flat = ttrace.pack_scene(ts)
    assert flat.tri_rule == "flat" and flat.tri_bounds is None
    assert not ptrace._two_level_enabled(2048, tri=True)
    assert ttrace.kernel_variant(flat, "trace").endswith("_tri_flat")
    # Below two windows no value asks for the two-level rule.
    monkeypatch.setenv("RT_TWO_LEVEL_MIN", "1")
    small = ttrace.pack_scene(to_port(golden_mesh_scene_jax()))
    assert (small.m_pad, small.tri_rule, small.sphere_rule) == \
        (128, "flat", "flat")


def test_flat_triangle_rule_past_512_rows_matches_jax(monkeypatch):
    # Two 320-triangle icospheres (1,024 rows) under the flat rule: the
    # JAX package sweeps them in two culled 512-row blocks, the port in one
    # unculled sweep; the cull changes no bit, so the rule is the same.
    # Measured: segments equal and every ray within tolerance.
    monkeypatch.setenv("RT_TWO_LEVEL_MIN", str(1 << 30))
    params, js = rt.make_world_meshes(2, image_width=32)
    tables = ttrace.pack_scene(to_port(js))
    assert (tables.m_pad, tables.tri_rule) == (1024, "flat")
    jcam = rt.derive(params)
    n = 1024
    idx = np.arange(n)
    px = (idx % jcam.image_width).astype(np.float32)
    py = (idx // jcam.image_width).astype(np.float32)
    c = np.asarray(jcam.center, np.float32)
    d = (np.asarray(jcam.pixel00)[None] + px[:, None]
         * np.asarray(jcam.pixel_delta_u)[None] + py[:, None]
         * np.asarray(jcam.pixel_delta_v)[None] - c[None]).astype(np.float32)
    o = np.ascontiguousarray(np.broadcast_to(c, d.shape))
    rad_j, seg_j = trace_jax(js, o, d, depth=3, seed=3)
    rad_t, seg_t = trace_port(js, o, d, depth=3, seed=3)
    assert seg_t == seg_j
    assert close_share(rad_t, rad_j) == 1.0


# Valid for the JAX package, refused by the port: other values change
# near-tie winners and the kernel has only the defaults.
REFUSED = [("RT_SWEEP_ROWS", "256"), ("RT_SWEEP_ROWS", "1024"),
           ("RT_WIN", "64"), ("RT_WIN", "256"), ("RT_TRI_FORM", "triple"),
           ("RT_SWEEP_FMA", "1")]
# Bad in both packages.
BAD = [("RT_SWEEP_ROWS", "100"), ("RT_SWEEP_ROWS", "64"), ("RT_WIN", "7"),
       ("RT_WIN", "1024"), ("RT_FLAT_BLK", "64"), ("RT_FLAT_BLK", "200"),
       ("RT_FLAT_BLK", "1024"), ("RT_TRI_BLK", "64"), ("RT_TRI_BLK", "1024"),
       ("RT_SWEEP_LOAD", "wide"), ("RT_TRI_FORM", "fast"),
       ("RT_SWEEP_FMA", "yes"), ("RT_TWO_LEVEL_MIN", "abc")]


@pytest.mark.parametrize("var, value", REFUSED + BAD)
def test_knob_raises_at_pack_scene(monkeypatch, var, value):
    monkeypatch.setenv(var, value)
    with pytest.raises(ValueError, match=var if var != "RT_TWO_LEVEL_MIN"
                       else "invalid literal"):
        ttrace.pack_scene(to_port(golden_scene_jax()))


# The JAX package's call-time reader of each knob.
_JAX_READERS = {
    "RT_FLAT_BLK": lambda: ptrace._flat_blk(512),
    "RT_TRI_BLK": lambda: ptrace._tri_blk(1024),
    "RT_TRI_FORM": ptrace._tri_form,
    "RT_SWEEP_FMA": ptrace._sweep_fma,
    "RT_TWO_LEVEL_MIN": lambda: ptrace._two_level_enabled(512),
}


@pytest.mark.parametrize("var, value", [b for b in BAD
                                        if b[0] in _JAX_READERS])
def test_bad_value_raises_as_in_the_jax_package(monkeypatch, var, value):
    monkeypatch.setenv(var, value)
    with pytest.raises(ValueError) as jax_err:
        _JAX_READERS[var]()
    with pytest.raises(ValueError) as port_err:
        ttrace.env_settings()
    assert str(port_err.value) == str(jax_err.value)


def _jax_import_error(monkeypatch, var: str, value: str) -> str:
    """The message with which the JAX package's kernel module refuses
    ``var=value`` when it is imported: a fresh copy of the module, executed
    under the variable and kept out of ``sys.modules``."""
    spec = importlib.util.spec_from_file_location(
        "raytracing_tpu.ops.pallas._trace_fresh", ptrace.__file__)
    mod = importlib.util.module_from_spec(spec)
    monkeypatch.setenv(var, value)
    with pytest.raises(ValueError) as err:
        spec.loader.exec_module(mod)
    monkeypatch.delenv(var)
    return str(err.value)


def test_import_time_and_sweep_knobs_raise_as_in_the_jax_package(
        monkeypatch):
    # RT_SWEEP_ROWS and RT_WIN are read when the JAX package's kernel
    # module is imported, RT_SWEEP_LOAD while a sweep is traced: their
    # messages come from a fresh copy of the module, and from the sweep's
    # own format.
    for var, value in [("RT_SWEEP_ROWS", "100"), ("RT_WIN", "7"),
                       ("RT_WIN", "1024")]:
        want = _jax_import_error(monkeypatch, var, value)
        monkeypatch.setenv(var, value)
        with pytest.raises(ValueError) as port_err:
            ttrace.env_settings()
        assert str(port_err.value) == want
        monkeypatch.delenv(var)
    monkeypatch.setenv("RT_SWEEP_LOAD", "wide")
    with pytest.raises(ValueError) as port_err:
        ttrace.env_settings()
    assert str(port_err.value) == (
        f"RT_SWEEP_LOAD={'wide'!r} must be 'split' or 'fused'")


@pytest.mark.parametrize("var, value", [
    ("RT_FLAT_BLK", "128"), ("RT_FLAT_BLK", "256"), ("RT_TRI_BLK", "128"),
    ("RT_TRI_BLK", "512"), ("RT_SWEEP_LOAD", "fused"),
    ("RT_TRI_FORM", "classic"), ("RT_SWEEP_FMA", "0"),
    ("RT_SWEEP_ROWS", "512"), ("RT_WIN", "128"),
])
def test_image_invariant_knobs_leave_the_tables(monkeypatch, mesh3, var,
                                                value):
    ts, want = mesh3
    monkeypatch.setenv(var, value)
    got = ttrace.pack_scene(ts)
    for name in ("geom_h", "geom_c", "shade", "tri", "tri_order",
                 "tri_bounds"):
        # Bit patterns: the packed material words can be NaN as floats.
        assert torch.equal(getattr(got, name).view(torch.int32),
                           getattr(want, name).view(torch.int32))
    assert (got.sphere_rule, got.tri_rule) == (want.sphere_rule, want.tri_rule)
