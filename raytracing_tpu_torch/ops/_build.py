"""Build and load the port's CUDA kernels.

Each kernel source ``csrc/<name>.cu`` exposes a plain C interface. At first
use it is compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared
library under ``raytracing_tpu_torch/_build/<name>-<hash>/`` (git-ignored;
the hash covers the source, the headers it includes and the flags, so an
edited source or header rebuilds) and loaded with ``ctypes``. Nothing here
runs at import time, and nothing falls back: a missing ``nvcc`` or a failed
build raises. ``build_all`` runs one ``nvcc`` per source, all at once;
``build_host`` builds a host C++ library the same way with ``c++``.
``launch`` is every kernel's launcher: it calls a C launcher on a device's
current stream at the least host cost a call, raises on its error code and
counts the launch in ``launch_counts``, the one registry of launches.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import ctypes
import fcntl
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import time

import torch

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_c_ptr = ctypes.c_void_p
_c_int = ctypes.c_int
# The scene arguments both entries of regen.cu take first.
_SCENE_ARGS = [
    _c_ptr, _c_ptr, _c_ptr, _c_int,            # geom_h, geom_c, shade, n_pad
    _c_int, _c_int, _c_ptr, _c_ptr,            # n_actual, sph_two_level, sph_ord, sph_bnd
    _c_ptr, _c_int, _c_int, _c_int,            # tex, tex_rows, kh, kw
    _c_ptr, _c_int, _c_int, _c_int,            # tri, m_pad, m_actual, tri_mode
    _c_ptr, _c_ptr,                            # tri_ord, tri_bnd
    _c_int, _c_int, _c_int, _c_int,            # cull_sphere, sph_sub, tri_sub, hint
    _c_int, _c_int,                            # radix_rows, radix_windows
]
_ARGTYPES = {
    "regen": {
        "rt_regen_launch": _SCENE_ARGS + [
            _c_ptr, _c_ptr, _c_ptr, _c_ptr,            # done_in, done_out, rad, segments
            ctypes.POINTER(ctypes.c_float),            # camera (host, 20 floats)
            _c_int, _c_int, _c_int, _c_int,            # num_slots, slot_base, map_param, tiled
            ctypes.c_uint, _c_int, _c_int, _c_int,     # seed, sample_start, spp, max_depth
            _c_int, _c_ptr,                            # t_end, stream
        ],
        "rt_trace_launch": _SCENE_ARGS + [
            _c_ptr, _c_ptr, _c_ptr, _c_ptr,            # ray_o, ray_d, rad, segments
            _c_ptr,                                    # queue
            _c_int, ctypes.c_uint, _c_int, _c_int,     # count, seed, tile_offset, tile_rays
            _c_int, _c_ptr,                            # max_depth, stream
        ],
        "rt_regen_occupancy": _SCENE_ARGS + [
            _c_int, ctypes.POINTER(ctypes.c_int),      # entry, blocks (out)
        ],
        "rt_sweep_root_launch": [
            ctypes.c_uint, _c_int, _c_ptr, _c_ptr,     # first, n, root, outside
            _c_ptr,                                    # stream
        ],
        "rt_key_rcp_launch": [
            ctypes.c_uint, _c_int, _c_ptr, _c_ptr,     # first, n, rcp, outside
            _c_ptr,                                    # stream
        ],
    },
    "fetch": {
        "rt_fetch_launch": [
            _c_ptr, _c_int, _c_int,                    # table, n_rows, cols
            _c_ptr, _c_int, _c_ptr,                    # sel, g, out
            _c_int, _c_int, _c_ptr, _c_ptr,            # mode, iters, planes, stream
        ],
        "rt_fetch_planes_launch": [
            _c_ptr, _c_int, _c_int,                    # table, n_rows, cols
            _c_ptr, _c_ptr,                            # planes, stream
        ],
        "rt_fetch_plane_streams": [_c_int, _c_int],    # n_rows, cols
        "rt_fetch_sweep_rows": [],
    },
    "segment_split": {
        "rt_segment_split_launch": [
            _c_ptr, _c_ptr, _c_ptr, _c_int,            # geom_h, geom_c, shade, n_pad
            ctypes.POINTER(ctypes.c_float),            # camera (host, 20 floats)
            ctypes.c_uint, _c_int, _c_int, _c_int,     # seed, steps, slots, variant
            _c_ptr, _c_ptr, _c_ptr, _c_ptr,            # rad, hits, clocks, stream
        ],
    },
    "worklist": {
        "rt_worklist_launch": [
            _c_ptr, _c_ptr, _c_ptr,                    # tab, rays, votes
            _c_int, _c_int, _c_int,                    # units, reps, mode
            _c_ptr, _c_ptr,                            # out, stream
        ],
    },
    "divide": {
        "rt_divide_launch": [
            _c_ptr, _c_ptr, _c_ptr, _c_ptr,            # x, num, recip, quot
            _c_int, _c_int, _c_ptr,                    # n, mode, stream
        ],
    },
    "dtype": {
        "rt_dtype_bitcast_launch": [
            _c_ptr, _c_ptr, _c_ptr,                    # x, out, halves
            _c_int, _c_ptr,                            # words, stream
        ],
        "rt_dtype_rate_launch": [
            _c_ptr, _c_ptr, _c_ptr,                    # a, b, out
            _c_int, _c_int, _c_int, _c_ptr,            # words, mode, iters, stream
        ],
        "rt_dtype_steps_per_body": [],
    },
    "features": {
        "rt_features_launch": [
            _c_ptr, _c_ptr, _c_ptr,                    # a, b, out
            _c_int, _c_int, _c_ptr,                    # units, mode, stream
        ],
    },
}
# Every kernel source, for build_all.
KERNELS = tuple(_ARGTYPES)

_loaded: dict[str, ctypes.CDLL] = {}
# Launches since the last reset_launch_counts(), by the key each launcher
# passes to launch(): the megakernel's variants (ops/trace.py::VARIANTS,
# ROUTE_VARIANTS) and the other kernels' modes (fetch_*, segment_*,
# worklist_*, divide_*, dtype_*, features_*, sweep_root, key_rcp). A key
# never launched reads 0.
launch_counts: collections.Counter = collections.Counter()
# Per kernel: build seconds (0.0 when the library was already built) and
# the compiler's resource report (registers, shared memory, stack and
# spills).
build_info: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME); the CUDA kernels are built from "
        "raytracing_tpu_torch/csrc at first use"
    )


def _sources(name: str) -> list[pathlib.Path]:
    """``csrc/<name>.cu`` and every ``csrc`` header it includes, directly
    or through another header."""
    found = [CSRC / f"{name}.cu"]
    for src in found:
        for inc in re.findall(r'^#include "([^"]+)"', src.read_text(),
                              flags=re.M):
            path = CSRC / inc
            if path.exists() and path not in found:
                found.append(path)
    return found


def _flags(defines=()) -> tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def _key(name: str, defines=()) -> str:
    return f"{name}[{','.join(defines)}]" if defines else name


def library_path(name: str, defines=()) -> pathlib.Path:
    """The library's path, keyed by a hash of its source, the headers it
    includes and the flags (``defines`` are extra ``-D`` macros), so that
    editing any of them rebuilds."""
    h = hashlib.sha256(" ".join(_flags(defines)).encode())
    for src in _sources(name):
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}" / f"lib{name}.so"


def build(name: str, defines=()) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` (with ``-D`` for each of ``defines``)
    unless the library for this exact source exists; returns its path.
    Concurrent builders serialize on a lock. ``build_info`` keys a build
    with defines as ``name[D1,D2]``."""
    lib = library_path(name, defines)
    return _compile(lib, _key(name, defines), lambda out: [
        _nvcc(), *_flags(defines), "-o", out, str(CSRC / f"{name}.cu"),
    ])


def build_host(name: str, source: pathlib.Path, flags=(), libs=()
               ) -> pathlib.Path:
    """Compile the host C++ ``source`` into ``lib<name>.so`` with the
    system's ``c++`` (``flags`` before the source, ``libs`` after it),
    cached and locked as ``build`` does, keyed by a hash of the source and
    the flags; raises when no compiler is found or the build fails."""
    compiler = shutil.which("c++") or shutil.which("g++")
    if compiler is None:
        raise RuntimeError("no C++ compiler (c++ or g++) on the PATH")
    h = hashlib.sha256(" ".join((*flags, *libs)).encode())
    h.update(source.read_bytes())
    lib = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}" / f"lib{name}.so"
    return _compile(lib, name, lambda out: [
        compiler, *flags, "-o", out, str(source), *libs,
    ])


def _compile(lib: pathlib.Path, key: str, command) -> pathlib.Path:
    """Run ``command(tmp_path)`` to build ``lib`` unless it exists, under
    the lock of its directory; the output is renamed into place."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    with open(lib.parent / "build.lock", "a+") as lock:
        fcntl.flock(lock.fileno(), fcntl.LOCK_EX)
        if lib.exists():
            build_info.setdefault(key, {"seconds": 0.0, "ptxas": ""})
            return lib
        tmp = lib.with_suffix(".so.tmp")
        cmd = command(str(tmp))
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"{os.path.basename(cmd[0])} failed building {key} (exit "
                f"{proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}\n"
                f"{proc.stderr}"
            )
        os.replace(tmp, lib)
        build_info[key] = {
            "seconds": secs,
            "ptxas": "\n".join(
                ln for ln in (proc.stdout + proc.stderr).splitlines()
                if "ptxas" in ln or "spill" in ln
            ),
        }
    return lib


def build_all(names, variants=()) -> dict[str, pathlib.Path]:
    """Build every kernel in ``names``, and each ``(name, defines)`` of
    ``variants``, one ``nvcc`` per library, started together; returns
    their library paths by ``build_info`` key."""
    jobs = [(n, ()) for n in names] + [(n, tuple(d)) for n, d in variants]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        paths = pool.map(lambda job: build(*job), jobs)
        return {_key(n, d): path for (n, d), path in zip(jobs, paths)}


def registers(key: str) -> dict[str, int]:
    """Registers per compiled kernel (mangled name) of a library built in
    this process, from the compiler's report in ``build_info[key]``."""
    regs, entry = {}, None
    for line in build_info[key]["ptxas"].splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            regs[entry] = int(m.group(1))
            entry = None
    return regs


def spills(key: str) -> dict[str, tuple[int, int]]:
    """Spill bytes (stored, loaded) per compiled function (mangled name) of
    a library built in this process, from ``build_info[key]``."""
    out, name = {}, None
    for line in build_info[key]["ptxas"].splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name is not None:
            out[name] = (int(m.group(1)), int(m.group(2)))
            name = None
    return out


def load(name: str, defines=()) -> ctypes.CDLL:
    """The built library of kernel ``name`` (with ``-D`` for each of
    ``defines``) with its argtypes set."""
    key = _key(name, tuple(defines))
    if key in _loaded:
        return _loaded[key]
    lib = ctypes.CDLL(str(build(name, tuple(defines))))
    for fn, argtypes in _ARGTYPES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    lib.rt_error_string.argtypes = [ctypes.c_int]
    lib.rt_error_string.restype = ctypes.c_char_p
    _loaded[key] = lib
    return lib


@contextlib.contextmanager
def swapped(name: str, defines=()):
    """Within the block, every wrapper that loads kernel ``name`` launches
    its build with ``defines`` instead (a measurement build: the tools time
    a ``-D`` variant through the port's own wrappers)."""
    lib = load(name, defines)
    prev = _loaded.get(name)
    _loaded[name] = lib
    try:
        yield lib
    finally:
        if prev is None:
            del _loaded[name]
        else:
            _loaded[name] = prev


def reset_launch_counts() -> None:
    launch_counts.clear()


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise ``RuntimeError`` naming ``what`` where a C entry of ``lib``
    returned the error code ``err`` (0 is success)."""
    if err != 0:
        raise RuntimeError(
            f"{what} failed: {err} ({lib.rt_error_string(err).decode()})")


def launch(name: str, entry: str, device: torch.device, *args,
           count: str) -> None:
    """``entry(*args, stream)``: the C launcher ``entry`` of kernel
    ``name``'s library (``load``'s, or the build ``swapped`` puts in its
    place), called with the raw pointer of ``device``'s current stream (no
    Stream object is built), switching the current device only where
    ``device`` is not it. Raises ``RuntimeError`` on a non-zero code and
    counts nothing; else adds one to ``launch_counts[count]``."""
    lib = load(name)
    fn = getattr(lib, entry)
    current = torch._C._cuda_getDevice()
    index = current if device.index is None else device.index
    if index == current:
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    check(lib, err, f"{count} launch ({entry})")
    launch_counts[count] += 1
