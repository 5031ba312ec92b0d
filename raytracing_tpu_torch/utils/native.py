"""ctypes bridge to the host C++ helpers of ``native/rtnative.cc``.

Counterpart of ``raytracing_tpu/utils/native.py``: the same three helpers
around the render (the kernels stay on the card), from the same source,
which this module reads and never edits:

  * ``png_encode``: PNG encoding (Paeth filter, zlib level 6).
  * ``compose_halfblock``: the live terminal display's ANSI half-block
    frame composition.
  * ``FramePump``: an async PNG frame writer (a worker thread and a bounded
    queue) so that encoding and IO overlap the card's work.

The library is built at first use with the system's ``c++`` and the flags
of ``native/Makefile`` into ``raytracing_tpu_torch/_build/`` (git-ignored),
keyed by a hash of the source, through ``ops/_build.py``'s cache and lock;
the JAX package's ``native/librtnative.so`` is never loaded. Without a
compiler, zlib or the source, ``available()`` is False, ``status()`` says
why, and the callers (``utils/png.py``, ``runtime/display.py``) use their
pure-Python versions, as the JAX package does without its library.
"""

from __future__ import annotations

import ctypes
import pathlib

import numpy as np

SOURCE = pathlib.Path(__file__).resolve().parents[2] / "native" / "rtnative.cc"
# native/Makefile's CXXFLAGS and LDLIBS.
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")
LIBS = ("-lz", "-lpthread")

_lib: ctypes.CDLL | None = None
_status: str | None = None


def _load() -> ctypes.CDLL | None:
    global _lib, _status
    if _status is not None:
        return _lib
    if not SOURCE.exists():
        _status = f"python fallback: {SOURCE} not found"
        return None
    try:
        from ..ops import _build

        path = _build.build_host("rtnative", SOURCE, CXX_FLAGS, LIBS)
        lib = ctypes.CDLL(str(path))
    except (RuntimeError, OSError) as e:
        _status = f"python fallback: {str(e).splitlines()[0]}"
        return None
    lib.rt_compose_halfblock.restype = ctypes.c_longlong
    lib.rt_compose_halfblock.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_longlong,
    ]
    lib.rt_png_encode.restype = ctypes.c_longlong
    lib.rt_png_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_longlong,
    ]
    lib.rt_pump_create.restype = ctypes.c_void_p
    lib.rt_pump_create.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.rt_pump_submit.restype = ctypes.c_int
    lib.rt_pump_submit.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
    ]
    lib.rt_pump_destroy.restype = ctypes.c_int
    lib.rt_pump_destroy.argtypes = [ctypes.c_void_p]
    _lib, _status = lib, f"native: {path}"
    return _lib


def available() -> bool:
    """Whether the library is built and loaded (building it at the first
    call); ``status()`` gives the reason when it is not."""
    return _load() is not None


def status() -> str:
    """``"native: <library path>"``, or ``"python fallback: <reason>"``."""
    _load()
    return _status


def compose_halfblock(img: np.ndarray) -> str:
    """uint8[H, W, 3] -> ANSI half-block frame string (C++ composer)."""
    lib = _load()
    assert lib is not None
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w, _ = img.shape
    # Worst case ~40 bytes a cell, plus newlines.
    cap = (h // 2 + 1) * (w + 1) * 44 + 64
    buf = ctypes.create_string_buffer(cap)
    n = lib.rt_compose_halfblock(
        img.ctypes.data_as(ctypes.c_void_p), w, h, buf, cap
    )
    if n < 0:
        raise RuntimeError("rt_compose_halfblock: buffer too small")
    return buf.raw[:n].decode("utf-8")


def png_encode(img: np.ndarray) -> bytes:
    """uint8[H, W, 3] -> PNG bytes (C++ encoder)."""
    lib = _load()
    assert lib is not None
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w, _ = img.shape
    cap = w * h * 3 + (h * 6) + 1024
    buf = ctypes.create_string_buffer(cap)
    n = lib.rt_png_encode(
        img.ctypes.data_as(ctypes.c_void_p), w, h, buf, cap
    )
    if n < 0:
        raise RuntimeError("rt_png_encode: buffer too small")
    return buf.raw[:n]


class FramePump:
    """Async PNG frame writer: a bounded-queue worker thread in C++.

    ``submit`` hands a frame off without blocking the render loop; the
    native thread encodes it and writes ``<prefix>NNNN.png``. ``close``
    drains the queue and joins the thread.
    """

    def __init__(self, prefix: str, queue_depth: int = 4) -> None:
        lib = _load()
        assert lib is not None
        self._lib = lib
        self._h = lib.rt_pump_create(prefix.encode(), queue_depth)
        if not self._h:
            raise RuntimeError("rt_pump_create failed")

    def submit(self, img: np.ndarray, index: int) -> bool:
        """Enqueue a frame; returns False if the queue was full (dropped)."""
        img = np.ascontiguousarray(img, dtype=np.uint8)
        h, w, _ = img.shape
        r = self._lib.rt_pump_submit(
            self._h, img.ctypes.data_as(ctypes.c_void_p), w, h, index
        )
        return r == 0

    def close(self) -> None:
        if self._h:
            self._lib.rt_pump_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
