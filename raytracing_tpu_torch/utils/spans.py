"""The port's spans, on ``torch.profiler``'s clock.

``span(name)`` is a context manager. While a profiler records on the
calling thread it is a ``torch._C._profiler._RecordFunctionFast``: a
FUNCTION-scope event on the profiler's host timeline, beside the device
trace (``record_function``'s user-scope events are mirrored onto the
device timeline as annotations; these are not). Otherwise it is ``OFF``,
one shared no-op, for the cost of one check. There is no exporter: what
consumes the profiler carries the spans (the CLI's ``--profile-dir``
chrome trace, the benchmark's in-memory record).

The catalogue; a child lies inside its parent's interval on the same
thread:

    rt.render                 ``Renderer.render``, call to return
      rt.render.wave          one wave: its launch, its segment count queued
        rt.launch.regen       (below)
      rt.render.readback      ``Renderer._finish``: the u8 image to the host
        rt.readback.copy      ``fetch_image``'s ``u8.cpu()``, which takes in
                              the wait for the last kernel
        rt.readback.untile    ``fetch_image``'s ``_slots_to_image`` (slot
                              order only)
        rt.readback.segments  the wait for the last launch's segment count
    rt.launch.regen           ``ops/trace.py::render_pixels_fused``
      rt.launch.checks        its argument checks and ``_check_tables``
    rt.launch.trace           ``ops/trace.py::trace_rays_fused``
      rt.launch.checks        its argument checks and ``_check_tables``
    rt.frame.wait             ``InteractiveSession.step``'s main thread
                              blocked on the pipeline's pending presents

The profiler records only on the thread that entered it, so the session's
presenter, on a worker thread, keeps a counter instead
(``InteractiveSession.presents``, on the host's clock).

The counters, taken with the segments in ``rt.readback.segments``'s wait
(``Renderer.cull_counts``, per render; ``ops/trace.py::CULL_COUNTS``; the
kernel adds them at its end, ``regen.cu::add_counts``, in the chunked
sphere sweep only, zero where the table is staged):

    lane_passes    (ray, block) pairs whose cull gate passed (every block
                   of a live ray without bound tables)
    chunk_copies   (thread block, block) visits of the lock step whose
                   vote copied the chunk
    block_visits   every such visit
"""

from __future__ import annotations

import contextlib

import torch

_recording = torch._C._autograd._profiler_enabled
_Span = torch._C._profiler._RecordFunctionFast

OFF = contextlib.nullcontext()


def span(name: str):
    """A span named ``name`` while a profiler records on this thread; the
    shared no-op ``OFF`` otherwise."""
    if _recording():
        return _Span(name)
    return OFF
