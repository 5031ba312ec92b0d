"""The traced run's record: ``torch.profiler`` over the measured window,
reduced to plain lists that the per-layer readers take their numbers
from. Nothing is written to disk.

The benchmark marks its own spans with ``record_function``: the window
(``rtbench.window``) and each request in it (``rtbench.render``,
``rtbench.batch``, ``rtbench.step``); the device's kernels and copies come
from the profiler's CUDA activity on the same clock."""

from __future__ import annotations

import bisect
import contextlib
import dataclasses

from .yardstick import union_us

WINDOW = "rtbench.window"


@dataclasses.dataclass
class Record:
    """Intervals in microseconds on the profiler's clock."""

    device: list        # (name, start, end) of each kernel and copy
    spans: list         # (name, start, end) of the benchmark's own spans
    host: list          # (name, start, end) of every host-side op
    window: tuple       # (start, end) of the measured window

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def clipped(self, intervals):
        a0, b0 = self.window
        return [(max(a, a0), min(b, b0)) for a, b in intervals
                if b > a0 and a < b0]

    def busy_s(self) -> float:
        return union_us(self.clipped((a, b) for _, a, b in self.device)) / 1e6

    def kernels(self, pattern) -> list:
        """(name, start, end) of the device events whose name matches the
        compiled regex ``pattern``."""
        return [e for e in self.device if pattern.search(e[0])]

    def spans_named(self, name: str) -> list:
        return [(a, b) for n, a, b in self.spans if n == name]

    def top_device(self, k: int = 10) -> list:
        per: dict[str, float] = {}
        for n, a, b in self.device:
            per[n] = per.get(n, 0.0) + (b - a) / 1e6
        return sorted(per.items(), key=lambda kv: -kv[1])[:k]

    def idle_gaps(self, k: int = 10) -> list:
        """The device's idle time inside the window, by what the host was
        doing then (the innermost host op or span around each gap's
        middle), the longest first."""
        busy = sorted(self.clipped((a, b) for _, a, b in self.device))
        gaps, t = [], self.window[0]
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if t < self.window[1]:
            gaps.append((t, self.window[1]))
        around = sorted(((a, b, n) for n, a, b in self.host + self.spans),
                        key=lambda e: e[0])
        starts = [e[0] for e in around]
        per: dict[str, float] = {}
        for a, b in gaps:
            mid = 0.5 * (a + b)
            i = bisect.bisect_right(starts, mid)
            # Ops that contain one another start close together: the
            # innermost op around ``mid`` is among the last few begun.
            inner = [(e - s, n) for s, e, n in around[max(0, i - 256):i]
                     if e >= mid]
            label = min(inner)[1] if inner else "host between ops"
            per[label] = per.get(label, 0.0) + (b - a) / 1e6
        return sorted(per.items(), key=lambda kv: -kv[1])[:k]


class Profiler:
    """``with Profiler(on) as p: ...``: profiles the block when ``on``;
    ``p.record`` is then a ``Record`` (None when off)."""

    def __init__(self, on: bool) -> None:
        self.on = on
        self.record: Record | None = None
        self._stack = contextlib.ExitStack()
        self._prof = None

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile, record_function

            self._prof = self._stack.enter_context(profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
            self._stack.enter_context(record_function(WINDOW))
        return self

    def __exit__(self, *exc):
        self._stack.close()
        if self._prof is not None and exc[0] is None:
            self.record = digest(self._prof)
        return False


def span(name: str, on: bool):
    """A span of the benchmark's own around a request (a no-op untraced)."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


def digest(prof) -> Record:
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, spans, host, window = [], [], [], None
    for e in prof.events():
        a, b = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == cuda:
            # The profiler mirrors each span of the benchmark's own on the
            # device's timeline; only kernels and copies are device work.
            if not e.name.startswith("rtbench."):
                device.append((e.name, a, b))
        elif e.name == WINDOW:
            window = (a, b)
        elif e.name.startswith("rtbench."):
            spans.append((e.name, a, b))
        else:
            host.append((e.name, a, b))
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    return Record(device, spans, host, window)
