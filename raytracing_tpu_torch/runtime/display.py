"""Progressive live display on the terminal or as a PNG sequence.

Copy of ``raytracing_tpu/runtime/display.py`` (same bytes to the stream):

  * ``TerminalDisplay`` draws the preview image as 24-bit ANSI half-block
    cells (two image rows per character row), area-downsampled to fit the
    terminal, above three progress rows (pixels, samples, elapsed time
    with Mrays/s); each frame rewinds the cursor over the previous one.
  * ``FileSequenceDisplay`` writes numbered preview PNGs.

Both plug into ``Renderer.render(on_progress=...)`` and present the
interactive session's frames (``runtime/interactive.py``). Frame
composition goes through the native composer (``utils/native.py``) where
it is available, else through numpy.
"""

from __future__ import annotations

import os
import shutil
import sys

import numpy as np

from .renderer import RenderProgress

_RESET = "\x1b[0m"


def _downsample(img: np.ndarray, max_w: int, max_h: int) -> np.ndarray:
    """Integer-factor area-average downsample to fit (max_w, max_h)."""
    h, w, _ = img.shape
    f = max(1, -(-w // max_w), -(-h // max_h))
    if f > 1:
        hh, ww = h // f * f, w // f * f
        img = img[:hh, :ww].reshape(hh // f, f, ww // f, f, 3)
        img = img.mean(axis=(1, 3)).astype(np.uint8)
    return img


def compose_halfblock_frame(img: np.ndarray) -> str:
    """uint8[H, W, 3] -> string of ANSI 24-bit half-block rows."""
    from ..utils import native as _native

    if _native.available():
        return _native.compose_halfblock(img)
    h = img.shape[0] // 2 * 2
    top = img[0:h:2].astype(np.int32)
    bot = img[1:h:2].astype(np.int32)
    rows = []
    for tr, br in zip(top, bot):
        cells = [
            f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m\x1b[48;2;{b[0]};{b[1]};{b[2]}m▀"
            for t, b in zip(tr, br)
        ]
        rows.append("".join(cells) + _RESET)
    return "\n".join(rows)


def _bar(fraction: float, width: int = 40) -> str:
    filled = int(round(max(0.0, min(1.0, fraction)) * width))
    return "[" + "#" * filled + "-" * (width - filled) + "]"


class TerminalDisplay:
    """Live ANSI display + progress panel (``UILogic::do_ui`` analog)."""

    def __init__(
        self,
        *,
        stream=None,
        max_width: int | None = None,
        max_height: int | None = None,
    ) -> None:
        self.stream = stream if stream is not None else sys.stdout
        size = shutil.get_terminal_size((100, 40))
        self.max_width = max_width or max(16, size.columns - 2)
        # 2 image rows per character row; leave 5 rows for the panel.
        self.max_height = max_height or max(16, (size.lines - 6) * 2)
        self._frames = 0

    def __call__(self, progress: RenderProgress) -> None:
        img = _downsample(progress.preview(), self.max_width, self.max_height)
        frame = compose_halfblock_frame(img)
        lines = frame.count("\n") + 1
        out = []
        if self._frames > 0:
            out.append(f"\x1b[{lines + 3}F")  # rewind frame + 3 panel rows
        out.append(frame + "\x1b[0K\n")
        # Two bars, mirroring the reference UI: delivered pixels and traced
        # work (main.cc:378-388). Under chunked accumulation both advance
        # together; the second reports ray-segment throughput.
        mrays = (
            progress.segments_traced / progress.elapsed_s / 1e6
            if progress.elapsed_s > 0
            else 0.0
        )
        out.append(
            f"Pixels   {_bar(progress.fraction)} "
            f"({progress.pixels_raytraced}/{progress.pixels_count})\x1b[0K\n"
        )
        out.append(
            f"Samples  {_bar(progress.fraction)} "
            f"({progress.samples_done}/{progress.samples_total} spp)\x1b[0K\n"
        )
        out.append(
            f"Elapsed  {progress.elapsed_s:8.2f} s    "
            f"{mrays:9.1f} Mrays/s    "
            f"{progress.segments_traced:,} segments\x1b[0K\n"
        )
        self.stream.write("".join(out))
        self.stream.flush()
        self._frames += 1


class FileSequenceDisplay:
    """Writes ``preview_NNNN.png`` per progress event (headless viewer)."""

    def __init__(self, out_dir: str, *, every: int = 1) -> None:
        self.out_dir = out_dir
        self.every = max(1, every)
        self._count = 0
        os.makedirs(out_dir, exist_ok=True)

    def __call__(self, progress: RenderProgress) -> None:
        self._count += 1
        if (self._count - 1) % self.every:
            return
        from ..utils import png

        path = os.path.join(self.out_dir, f"preview_{self._count:04d}.png")
        png.write_png(path, progress.preview())
