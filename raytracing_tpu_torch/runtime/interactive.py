"""Interactive rendering session: keyboard camera control on the terminal.

Counterpart of ``raytracing_tpu/runtime/interactive.py``: a key-binding
table maps raw keystrokes to camera actions on an orbit rig, every pose
change re-points the renderer's camera, and every frame is presented as
ANSI half-blocks (``runtime/display.py``). While the camera is idle, each
frame folds more samples into the held pose (converge-while-interactive):
the presented image is always the mean over every sample drawn there,
byte-equal to a one-shot render at that many samples.

Controls:  a/d orbit  w/s elevate  +/- zoom  r reset  ESC or x quit.

The session logic is split from the TTY plumbing, so tests drive
``handle_key`` and ``step`` directly. ``device`` picks the card ("cuda",
the default) or the plain version ("cpu"); ``backend`` the renderer's
("auto" / "pallas": the frame API, one kernel launch a frame; "xla": the
wavefront, whose idle frames accumulate through ``render(resume=True)``
and whose pose changes reseed the renderer with its own seed).
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time

import numpy as np
import torch

from ..core import camera as rcamera
from . import display as rdisplay
from .renderer import Renderer, RenderProgress

ESC = "\x1b"


@dataclasses.dataclass
class OrbitState:
    """Spherical camera rig around the look-at point."""

    azimuth: float          # radians around +y
    elevation: float        # radians above the horizon
    distance: float
    lookat: tuple[float, float, float]

    def lookfrom(self) -> tuple[float, float, float]:
        cx, cy, cz = self.lookat
        ce = math.cos(self.elevation)
        return (
            cx + self.distance * ce * math.cos(self.azimuth),
            cy + self.distance * math.sin(self.elevation),
            cz + self.distance * ce * math.sin(self.azimuth),
        )


def _orbit_from_params(params: rcamera.CameraParameters) -> OrbitState:
    lf = np.asarray(params.lookfrom, np.float64)
    la = np.asarray(params.lookat, np.float64)
    v = lf - la
    dist = float(np.linalg.norm(v))
    return OrbitState(
        azimuth=math.atan2(v[2], v[0]),
        elevation=math.asin(float(v[1]) / max(dist, 1e-9)),
        distance=dist,
        lookat=tuple(float(x) for x in la),
    )


class HostCopies:
    """Device->host copies queued behind the work that produced them, into a
    ring of ``depth`` pinned buffers: ``stage`` returns at once, ``wait``
    (on any thread) blocks until that copy landed. A blocking ``.cpu()`` on
    a worker thread would queue its copy behind whatever the main thread
    launched since, serialising the overlap a pipeline exists for. A buffer
    is reused ``depth`` stages later: keep at most ``depth - 1`` staged
    copies unwaited. CPU tensors pass through."""

    def __init__(self, depth: int) -> None:
        self._bufs: list[torch.Tensor | None] = [None] * max(int(depth), 1)
        self._next = 0

    def stage(self, t: torch.Tensor):
        if t.device.type != "cuda":
            return t, None
        i = self._next
        self._next = (i + 1) % len(self._bufs)
        buf = self._bufs[i]
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = self._bufs[i] = torch.empty(
                t.shape, dtype=t.dtype, pin_memory=True
            )
        buf.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(t.device))
        return buf, event

    @staticmethod
    def wait(staged) -> np.ndarray:
        """The staged tensor's values, as a numpy array of its own."""
        host, event = staged
        if event is not None:
            event.synchronize()
        return host.numpy().copy()


class InteractiveSession:
    """Progressive renderer + key-driven camera on the terminal."""

    AZ_STEP = math.radians(6.0)
    EL_STEP = math.radians(4.0)
    ZOOM = 1.12
    MAX_ELEV = math.radians(85.0)

    def __init__(
        self,
        scene,
        params: rcamera.CameraParameters,
        *,
        seed: int = 0,
        device="cuda",
        backend: str = "auto",
        spp: int | None = None,
        converge_spp: int | None = None,
        pipeline: int = 0,
        stream=None,
    ) -> None:
        self.params = params
        self.renderer = Renderer(scene, params, seed=seed, device=device,
                                 backend=backend)
        self.spp = int(spp if spp is not None else params.samples_per_pixel)
        # While the camera is idle every frame accumulates more samples at
        # the held pose until ``converge_spp``; motion resets the
        # accumulation. At least one frame's worth: a target <= 0 would
        # take the converged branch before any image exists.
        self.converge_spp = (
            int(converge_spp) if converge_spp is not None
            else max(64, self.spp)
        )
        self.converge_spp = max(self.converge_spp, self.spp, 1)
        self.orbit = _orbit_from_params(params)
        self._orbit0 = dataclasses.replace(self.orbit)
        self._last_pose: tuple | None = None
        self._idle_chunk = self.spp
        self._last_img: np.ndarray | None = None
        # The newest dispatched frame's u8 image on the device (slots, or
        # [H, W, 3] for xla; ``renderer.fetch_image(session.last_frame)``).
        self.last_frame: torch.Tensor | None = None
        # ``pipeline`` frames in flight: the main thread queues each
        # preview's copy to host memory behind its frame's launch
        # (``HostCopies``); a worker thread waits for it and presents while
        # the next frame's launch proceeds. 0 = synchronous.
        self.pipeline = max(int(pipeline), 0)
        self._pool = None
        self._pending: list = []
        self._copies = HostCopies(self.pipeline + 1)
        if self.pipeline > 0:
            import concurrent.futures

            self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self.display = rdisplay.TerminalDisplay(stream=stream)
        self.frames_rendered = 0
        self.quit = False
        self._t0 = time.perf_counter()
        self.bindings = {
            "a": self._yaw_left, "d": self._yaw_right,
            "w": self._pitch_up, "s": self._pitch_down,
            "+": self._zoom_in, "=": self._zoom_in,
            "-": self._zoom_out,
            "r": self._reset,
            "x": self._quit, "X": self._quit, ESC: self._quit,
        }

    # -- actions --------------------------------------------------------------
    def _yaw_left(self):
        self.orbit.azimuth -= self.AZ_STEP

    def _yaw_right(self):
        self.orbit.azimuth += self.AZ_STEP

    def _pitch_up(self):
        self.orbit.elevation = min(
            self.orbit.elevation + self.EL_STEP, self.MAX_ELEV
        )

    def _pitch_down(self):
        self.orbit.elevation = max(
            self.orbit.elevation - self.EL_STEP, -self.MAX_ELEV
        )

    def _zoom_in(self):
        self.orbit.distance = max(self.orbit.distance / self.ZOOM, 0.05)

    def _zoom_out(self):
        self.orbit.distance *= self.ZOOM

    def _reset(self):
        self.orbit = dataclasses.replace(self._orbit0)

    def _quit(self):
        self.quit = True

    # -- loop body ------------------------------------------------------------
    def handle_key(self, key: str) -> None:
        """Dispatch one keystroke (unbound keys are ignored)."""
        action = self.bindings.get(key)
        if action is not None:
            action()

    @property
    def samples_at_pose(self) -> int:
        """Samples accumulated at the current camera pose."""
        if self.renderer.backend == "pallas":
            return self.renderer.frame_accum_samples
        return self.renderer.samples_done

    @property
    def converged(self) -> bool:
        return self.samples_at_pose >= self.converge_spp

    def step(self, keys: str = "") -> np.ndarray | None:
        """Process pending keystrokes, render + present ONE frame.

        With ``pipeline > 0`` the returned image is the newest PRESENTED
        frame, which lags the launches by up to ``pipeline`` frames (None
        until one is presented; ``flush()`` drains).

        Moving frames re-point the camera and restart the accumulation;
        idle frames fold more samples into the held pose's running sums
        (after k idle frames the image is the one-shot render's at the
        accumulated spp, byte for byte). Once ``converge_spp`` is reached,
        idle frames re-present the converged image without a launch."""
        for k in keys:
            self.handle_key(k)
        pose = (
            self.orbit.azimuth, self.orbit.elevation, self.orbit.distance,
            self.orbit.lookat,
        )
        if pose != self._last_pose:
            self._last_pose = pose
            params = dataclasses.replace(
                self.params, lookfrom=self.orbit.lookfrom(),
                lookat=self.orbit.lookat,
            )
            self.renderer.params = params
            # Derived on the host: the setter then reads no device memory.
            self.renderer.camera = rcamera.derive(params)
            self._idle_chunk = self.spp
            if self.renderer.backend == "pallas":
                self.renderer.frame_accum_reset()
            else:
                # The xla path accumulates through render(resume=True);
                # reseeding with the same seed drops the sums.
                self.renderer.reseed(self.renderer.seed)
        remaining = self.converge_spp - self.samples_at_pose
        if remaining > 0:
            # Idle chunks grow (x2 a consecutive idle frame, capped at 4x
            # the interactive spp): fewer launches to the target, while the
            # first idle frames stay short so a keystroke interrupts
            # quickly. The image does not depend on the chunking.
            cap = max(self.spp, min(self._idle_chunk, 4 * self.spp))
            self._idle_chunk = cap * 2
            chunk = min(cap, remaining)
            if self.renderer.backend == "pallas":
                img = self._frame(chunk)
            else:
                # The wavefront: a synchronous resumed render, presented
                # whole (no frame API, no pipeline).
                total = self.samples_at_pose + chunk
                self.last_frame = self.renderer.render(
                    spp=total, resume=True, as_device_array=True)
                img = self.renderer.fetch_image(self.last_frame)
                self._present(img, total)
                self._last_img = img
        else:
            img = self.flush()
            self._present(img, self.samples_at_pose)
        self.frames_rendered += 1
        return img

    def _frame(self, chunk: int) -> np.ndarray | None:
        """One accumulating kernel frame of ``chunk`` samples; its preview
        presented now, or on the pipeline's worker."""
        dev, prev, total = self.renderer.render_frame_accum_preview(
            spp=chunk
        )
        self.last_frame = dev
        if self._pool is None:
            return self._emit((prev.cpu(), None), total)
        # Read before the submit: the worker may present this frame before
        # the main thread reads on, and the frame returned must not depend
        # on that race.
        img = self._last_img
        staged = self._copies.stage(prev)
        self._pending.append(self._pool.submit(self._emit, staged, total))
        while len(self._pending) > self.pipeline:
            img = self._pending.pop(0).result()
        return img

    def flush(self) -> np.ndarray | None:
        """Drain any in-flight pipelined frames; returns the newest
        presented image."""
        while self._pending:
            self._last_img = self._pending.pop(0).result()
        return self._last_img

    def _emit(self, staged, total: int) -> np.ndarray:
        """Wait for a staged preview and present it labelled with the
        sample count it holds. Runs on the pipeline's single worker, so
        presentation stays ordered."""
        img = HostCopies.wait(staged)
        self._present(img, total)
        self._last_img = img
        return img

    def _present(self, img: np.ndarray, samples: int) -> None:
        self.display(
            RenderProgress(
                samples_done=samples,
                samples_total=self.converge_spp,
                pixels_count=self.renderer.pixels_count,
                # Never waits on a launch still running.
                segments_traced=self.renderer.segments_traced_ready,
                elapsed_s=time.perf_counter() - self._t0,
                _preview=lambda im=img: im,
            )
        )
        self.display.stream.write(
            f"converge {samples}/{self.converge_spp} spp  "
            "keys: a/d orbit  w/s elevate  +/- zoom  r reset  "
            "ESC/x quit\x1b[0K\n"
        )
        self.display.stream.flush()

    def run(self, max_frames: int | None = None) -> int:
        """TTY event loop: raw keyboard, render until quit.

        Returns the number of frames rendered. Falls back to a fixed-frame
        non-interactive loop when stdin is not a terminal.
        """
        frames = 0
        if not sys.stdin.isatty():
            n = max_frames if max_frames is not None else 1
            while frames < n and not self.quit:
                self.step()
                frames += 1
            self.flush()
            return frames

        import select
        import termios
        import tty

        fd = sys.stdin.fileno()
        old = termios.tcgetattr(fd)
        try:
            tty.setcbreak(fd)
            while not self.quit and (
                max_frames is None or frames < max_frames
            ):
                keys = []
                while select.select([sys.stdin], [], [], 0)[0]:
                    keys.append(sys.stdin.read(1))
                self.step("".join(keys))
                frames += 1
                if not keys and self.converged:
                    # Converged and idle: nothing to trace; wait briefly
                    # on input instead of spinning re-presents.
                    select.select([sys.stdin], [], [], 0.05)
        except KeyboardInterrupt:
            pass  # Ctrl-C quits
        finally:
            termios.tcsetattr(fd, termios.TCSADRAIN, old)
            self.flush()
        return frames
