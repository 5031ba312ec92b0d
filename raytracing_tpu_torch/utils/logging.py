"""Structured logging (copy of ``raytracing_tpu/utils/logging.py``).

``setup(log_dir)`` installs a file handler named after the run's start time
(``raytracer_YYYYmmdd_HHMMSS.log``) plus an optional console handler; the
line format is time with ms, thread id, source file:line, level, message.
Records pass through a QueueHandler/QueueListener pair, so formatting and
IO happen on a background thread and log calls never block on disk.
``get_logger(name)`` returns a logger under the package root.
"""

from __future__ import annotations

import atexit
import datetime
import logging
import logging.handlers
import os
import queue
import sys

_ROOT_NAME = "raytracing_tpu_torch"
_PATTERN = (
    "[%(asctime)s.%(msecs)03d] [t:%(thread)d] [%(filename)s:%(lineno)d] "
    "%(levelname)s: %(message)s"
)
_DATEFMT = "%H:%M:%S"

_listener: logging.handlers.QueueListener | None = None


def get_logger(name: str | None = None) -> logging.Logger:
    """Module logger under the framework root (``g_logger`` analog)."""
    if name is None:
        return logging.getLogger(_ROOT_NAME)
    return logging.getLogger(f"{_ROOT_NAME}.{name}")


def setup(
    log_dir: str | None = None,
    *,
    level: int = logging.DEBUG,
    console: bool = False,
    console_level: int = logging.INFO,
) -> str | None:
    """Install the async file (+ optional console) logging backend.

    Args:
      log_dir: directory for the timestamped log file (created if missing);
        ``None`` disables the file sink (console only, if enabled).
      level: file sink level (the reference logs at Debug, ``main.cc:815``).
      console: also mirror records to stderr (present but commented out in
        the reference, ``main.cc:798`` -- opt-in here).

    Returns the log file path (or None).
    """
    global _listener
    root = logging.getLogger(_ROOT_NAME)
    root.setLevel(min(level, console_level) if console else level)
    teardown()

    handlers: list[logging.Handler] = []
    path = None
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
        path = os.path.join(log_dir, f"raytracer_{stamp}.log")
        fh = logging.FileHandler(path, mode="w", encoding="utf-8")
        fh.setLevel(level)
        fh.setFormatter(logging.Formatter(_PATTERN, datefmt=_DATEFMT))
        handlers.append(fh)
    if console:
        ch = logging.StreamHandler(sys.stderr)
        ch.setLevel(console_level)
        ch.setFormatter(logging.Formatter("%(levelname)s: %(message)s"))
        handlers.append(ch)

    if handlers:
        q: queue.Queue = queue.Queue(-1)
        root.addHandler(logging.handlers.QueueHandler(q))
        _listener = logging.handlers.QueueListener(
            q, *handlers, respect_handler_level=True
        )
        _listener.start()
        atexit.register(teardown)
    return path


def teardown() -> None:
    """Stop the backend thread and detach handlers (idempotent)."""
    global _listener
    root = logging.getLogger(_ROOT_NAME)
    if _listener is not None:
        try:
            _listener.stop()
        except Exception:
            pass
        _listener = None
    for h in list(root.handlers):
        root.removeHandler(h)
