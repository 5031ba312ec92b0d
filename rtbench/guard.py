"""The run's check that nothing it loaded is JAX or the JAX package.

Module names are compared by their top-level name (the part before the
first dot) whole: ``raytracing_tpu_torch`` is the program under test, and
``raytracing_tpu`` the JAX package it was ported from, which a run never
loads."""

from __future__ import annotations

FORBIDDEN = ("jax", "jaxlib", "flax", "raytracing_tpu")


def forbidden_modules(names) -> list[str]:
    """The loaded module names whose top-level name is forbidden."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
