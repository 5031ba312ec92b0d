"""The (px, spp) device mesh of a sharded render.

Counterpart of ``raytracing_tpu/parallel/mesh.py``. A ``Mesh`` is a grid of
devices with two axes:

* ``px``: the image plane split over devices (each holds a contiguous run
  of pixel slots);
* ``spp``: the sample budget split over devices, which trace disjoint
  sample ranges of the same pixels and sum their partial sums.

As in the JAX package, one process drives every device of the mesh: a
shard's work is a launch on its own device from this process, with no
process group. A device may appear more than once (``["cpu"] * 8``, or
``["cuda:0"] * 4`` on one card): the decomposition and the sums are the
same as over distinct devices, the shards then run one after another.
"""

from __future__ import annotations

import dataclasses

import torch

AXIS_PIXELS = "px"
AXIS_SAMPLES = "spp"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(px, spp)`` grid of ``torch.device``s: ``devices[p][s]`` runs
    pixel shard ``p``'s sample shard ``s``."""

    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict[str, int]:
        return {AXIS_PIXELS: len(self.devices),
                AXIS_SAMPLES: len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    @property
    def first(self) -> torch.device:
        """The device of pixel shard 0, sample shard 0: where the mesh's
        gathered results live."""
        return self.devices[0][0]


def _canonical(device) -> torch.device:
    """``device`` with its index: "cuda" is the current CUDA device."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(devices: list | None = None, *, sample_axis: int = 1) -> Mesh:
    """A ``(px, spp)`` mesh over ``devices`` (default: every CUDA device;
    without CUDA this raises, it never falls back to the CPU). The first
    ``sample_axis`` devices form pixel shard 0's sample shards, and so on;
    ``sample_axis`` must divide the device count."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() needs CUDA devices (torch.cuda.is_available() "
                "is False); pass devices= to build a mesh of other devices"
            )
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_canonical(d) for d in devices]
    n = len(devices)
    if sample_axis < 1 or n == 0 or n % sample_axis != 0:
        raise ValueError(
            f"sample_axis={sample_axis} must divide device count {n}"
        )
    rows = tuple(
        tuple(devices[p * sample_axis:(p + 1) * sample_axis])
        for p in range(n // sample_axis)
    )
    return Mesh(rows)
