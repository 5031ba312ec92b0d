"""The divide probe: how the card rounds an in-kernel reciprocal and
quotient, which the cull gate's margins budget for (``csrc/regen.cu``'s
``safe_inv`` is an IEEE divide).

Counterpart of the JAX package's probe kernel (``scripts/probe_divide.py``:
its kernel computes ``1.0 / x`` and ``num / x``). Modes of the kernel
(``csrc/divide.cu``):

* ``"ieee"``: ``/`` as nvcc compiles it without fast-math (correctly
  rounded), what the megakernel uses;
* ``"rn"``: ``__frcp_rn`` and ``__fdiv_rn`` (correctly rounded);
* ``"fast"``: ``__fdividef`` (about 2 ulp; 0 for 2^126 < |x| < 2^128);
* ``"approx"``: ``rcp.approx.f32``, and ``a * rcp`` for ``a / x``.

* ``inputs`` makes the JAX probe's inputs (the same numpy generator calls
  in the same order), ``edge_inputs`` a small set at the edges of
  ``safe_inv``'s range (its clamp 1e-30, magnitudes near 2^-126 and
  2^126);
* ``divide_reference`` is the plain PyTorch version: the correctly rounded
  ``1 / x`` and ``num / x`` (``torch.reciprocal`` and ``torch.div`` give
  them on every device), the function every mode computes; the ``ieee``
  and ``rn`` modes equal it bit for bit;
* ``ulp_error`` is the JAX probe's ``ulp_err``;
* ``divide`` launches the kernel on CUDA tensors (or raises) and runs the
  plain version on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

MODES = ("ieee", "rn", "fast", "approx")

# Per mode: the kernel's mode id and the launch counter's key.
_MODE_IDS = {m: (i, f"divide_{m}") for i, m in enumerate(MODES)}


def inputs(seed: int = 7):
    """``(x, num)`` f32 [8, 128] of the JAX probe: magnitudes 2^-20..2^20
    of both signs (the first 128 exact powers of two), numerators
    2^-10..2^10."""
    rng = np.random.default_rng(seed)
    exps = rng.uniform(-20, 20, size=8 * 128).astype(np.float32)
    x = np.ldexp(rng.uniform(1.0, 2.0, size=8 * 128).astype(np.float32),
                 exps.astype(np.int32))
    x *= rng.choice([-1.0, 1.0], size=x.shape).astype(np.float32)
    x[:128] = np.ldexp(np.float32(1.0), rng.integers(-20, 20, 128))
    x = x.reshape(8, 128).astype(np.float32)
    num = np.ldexp(rng.uniform(1.0, 2.0, size=(8, 128)).astype(np.float32),
                   rng.integers(-10, 10, (8, 128)))
    num = num.astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(num)


def edge_inputs():
    """``(x, num)`` f32 [20]: the edges of ``safe_inv``'s range, each with
    both signs: its clamp 1e-30, the smallest normal 2^-126 and its
    neighbours (which the clamp lifts to 1e-30, and other divides of the
    megakernel can meet), and magnitudes from 2^125 to the largest finite
    float (quotients near 2^-126 and below); numerators 1 and 1.5 in
    turn."""
    mags = np.array([1e-30, 2.0 ** -126, 1.5 * 2.0 ** -126, 2.0 ** -125,
                     2.0 ** 125, 2.0 ** 126, 1.5 * 2.0 ** 126, 2.0 ** 127,
                     1.5 * 2.0 ** 127, float(np.finfo(np.float32).max)],
                    np.float64)
    x = np.concatenate([mags, -mags]).astype(np.float32)
    num = np.where(np.arange(x.size) % 2 == 0, 1.0, 1.5).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(num)


def ulp_error(got: np.ndarray, want64: np.ndarray) -> np.ndarray:
    """|got - want| in units of the last place of want rounded to f32
    (the JAX probe's ``ulp_err``)."""
    want = want64.astype(np.float32)
    ulp = np.spacing(np.abs(want)).astype(np.float64)
    return np.abs(got.astype(np.float64) - want64) / ulp


def _check(x, num, mode):
    if mode not in _MODE_IDS:
        raise ValueError(f"unknown divide mode {mode!r}")
    if x.dtype != torch.float32 or num.dtype != torch.float32:
        raise TypeError("x and num must be float32")
    if x.shape != num.shape or x.numel() == 0:
        raise ValueError("x and num must have one non-empty shape")
    if x.device != num.device:
        raise ValueError(f"x is on {x.device}, num on {num.device}")


def divide_reference(x: torch.Tensor, num: torch.Tensor, mode: str = "ieee"):
    """``(1 / x, num / x)``, correctly rounded (every mode's function)."""
    _check(x, num, mode)
    return torch.reciprocal(x), torch.div(num, x)


def divide(x: torch.Tensor, num: torch.Tensor, mode: str = "ieee"):
    """``(recip, quot)`` of ``x`` and ``num`` in ``mode``: CUDA tensors
    launch ``csrc/divide.cu`` (or raise), CPU tensors run the plain
    version."""
    _check(x, num, mode)
    if x.is_cuda:
        return _launch_cuda(x, num, mode)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return divide_reference(x, num, mode)


def _launch_cuda(x, num, mode):
    # Two empty_like calls cost the host less than one allocation cut into
    # two views (measured on the card's host); the allocator aligns each
    # block, so the kernel's 16-byte body runs wherever x and num are
    # 16-byte aligned too (any other 4-byte aligned pointer takes its
    # 4-byte body).
    if not (x.is_contiguous() and num.is_contiguous()):
        raise ValueError("x and num must be contiguous")
    recip = torch.empty_like(x)
    quot = torch.empty_like(x)
    mode_id, key = _MODE_IDS[mode]
    _build.launch("divide", "rt_divide_launch", x.device, x.data_ptr(),
                  num.data_ptr(), recip.data_ptr(), quot.data_ptr(),
                  x.numel(), mode_id, count=key)
    return recip, quot
