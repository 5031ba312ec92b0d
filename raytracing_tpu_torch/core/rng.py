"""Counter-based RNG of the wavefront backend: threefry2x32 keys.

Counterpart of ``raytracing_tpu/core/rng.py``, reproducing what JAX's
default PRNG computes (``jax.random`` with the ``threefry2x32``
implementation and ``jax_threefry_partitionable=True``), with no JAX:

* a key is a ``(..., 2)`` int64 tensor holding two uint32 words;
  ``key(seed)`` is ``jax.random.key(seed)``'s data, ``(0, seed)``;
* ``fold_in(k, d)`` is ``threefry2x32(k, (0, d))``;
* the 32-bit random bits of a draw of ``n`` values are, for counter ``i``,
  ``y0 ^ y1`` of ``threefry2x32(k, (0, i))``;
* ``uniform``: the bits' top 23 as the mantissa of a float in [1, 2),
  minus 1, scaled to ``[minval, maxval)`` and clamped below at ``minval``;
* ``normal``: ``sqrt(2) * erfinv(u)`` with ``u`` uniform in
  ``[nextafter(-1, 0), 1)`` and ``erfinv`` XLA's single-precision
  polynomial (Giles' two branches on ``w = -log1p(-x^2)``).

Integer words, ``fold``, ``ray_keys``, ``uniform``, ``uniform3`` and
``sample_square`` give JAX's bits. ``normal`` and so ``unit_vector``, and
``in_unit_disk``, go through ``log1p``, ``sqrt``, ``sin``, ``cos`` and
``rsqrt``, whose last bits differ between torch and XLA (the tests measure
the ulps).

Every draw is a pure function of ``(seed, global ray id, stream tag
[, bounce])``, so a render is the same whatever its chunking or sharding.
Words are masked to 32 bits after every add and rotation (int64 holds
them without sign trouble: torch's ``>>`` on int32 is arithmetic).
"""

from __future__ import annotations

import numpy as np
import torch

# Stream tags: distinct sub-streams drawn from one per-ray key.
STREAM_CAM_JITTER = 0  # pixel-footprint jitter
STREAM_CAM_DISK = 1    # defocus-disk lens sample
STREAM_UNIT_VEC = 2    # scatter unit vector
STREAM_SCHLICK = 3     # dielectric reflectance coin flip

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

# XLA's ErfInv for float32: coefficients for w < 5 and w >= 5.
_ERFINV_LT5 = (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941,
)
_ERFINV_GE5 = (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682,
)
_SQRT2 = float(np.float32(np.sqrt(2.0)))
# jax.random.normal's lower bound: nextafter(-1, 0) in float32.
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_TWO_PI = float(np.float32(2.0 * np.pi))


def key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.key(seed)``'s data: the pair ``(0, seed mod 2^32)``
    for a seed in [-2^31, 2^32)."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 32):
        raise ValueError(f"seed {seed} is outside [-2^31, 2^32)")
    return torch.tensor([0, seed & _M32], dtype=torch.int64, device=device)


def threefry2x32(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block function (20 rounds) on int64 tensors of
    uint32 words, broadcast together; returns the two output words."""
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) & _M32) | (x1 >> (32 - r))
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def _as_words(data, device) -> torch.Tensor:
    data = torch.as_tensor(data, device=device)
    return data.to(torch.int64) & _M32


def fold(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` of each key with ``data`` (a scalar or one
    value per key, taken as uint32): ``(..., 2)`` -> ``(..., 2)``."""
    d = _as_words(data, keys.device)
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def ray_keys(base_key: torch.Tensor, global_ids: torch.Tensor) -> torch.Tensor:
    """One key per ray, ``fold_in(base_key, id)``: ``(2,)`` and ``(B,)`` ->
    ``(B, 2)``."""
    return fold(base_key, global_ids)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """The 32-bit words of a draw of ``n`` values from each key
    (``jax.random.bits`` of shape ``(n,)``, or ``()`` for ``n == 1``):
    ``(..., 2)`` -> ``(..., n)`` int64 in [0, 2^32)."""
    counts = torch.arange(n, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(
        keys[..., 0, None], keys[..., 1, None], torch.zeros_like(counts),
        counts,
    )
    return y0 ^ y1


def _f32(x: float) -> float:
    return float(np.float32(x))


def _bits_to_uniform(bits: torch.Tensor, minval: float,
                     maxval: float) -> torch.Tensor:
    """``jax.random.uniform``'s float32 map of 32-bit words."""
    lo, hi = _f32(minval), _f32(maxval)
    span = float(np.float32(hi) - np.float32(lo))
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    return torch.clamp(floats * span + lo, min=lo)


def uniform(keys: torch.Tensor, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """Per-key scalar in ``[minval, maxval)``: ``(..., 2)`` -> ``(...)``."""
    return _bits_to_uniform(random_bits(keys, 1)[..., 0], minval, maxval)


def uniform3(keys: torch.Tensor, minval: float = 0.0,
             maxval: float = 1.0) -> torch.Tensor:
    """Per-key ``(3,)`` of independent values in ``[minval, maxval)``."""
    return _bits_to_uniform(random_bits(keys, 3), minval, maxval)


def sample_square(keys: torch.Tensor) -> torch.Tensor:
    """Per-key ``(2,)`` jitter in ``[-0.5, 0.5)^2``."""
    return _bits_to_uniform(random_bits(keys, 2), -0.5, 0.5)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's single-precision ``ErfInv``: a degree-8 polynomial in
    ``w - 2.5`` (w < 5) or ``sqrt(w) - 3`` (w >= 5), ``w = -log1p(-x^2)``,
    times ``x``; +-1 give +-inf. (Not ``torch.erfinv``: another
    algorithm.)"""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(lt, _f32(_ERFINV_LT5[i]), _f32(_ERFINV_GE5[i]))

    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = coef(i) + p * w
    return torch.where(torch.abs(x) == 1.0, x * float("inf"), p * x)


def normal(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.normal`` of shape ``(n,)`` from each key (float32)."""
    u = _bits_to_uniform(random_bits(keys, n), _NORMAL_LO, 1.0)
    return _SQRT2 * erfinv(u)


def unit_vector(keys: torch.Tensor) -> torch.Tensor:
    """Per-key ``(3,)`` uniform direction on the unit sphere: a normalised
    isotropic Gaussian (its squared norm clamped to at least 1e-20)."""
    g = normal(keys, 3)
    n2 = (g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1]
          + g[..., 2] * g[..., 2])
    return g * torch.rsqrt(torch.clamp(n2, min=1.0e-20))[..., None]


def in_unit_disk(keys: torch.Tensor) -> torch.Tensor:
    """Per-key ``(2,)`` point uniform in the unit disk: radius
    ``sqrt(u0)``, angle ``2 pi u1``."""
    u = _bits_to_uniform(random_bits(keys, 2), 0.0, 1.0)
    r = torch.sqrt(u[..., 0])
    theta = _TWO_PI * u[..., 1]
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
