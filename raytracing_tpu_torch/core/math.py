"""Vector math primitives of the wavefront backend.

Counterpart of ``raytracing_tpu/core/math.py``: a "vec3" is a tensor whose
last axis has size 3, and every function works on any leading batch shape.
The operations and their order are the JAX package's, so both packages
round alike wherever the hardware does (XLA-CPU may fuse a multiply and an
add into one FMA where torch rounds each).
"""

from __future__ import annotations

import torch

# Hit interval (t_min, t_max): the reference traces with t in [1e-4, inf).
T_MIN: float = 1.0e-4
T_MAX: float = float("inf")

NEAR_ZERO_EPS: float = 1.0e-8


def sum3(x: torch.Tensor) -> torch.Tensor:
    """``x[..., 0] + x[..., 1] + x[..., 2]`` in that order (XLA's order for
    a reduction over a trailing axis of 3; ``torch.sum``'s is unspecified)."""
    return x[..., 0] + x[..., 1] + x[..., 2]


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the trailing axis of 3 (dropped)."""
    return sum3(a * b)


def length_sq(v: torch.Tensor) -> torch.Tensor:
    return sum3(v * v)


def normalize(v: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Unit vector along ``v``: ``v * rsqrt(|v|^2)``; with ``eps > 0`` the
    squared norm is clamped to at least ``eps``, so a zero vector gives a
    finite result."""
    n2 = sum3(v * v)[..., None]
    if eps:
        n2 = torch.clamp(n2, min=eps)
    return v * torch.rsqrt(n2)


def near_zero(v: torch.Tensor) -> torch.Tensor:
    """True where every component's magnitude is below 1e-8."""
    return torch.all(torch.abs(v) < NEAR_ZERO_EPS, dim=-1)


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror ``v`` about the unit normal ``n`` (glm::reflect)."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(uv: torch.Tensor, n: torch.Tensor, eta) -> torch.Tensor:
    """Snell refraction of the unit vector ``uv`` about the unit normal
    ``n``; ``eta`` (incident over transmitted index) broadcasts over the
    batch."""
    eta = torch.as_tensor(eta, dtype=uv.dtype, device=uv.device)[..., None]
    cos_theta = torch.clamp(dot(-uv, n), max=1.0)[..., None]
    r_out_perp = eta * (uv + cos_theta * n)
    k = 1.0 - sum3(r_out_perp * r_out_perp)[..., None]
    r_out_parallel = -torch.sqrt(torch.abs(k)) * n
    return r_out_perp + r_out_parallel


def point_at_param(origin: torch.Tensor, direction: torch.Tensor,
                   t: torch.Tensor) -> torch.Tensor:
    """``origin + t * direction``."""
    return origin + t[..., None] * direction


def lerp(a, b, t):
    return (1.0 - t) * a + t * b
