"""Material scattering of the wavefront backend: every model computed,
then selected by material kind.

Counterpart of ``raytracing_tpu/ops/scatter.py``, the same operations in
the same order:

- Lambertian: ``normal + unit_vector``, the normal where that is near
  zero; always scatters.
- Metallic: the incoming direction reflected about the normal, normalised,
  plus ``fuzz * unit_vector``; absorbed where the result points below the
  surface.
- Dielectric: ``eta = 1/ior`` on the front face, else ``ior``; reflect on
  total internal reflection or where Schlick's reflectance exceeds the
  uniform draw, else refract. Always scatters.

Attenuation is the albedo (the scene packs 1 for dielectrics). Origins are
the integrator's business (``models/integrator.py``'s ``SELF_HIT_OFFSET``).
"""

from __future__ import annotations

import torch

from ..core import math as rmath
from ..scene.types import MaterialKind


def scatter(
    directions: torch.Tensor,
    normals: torch.Tensor,
    front_face: torch.Tensor,
    mat_kind: torch.Tensor,
    albedo: torch.Tensor,
    fuzz: torch.Tensor,
    ior: torch.Tensor,
    unit_vec: torch.Tensor,
    urand: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scatter a batch of rays off their hit surfaces.

    ``directions`` (B, 3) incoming, unnormalised; ``normals`` (B, 3) unit
    and facing the ray; ``front_face`` (B,) bool; ``mat_kind`` / ``albedo``
    / ``fuzz`` / ``ior`` the hit's material, (B,) / (B, 3) / (B,) / (B,);
    ``unit_vec`` (B, 3) this bounce's unit-sphere sample, ``urand`` (B,)
    its uniform draw. Returns ``(new_direction (B, 3), attenuation (B, 3),
    scattered (B,) bool)``; ``scattered`` is False where a metal absorbed
    the ray.
    """
    lam_dir = normals + unit_vec
    lam_dir = torch.where(rmath.near_zero(lam_dir)[..., None], normals,
                          lam_dir)

    reflected = rmath.reflect(directions, normals)
    met_dir = (rmath.normalize(reflected, eps=1.0e-20)
               + fuzz[..., None] * unit_vec)
    met_ok = rmath.dot(met_dir, normals) > 0.0

    eta = torch.where(front_face, 1.0 / ior, ior)
    unit_dir = rmath.normalize(directions, eps=1.0e-20)
    cos_theta = torch.clamp(rmath.dot(-unit_dir, normals), max=1.0)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    cannot_refract = (eta * sin_theta) > 1.0
    r0 = (1.0 - eta) / (1.0 + eta)
    r0 = r0 * r0
    # x**5 as JAX's integer_pow multiplies it: x * ((x * x) * (x * x)).
    x = 1.0 - cos_theta
    x2 = x * x
    schlick = r0 + (1.0 - r0) * (x * (x2 * x2))
    reflect_choice = cannot_refract | (schlick > urand)
    die_dir = torch.where(
        reflect_choice[..., None],
        rmath.reflect(unit_dir, normals),
        rmath.refract(unit_dir, normals, eta),
    )

    is_lam = (mat_kind == MaterialKind.LAMBERTIAN)[..., None]
    is_met = (mat_kind == MaterialKind.METALLIC)[..., None]
    new_dir = torch.where(is_lam, lam_dir,
                          torch.where(is_met, met_dir, die_dir))
    scattered = torch.where(mat_kind == MaterialKind.METALLIC, met_ok,
                            torch.ones_like(met_ok))
    return new_dir, albedo, scattered
