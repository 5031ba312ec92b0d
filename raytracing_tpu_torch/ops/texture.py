"""Albedo textures: checker and image, in plain torch.

Counterpart of ``raytracing_tpu/ops/texture.py``:

- checker: ``floor(inv_scale * p)`` per axis at the 3D hit point; the
  parity of the sum picks the even or odd color;
- sphere UV of the outward unit normal ``n``: ``theta = acos(-n.y)``,
  ``phi = atan2(-n.z, n.x) + pi``, ``u = phi / 2pi``, ``v = theta / pi``;
- image: clamp u, v to [0, 1], nearest texel ``i = u * W``,
  ``j = (1 - v) * H`` (clamped to the last texel).

``atan2`` and ``acos`` are the JAX package's polynomials, in the same
operation order, not libm: the regeneration kernel's plain version
(``ops/trace.py``) and the CUDA kernel (``csrc/regen.cu``) share them, as
the JAX kernel shares them with its XLA path.
"""

from __future__ import annotations

import torch

from ..scene.types import Scene, TextureKind

TWO_PI = 6.283185307179586
PI = 3.141592653589793
_HALF_PI = 1.5707963267948966

# atan(t)/t as a degree-7 polynomial in s = t^2 on [0, 1] (max abs error
# 2.9e-7 rad); the JAX package's coefficients.
ATAN_COEF = (
    0.9999999228, -0.3333223262, 0.1997402858, -0.1404782123,
    0.1000220526, -0.06087448222, 0.02533170106, -0.005021063911,
)


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Elementwise atan2 via octant reduction + polynomial."""
    ax = x.abs()
    ay = y.abs()
    hi = torch.maximum(ax, ay)
    lo = torch.minimum(ax, ay)
    t = lo / torch.clamp(hi, min=1e-30)
    s = t * t
    p = torch.full_like(s, ATAN_COEF[-1])
    for c in ATAN_COEF[-2::-1]:
        p = p * s + c
    r = p * t
    r = torch.where(ay > ax, _HALF_PI - r, r)
    r = torch.where(x < 0.0, PI - r, r)
    return torch.where(y < 0.0, -r, r)


def acos(x: torch.Tensor) -> torch.Tensor:
    """Elementwise acos in [0, pi] via ``atan2``."""
    xc = torch.clamp(x, -1.0, 1.0)
    return atan2(torch.sqrt(torch.clamp(1.0 - xc * xc, min=0.0)), xc)


def sphere_uv(outward_normal: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Outward unit normals ``(B, 3)`` -> (u, v) each ``(B,)`` in [0, 1]."""
    n = outward_normal
    theta = acos(-n[..., 1])
    phi = atan2(-n[..., 2], n[..., 0]) + PI
    return phi / TWO_PI, theta / PI


def checker_select(p: torch.Tensor, inv_scale: torch.Tensor) -> torch.Tensor:
    """``(B,)`` bool: True where the 3D checker at hit points ``p`` is odd."""
    xi = torch.floor(inv_scale[..., None] * p)
    s = xi[..., 0] + xi[..., 1] + xi[..., 2]
    # s/2 has a fractional part iff s is odd (exact for |s| < 2^23).
    half = s * 0.5
    return half != torch.floor(half)


def image_texel(
    textures: torch.Tensor,
    tex_id: torch.Tensor,
    tex_wh: torch.Tensor,
    u: torch.Tensor,
    v: torch.Tensor,
) -> torch.Tensor:
    """Nearest-texel fetch ``(B, 3)`` from the padded texture stack;
    ``tex_wh`` is each texture's valid (width, height) in the stack."""
    w = tex_wh[..., 0].to(torch.float32)
    h = tex_wh[..., 1].to(torch.float32)
    uu = torch.clamp(u, 0.0, 1.0)
    vv = torch.clamp(v, 0.0, 1.0)
    i = torch.minimum(torch.floor(uu * w), w - 1.0).to(torch.int64)
    j = torch.minimum(torch.floor((1.0 - vv) * h), h - 1.0).to(torch.int64)
    i = torch.clamp(i, min=0)
    j = torch.clamp(j, min=0)
    return textures[tex_id.long(), j, i]


def surface_albedo(
    scene: Scene,
    idx: torch.Tensor,
    p: torch.Tensor,
    outward_normal: torch.Tensor,
) -> torch.Tensor:
    """Per-hit albedo ``(B, 3)``: solid color, checker, or image texel, for
    hit sphere indices ``idx``, hit points ``p`` and outward unit normals."""
    base = scene.albedo[idx]
    tk = scene.tex_kind[idx]
    odd = checker_select(p, scene.tex_inv_scale[idx])
    checker = torch.where(odd[..., None], scene.albedo2[idx], base)
    u, v = sphere_uv(outward_normal)
    texel = image_texel(
        scene.textures, scene.tex_id[idx], scene.tex_wh[idx], u, v
    )
    albedo = torch.where((tk == TextureKind.CHECKER)[..., None], checker, base)
    return torch.where((tk == TextureKind.IMAGE)[..., None], texel, albedo)
