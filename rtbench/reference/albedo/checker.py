"""The checker albedo of spheres whose texture kind is 1 (raytracing_tpu_torch
at commit a1403821e8fd, ``ops/trace.py::_textured_albedo``'s checker
branch, ``ops/texture.py::checker_select``): the odd cells of a lattice of
``1 / scale`` take the second albedo."""

from __future__ import annotations

import torch

CHECKER = 1


def albedo(t, row, point, rgb):
    s = t.sph
    xi = torch.floor(s.tex_inv[row][..., None] * torch.stack(point, dim=-1))
    half = (xi[..., 0] + xi[..., 1] + xi[..., 2]) * 0.5
    odd = (s.tex_kind[row] == CHECKER) & (half != torch.floor(half))
    return tuple(torch.where(odd, c2[row], c1)
                 for c1, c2 in zip(rgb, s.albedo2))
