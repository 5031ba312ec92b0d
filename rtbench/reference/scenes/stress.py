"""The procedural stress scene (raytracing_tpu_torch at commit
22b7b5f1dcb6, ``scene/config.py::make_world_stress`` with the
``scene/types.py`` ``add_*_sphere`` field values): a lambertian ground
sphere, then ``n_spheres - 1`` small spheres jittered on a square grid of
``ceil(sqrt(n_spheres - 1))`` a side, each drawn from
``numpy.random.default_rng(seed)`` in the same order (offsets, radius,
material, then the material's own draws), 70/20/10 lambertian, metal and
glass, as the configuration's ``scene`` entry (``n_spheres``, ``seed``)
sets them. No triangles."""

from __future__ import annotations

import numpy as np

from rtbench.reference.scene import DIELECTRIC, LAMBERTIAN, METALLIC, Spheres


def build(config: dict):
    sc = config["scene"]
    n = int(sc["n_spheres"])
    rng = np.random.default_rng(int(sc["seed"]))
    s = Spheres()
    s.add((0.0, -1000.0, 0.0), 1000.0, LAMBERTIAN, (0.5, 0.5, 0.5))
    side = int(np.ceil(np.sqrt(max(n - 1, 1))))
    placed = 0
    for i in range(side):
        for j in range(side):
            if placed >= n - 1:
                break
            x = (i - side / 2) * 1.2 + rng.uniform(-0.4, 0.4)
            z = (j - side / 2) * 1.2 + rng.uniform(-0.4, 0.4)
            r = rng.uniform(0.15, 0.3)
            m = rng.uniform()
            if m < 0.7:
                s.add((x, r, z), r, LAMBERTIAN, rng.uniform(0.0, 1.0, 3))
            elif m < 0.9:
                albedo = rng.uniform(0.5, 1.0, 3)
                s.add((x, r, z), r, METALLIC, albedo,
                      fuzz=rng.uniform(0.0, 0.4))
            else:
                s.add((x, r, z), r, DIELECTRIC, (1.0, 1.0, 1.0), ior=1.5)
            placed += 1
    return s, None
