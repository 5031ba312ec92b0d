"""A world file's scene (raytracing_tpu_torch at commit a1403821e8fd,
``scene/config.py::build_world``): the explicit objects, then the 22 x 22
grid drawn from ``numpy.random.default_rng(grid_seed)`` in the same order,
every grid sphere placed."""

from __future__ import annotations

import numpy as np

from rtbench.reference.scene import DIELECTRIC, LAMBERTIAN, METALLIC, Spheres


def build(config: dict):
    """The configuration's ``world`` (a world file): its explicit objects,
    then its random grid of small spheres (every cell placed) drawn from
    ``grid_seed`` in the upstream order. No triangles."""
    world = config["world"]
    s = Spheres()
    for sphere, mat in world["objects"]:
        s.add_def(sphere["center"], sphere["radius"], mat)
    rand = np.random.default_rng(int(config["grid_seed"]))
    diffuse = float(world["diffuse_material_treshold"])
    metal = float(world["metal_material_treshold"])
    for a in range(int(world["a_min"]), int(world["a_max"])):
        for b in range(int(world["b_min"]), int(world["b_max"])):
            choose_mat = rand.random()
            center = np.array(
                [a + 0.9 * rand.random(), 0.2, b + 0.9 * rand.random()],
                np.float32)
            if choose_mat < diffuse:
                s.add(center, 0.2, LAMBERTIAN, rand.random(3) * rand.random(3))
            elif choose_mat < metal:
                albedo = 0.5 + 0.5 * rand.random(3)
                s.add(center, 0.2, METALLIC, albedo, fuzz=0.5 * rand.random())
            else:
                s.add(center, 0.2, DIELECTRIC, (1.0, 1.0, 1.0),
                      ior=1.2 + 0.4 * rand.random())
    return s, None
