"""Spheres listed one by one (a world file's materials, or ``"checker"``
with its scale and two albedos) and icosphere meshes (raytracing_tpu_torch
at commit a1403821e8fd, ``scene/config.py::make_world_mesh`` and
``make_world_meshes``, ``scene/mesh.py``), as the configuration's
``scene`` lists them."""

from __future__ import annotations

from rtbench.reference.scene import Spheres, mesh_triangles


def build(config: dict):
    sc = config["scene"]
    s = Spheres()
    for p in sc["spheres"]:
        if p["material"] == "checker":
            s.add_checker(p["center"], p["radius"], p["scale"],
                          p["even_albedo"], p["odd_albedo"])
        else:
            s.add_def(p["center"], p["radius"], p["material"])
    return s, mesh_triangles(sc.get("meshes", []))
