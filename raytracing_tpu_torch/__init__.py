"""raytracing_tpu_torch: the PyTorch/CUDA port of raytracing_tpu.

The batch render of sphere scenes, textured spheres and triangle meshes
(glTF included), resumable from checkpoints, sharded over a (px, spp)
device mesh, and the interactive converge-while-idle session on an NVIDIA
H100, with its hot loop in a CUDA C++ kernel written for Hopper
(``csrc/regen.cu``) and a plain PyTorch version of that kernel beside it
(``ops/trace.py``); and the portable wavefront backend (``backend="xla"``,
plain PyTorch, as the JAX package's is plain XLA). The JAX package
``raytracing_tpu`` is the reference; this package never imports JAX.

  core/      thin-lens camera frame and ray generation, color pipe,
             vector math, threefry RNG
  scene/     SoA world (torch tensors), JSON world config, meshes + BVH,
             glTF loader
  ops/       scene packing, textures, the regeneration kernel and its
             build; the wavefront's intersection and scattering
  models/    the wavefront integrator
  parallel/  the (px, spp) device mesh and the sharded renders
  runtime/   wave-planning renderer (both backends, a mesh, checkpoints,
             the frame API), slot tiling, terminal/file displays, the
             interactive session
  utils/     PNG IO, structured logging, native host helpers
  tools/     measurement tools, the orbit demo
  interop    scene/camera state carried across from the JAX package
"""

from .core.camera import CameraParameters, DerivedCamera, derive
from .scene.config import (
    WorldDefinition,
    build_world,
    load_and_build,
    load_world,
    make_world_basic,
    make_world_mesh,
    make_world_meshes,
    make_world_stress,
    make_world_textured,
)
from .scene.types import MaterialKind, Scene, SceneBuilder, TextureKind
from .runtime.renderer import Renderer, RenderProgress

__version__ = "0.1.0"

__all__ = [
    "CameraParameters",
    "DerivedCamera",
    "derive",
    "WorldDefinition",
    "build_world",
    "load_and_build",
    "load_world",
    "make_world_basic",
    "make_world_mesh",
    "make_world_meshes",
    "make_world_stress",
    "make_world_textured",
    "MaterialKind",
    "TextureKind",
    "Scene",
    "SceneBuilder",
    "Renderer",
    "RenderProgress",
    "__version__",
]
