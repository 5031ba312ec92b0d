"""Minimal pure-Python glTF 2.0 loader (.gltf / .glb) for triangle meshes.

A numpy copy of ``raytracing_tpu/scene/gltf.py``, so that both packages load
the same vertices, faces and materials from an asset. Supported:

* the .glb binary container (JSON + BIN chunks) and .gltf with external or
  base64 data-URI buffers;
* scene-graph traversal with node transforms (``matrix`` or TRS);
* primitives in mode 4 (TRIANGLES), indexed (u8/u16/u32) or not;
* POSITION accessors (f32 VEC3) with bufferView byteStride;
* pbrMetallicRoughness.baseColorFactor and metallicFactor/roughnessFactor,
  mapped onto the renderer's materials (metallic > 0.5: metal with
  fuzz = roughness; otherwise lambertian).

Raises ``GLTFError`` on unsupported or malformed content.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import pathlib
import struct

import numpy as np

_GLB_MAGIC = 0x46546C67
_CHUNK_JSON = 0x4E4F534A
_CHUNK_BIN = 0x004E4942

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16,
    5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


class GLTFError(RuntimeError):
    """Unsupported or malformed glTF content."""


@dataclasses.dataclass(frozen=True)
class MeshPrimitive:
    """One triangle soup + its mapped material."""

    vertices: np.ndarray            # (V, 3) f32, world-transformed
    faces: np.ndarray               # (F, 3) int64
    albedo: tuple[float, float, float]
    metallic: bool
    fuzz: float


def _read_buffers(doc: dict, base_dir: pathlib.Path, bin_chunk: bytes | None):
    out = []
    for buf in doc.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            if bin_chunk is None:
                raise GLTFError("buffer without uri outside a .glb")
            out.append(bin_chunk)
        elif uri.startswith("data:"):
            out.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            out.append((base_dir / uri).read_bytes())
    return out


def _accessor(doc: dict, buffers: list[bytes], idx: int) -> np.ndarray:
    acc = doc["accessors"][idx]
    if "sparse" in acc:
        raise GLTFError("sparse accessors not supported")
    dtype = _COMPONENT_DTYPES.get(acc["componentType"])
    if dtype is None:
        raise GLTFError(f"unknown componentType {acc['componentType']}")
    ncomp = _TYPE_COUNTS.get(acc["type"])
    if ncomp is None:
        raise GLTFError(f"unknown accessor type {acc['type']}")
    count = acc["count"]
    view = doc["bufferViews"][acc["bufferView"]]
    data = buffers[view["buffer"]]
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    itemsize = np.dtype(dtype).itemsize
    stride = view.get("byteStride") or itemsize * ncomp
    if stride == itemsize * ncomp:
        arr = np.frombuffer(data, dtype, count * ncomp, offset)
        return arr.reshape(count, ncomp)
    rows = [
        np.frombuffer(data, dtype, ncomp, offset + i * stride)
        for i in range(count)
    ]
    return np.stack(rows)


def _node_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
    m = np.eye(4)
    if "scale" in node:
        m = m @ np.diag([*node["scale"], 1.0])
    if "rotation" in node:  # quaternion xyzw
        x, y, z, w = node["rotation"]
        r = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ]
        )
        rm = np.eye(4)
        rm[:3, :3] = r
        m = rm @ m
    if "translation" in node:
        tm = np.eye(4)
        tm[:3, 3] = node["translation"]
        m = tm @ m
    return m


def _material(doc: dict, prim: dict) -> tuple[tuple[float, float, float], bool, float]:
    mi = prim.get("material")
    if mi is None:
        return (1.0, 1.0, 1.0), False, 0.0
    pbr = doc.get("materials", [])[mi].get("pbrMetallicRoughness", {})
    base = pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])[:3]
    metallic = float(pbr.get("metallicFactor", 1.0)) > 0.5
    fuzz = float(pbr.get("roughnessFactor", 1.0)) if metallic else 0.0
    return tuple(float(c) for c in base), metallic, min(fuzz, 1.0)


def load_gltf(path: str | pathlib.Path) -> list[MeshPrimitive]:
    """Load every triangle primitive of every scene node, world-transformed."""
    path = pathlib.Path(path)
    bin_chunk = None
    if path.suffix.lower() == ".glb":
        raw = path.read_bytes()
        magic, version, _length = struct.unpack_from("<III", raw, 0)
        if magic != _GLB_MAGIC:
            raise GLTFError("bad .glb magic")
        if version != 2:
            raise GLTFError(f"unsupported glb version {version}")
        off = 12
        doc = None
        while off < len(raw):
            clen, ctype = struct.unpack_from("<II", raw, off)
            payload = raw[off + 8 : off + 8 + clen]
            if ctype == _CHUNK_JSON:
                doc = json.loads(payload)
            elif ctype == _CHUNK_BIN:
                bin_chunk = payload
            off += 8 + clen + ((-clen) % 4)
        if doc is None:
            raise GLTFError("no JSON chunk in .glb")
    else:
        doc = json.loads(path.read_text())
    buffers = _read_buffers(doc, path.parent, bin_chunk)

    prims: list[MeshPrimitive] = []

    def visit(node_idx: int, parent: np.ndarray) -> None:
        node = doc["nodes"][node_idx]
        m = parent @ _node_matrix(node)
        if "mesh" in node:
            for prim in doc["meshes"][node["mesh"]]["primitives"]:
                if prim.get("mode", 4) != 4:
                    raise GLTFError(
                        f"only TRIANGLES (mode 4) supported, got {prim.get('mode')}"
                    )
                pos = _accessor(doc, buffers, prim["attributes"]["POSITION"])
                pos = pos.astype(np.float64)
                world = (pos @ m[:3, :3].T) + m[:3, 3]
                if "indices" in prim:
                    idx = _accessor(doc, buffers, prim["indices"]).reshape(-1)
                else:
                    idx = np.arange(len(pos))
                faces = idx.astype(np.int64).reshape(-1, 3)
                albedo, metallic, fuzz = _material(doc, prim)
                prims.append(
                    MeshPrimitive(
                        world.astype(np.float32), faces, albedo, metallic, fuzz
                    )
                )
        for child in node.get("children", []):
            visit(child, m)

    scene_idx = doc.get("scene", 0)
    scenes = doc.get("scenes", [])
    roots = scenes[scene_idx]["nodes"] if scenes else range(len(doc.get("nodes", [])))
    for r in roots:
        visit(r, np.eye(4))
    if not prims:
        raise GLTFError("no triangle primitives found")
    return prims
