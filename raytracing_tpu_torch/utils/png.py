"""Minimal dependency-free PNG writer and reader (zlib + struct).

Copy of ``raytracing_tpu/utils/png.py`` without its optional native encoder:
8-bit grayscale/RGB/RGBA encoding with filter 0, and a decoder for the
subset this package and the JAX package write (filters 0 and 4).
"""

from __future__ import annotations

import pathlib
import struct
import zlib

import numpy as np

_COLOR_TYPES = {1: 0, 3: 2, 4: 6}  # channels -> PNG color type


def encode_png(image: np.ndarray, *, compress_level: int = 6) -> bytes:
    """Encode ``uint8[H, W, C]`` (C in {1, 3, 4}) as a PNG byte string."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise TypeError(f"expected uint8 image, got {image.dtype}")
    if image.ndim == 2:
        image = image[..., None]
    if image.ndim != 3 or image.shape[-1] not in _COLOR_TYPES:
        raise ValueError(f"expected [H, W, {{1,3,4}}] image, got shape {image.shape}")

    height, width, channels = image.shape
    color_type = _COLOR_TYPES[channels]

    def chunk(tag: bytes, payload: bytes) -> bytes:
        out = struct.pack(">I", len(payload)) + tag + payload
        crc = zlib.crc32(tag + payload) & 0xFFFFFFFF
        return out + struct.pack(">I", crc)

    ihdr = struct.pack(">IIBBBBB", width, height, 8, color_type, 0, 0, 0)
    raw = np.concatenate(
        [np.zeros((height, 1), np.uint8), image.reshape(height, -1)], axis=1
    ).tobytes()
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, compress_level))
        + chunk(b"IEND", b"")
    )


def write_png(path: str | pathlib.Path, image: np.ndarray, *, compress_level: int = 6) -> None:
    pathlib.Path(path).write_bytes(encode_png(image, compress_level=compress_level))


def read_png(path: str | pathlib.Path) -> np.ndarray:
    """Decode 8-bit, non-interlaced PNGs with filters 0/4."""
    data = pathlib.Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    pos = 8
    width = height = channels = None
    idat = b""
    while pos < len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            width, height, depth, color_type, _, _, interlace = struct.unpack(
                ">IIBBBBB", payload
            )
            if depth != 8 or interlace != 0:
                raise ValueError("unsupported PNG variant")
            channels = {0: 1, 2: 3, 6: 4}[color_type]
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    stride = width * channels + 1
    rows = raw.reshape(height, stride)
    if np.all(rows[:, 0] == 0):
        return rows[:, 1:].reshape(height, width, channels)
    if not np.all(np.isin(rows[:, 0], (0, 4))):
        raise ValueError("unsupported PNG filter (only 0/4 are decoded)")
    out = np.zeros((height, stride - 1), np.int32)
    for y in range(height):
        row = rows[y, 1:].astype(np.int32)
        if rows[y, 0] == 0:
            out[y] = row
            continue
        for x in range(stride - 1):
            a = out[y, x - channels] if x >= channels else 0
            b = out[y - 1, x] if y > 0 else 0
            c = out[y - 1, x - channels] if (y > 0 and x >= channels) else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            out[y, x] = (row[x] + pred) & 0xFF
    return out.astype(np.uint8).reshape(height, width, channels)
