"""The attention alignment of a dev utterance as a PNG.

``align_to_image`` is ``e2e_asr_tpu/utils/misc.py``'s colour map (a
two-ramp heat map, no plotting library); ``write_png`` writes an RGB image
with the standard library's ``zlib`` and ``struct``, so that validation
writes it where PIL is not installed. ``bin/train_asr.py`` writes one file
a validation beside ``scalars.jsonl``, in place of the JAX package's
tensorboard ``add_image``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def align_to_image(align: np.ndarray) -> np.ndarray:
    """Attention alignment [L, S] -> uint8 heat map [L, S, 3]."""
    a = np.asarray(align, dtype=np.float32)
    a = (a - a.min()) / (a.max() - a.min() + 1e-8)
    r = np.clip(3.0 * a - 1.5, 0, 1)
    g = np.clip(1.5 * a, 0, 1)
    b = np.clip(1.0 - 2.0 * a, 0, 1) * 0.6 + 0.2
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def png_bytes(img: np.ndarray) -> bytes:
    """An [H, W, 3] uint8 image as the bytes of an 8-bit RGB PNG (each row
    with filter type 0)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"png_bytes takes an [H, W, 3] image, got shape {img.shape}")
    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1).tobytes()
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(png_bytes(img))


def read_png(path: str) -> np.ndarray:
    """The [H, W, 3] uint8 image of a PNG that ``write_png`` wrote (8-bit
    RGB, filter type 0 on every row)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG")
    pos, idat, size = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            size = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, colour = size[0], size[1], size[2], size[3]
    if (depth, colour) != (8, 2):
        raise ValueError(f"{path}: only 8-bit RGB, got depth {depth} colour type {colour}")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * 3)
    if rows[:, 0].any():
        raise ValueError(f"{path}: a row with a filter other than 0")
    return rows[:, 1:].reshape(h, w, 3).copy()
