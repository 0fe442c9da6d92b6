"""Image readback and file output (PyTorch port of bhr_tpu/io/image.py;
reference: src/lib.rs:613-702).

PNG files are written and read by a small dependency-free codec (zlib,
8-bit RGBA, filter type 0), so a render can be saved and checked where
Pillow is not installed; other formats go through Pillow.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def get_image_data(frame: torch.Tensor) -> np.ndarray:
    """Frame tensor -> host uint8 (H, W, 4) RGBA (reference: lib.rs:613-686).

    Accepts uint8 RGBA (H, W, 4), uint8 RGB (H, W, 3) or float RGB(A) in
    [0, 1].
    """
    arr = frame.detach().cpu().numpy()
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0).round().astype(np.uint8)
    if arr.ndim != 3:
        raise ValueError(f"expected (H, W, C) image, got shape {arr.shape}")
    if arr.shape[-1] == 3:
        alpha = np.full(arr.shape[:-1] + (1,), 255, np.uint8)
        arr = np.concatenate([arr, alpha], axis=-1)
    return arr


def save_image(frame: torch.Tensor, path: str) -> None:
    """Save a rendered frame; the format follows the extension
    (lib.rs:692-702)."""
    rgba = get_image_data(frame)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        write_png(path, rgba)
        return
    from PIL import Image

    img = Image.fromarray(rgba, "RGBA")
    if ext in (".jpg", ".jpeg"):
        img = img.convert("RGB")
    img.save(path)


def _chunk(tag: bytes, payload: bytes) -> bytes:
    crc = zlib.crc32(tag + payload) & 0xFFFFFFFF
    return struct.pack(">I", len(payload)) + tag + payload + struct.pack(">I", crc)


def write_png(path: str, rgba: np.ndarray) -> None:
    """Write uint8 (H, W, 4) RGBA as a PNG (zlib, filter type 0)."""
    h, w = rgba.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgba.reshape(h, w * 4)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_MAGIC)
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Read a PNG written by `write_png` back into uint8 (H, W, 4).

    Reads 8-bit RGBA, non-interlaced, filter type 0 only, and raises
    ValueError for anything else.
    """
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_MAGIC):
        raise ValueError(f"{path} is not a PNG file")
    pos, header, idat = len(_PNG_MAGIC), None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif tag == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError(f"{path} has no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if (depth, color, interlace) != (8, 6, 0):
        raise ValueError(f"{path}: only 8-bit non-interlaced RGBA PNGs are read")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * 4)
    if raw[:, 0].any():
        raise ValueError(f"{path}: only filter type 0 is read")
    return raw[:, 1:].reshape(h, w, 4).copy()
