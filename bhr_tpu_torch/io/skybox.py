"""Skybox loading: HDR EXR star maps, LDR images and a procedural fallback
(the port's own copy of bhr_tpu/io/skybox.py: numpy only, equal arrays).

The reference hardcodes `assets/starmap_2020_4k.exr` (reference:
src/lib.rs:406-411), which is not distributed; a deterministic procedural
star field stands in by default.

EXR decoding follows the reference pipeline (reference: src/lib.rs:270-308):
HDR pixels -> Reinhard x/(1+x) tone map -> RGBA8 (Rust `as u8` truncates,
reproduced here with astype). The texture is then held as fp32 k/255 values,
emulating the Rgba8Unorm storage format the GPU sampled from;
ops/sampling.pack_texture_rgba8 packs it into the device texture.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def load_skybox(source=None, seed: int = 2020, shape=(2048, 4096)) -> np.ndarray:
    """Resolve a skybox source to a fp32 (H, W, 4) array of k/255 values.

    source: None (procedural), a path (.exr/.png/.jpg/...), or an array
    (uint8 or float in [0,1]).
    """
    if source is None:
        rgba8 = procedural_starfield(shape[0], shape[1], seed=seed)
    elif isinstance(source, str):
        if source.lower().endswith(".exr"):
            _, _, rgba8 = load_exr_image(source)
        else:
            from PIL import Image

            img = Image.open(source).convert("RGBA")
            rgba8 = np.asarray(img, np.uint8)
    else:
        arr = np.asarray(source)
        if arr.dtype == np.uint8:
            rgba8 = arr
        else:
            rgba8 = (np.clip(arr, 0.0, 1.0) * 255.0).round().astype(np.uint8)
        if rgba8.shape[-1] == 3:
            alpha = np.full(rgba8.shape[:-1] + (1,), 255, np.uint8)
            rgba8 = np.concatenate([rgba8, alpha], axis=-1)
    return rgba8.astype(np.float32) / 255.0


def procedural_starfield(height: int, width: int, seed: int = 2020) -> np.ndarray:
    """Deterministic equirectangular star map, uint8 (H, W, 4).

    Stars are distributed uniformly on the sphere (uniform u, uniform sin
    latitude -> no pole clustering in world space), with a power-law
    brightness distribution, temperature-tinted colors, a soft galactic
    band, and a faint blue noise floor.
    """
    rng = np.random.RandomState(seed)
    img = np.zeros((height, width, 3), np.float32)

    # faint background noise + galactic band
    u = (np.arange(width, dtype=np.float32) + 0.5) / width
    v = (np.arange(height, dtype=np.float32) + 0.5) / height
    uu, vv = np.meshgrid(u, v)
    band_center = 0.5 + 0.12 * np.sin(2.0 * np.pi * uu + 0.7)
    band = np.exp(-(((vv - band_center) / 0.075) ** 2))
    img += band[..., None] * np.array([0.035, 0.033, 0.045], np.float32)
    img += rng.rand(height, width, 1).astype(np.float32) * 0.008

    n_stars = max(1, (height * width) // 256)
    su = rng.rand(n_stars)
    sy = rng.uniform(-1.0, 1.0, n_stars)
    sv = 0.5 - np.arcsin(sy) / np.pi
    px = np.minimum((su * width).astype(np.int64), width - 1)
    py = np.minimum((sv * height).astype(np.int64), height - 1)
    # power-law brightness, temperature tint from blue-white to orange
    brightness = (rng.pareto(3.5, n_stars) * 0.12 + 0.02).astype(np.float32)
    temp = rng.rand(n_stars).astype(np.float32)
    color = np.stack(
        [
            0.75 + 0.25 * temp,  # R rises with "temp" knob
            0.80 + 0.15 * np.sin(np.pi * temp),
            1.00 - 0.45 * temp,  # B falls
        ],
        axis=-1,
    )
    np.add.at(img, (py, px), np.minimum(brightness, 2.5)[:, None] * color)

    # a few hundred bright stars get a 2-pixel gaussian splat
    n_bright = min(400, n_stars)
    order = np.argsort(brightness)[-n_bright:]
    kernel = np.array([[0.06, 0.22, 0.06], [0.22, 1.0, 0.22], [0.06, 0.22, 0.06]], np.float32)
    for idx in order:
        b = min(float(brightness[idx]) * 1.5, 3.0)
        y0, x0 = int(py[idx]), int(px[idx])
        for dy in (-1, 0, 1):
            yy = min(max(y0 + dy, 0), height - 1)
            for dx in (-1, 0, 1):
                xx = (x0 + dx) % width
                img[yy, xx] += b * kernel[dy + 1, dx + 1] * color[idx]

    # same Reinhard + truncation the EXR path applies (lib.rs:294-303)
    mapped = img / (1.0 + img)
    rgba8 = np.empty((height, width, 4), np.uint8)
    rgba8[..., :3] = (np.clip(mapped, 0.0, 1.0) * 255.0).astype(np.uint8)
    rgba8[..., 3] = 255
    return rgba8


# ---------------------------------------------------------------------------
# EXR reading. Two tiers, mirroring the reference's `exr` crate coverage
# (src/lib.rs:270-308, Cargo.toml):
#   1. native/bhr_exr.cpp linked against the system OpenEXR (io/native.py
#      loads the library native/Makefile builds) -- decodes every
#      compression scheme (PIZ, the real NASA star map's format, PXR24,
#      B44, DWA) and tiled files;
#   2. a dependency-free pure-Python reader for scanline NONE/ZIPS/ZIP
#      (half/float/uint), used when the native library is unavailable and
#      as the cross-check oracle for the native path in tests.
# ---------------------------------------------------------------------------

_EXR_MAGIC = 20000630
_PIXEL_DTYPES = {0: np.dtype("<u4"), 1: np.dtype("<f2"), 2: np.dtype("<f4")}
_LINES_PER_BLOCK = {0: 1, 2: 1, 3: 16}  # NONE, ZIPS, ZIP


def read_exr(path: str) -> np.ndarray:
    """Decode an EXR file to fp32 (H, W, 4) HDR values (RGBA order).

    Uses the native OpenEXR-backed decoder when available (full coverage,
    ~100x faster on 4K assets); falls back to the pure-Python reader."""
    from . import native

    if native.exr_available():
        return native.read_exr_native(path)
    return read_exr_python(path)


def read_exr_python(path: str) -> np.ndarray:
    """Pure-Python EXR decode (scanline NONE/ZIPS/ZIP only)."""
    with open(path, "rb") as f:
        data = f.read()
    magic, version = struct.unpack_from("<ii", data, 0)
    if magic != _EXR_MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200:
        raise ValueError(f"{path}: tiled EXR not supported")
    off = 8
    headers = {}
    while data[off] != 0:
        name_end = data.index(b"\0", off)
        name = data[off:name_end].decode()
        off = name_end + 1
        type_end = data.index(b"\0", off)
        attr_type = data[off:type_end].decode()
        off = type_end + 1
        (size,) = struct.unpack_from("<i", data, off)
        off += 4
        headers[name] = (attr_type, data[off : off + size])
        off += size
    off += 1  # header terminator

    comp = headers["compression"][1][0]
    if comp not in _LINES_PER_BLOCK:
        raise ValueError(f"{path}: unsupported EXR compression {comp}")
    xmin, ymin, xmax, ymax = struct.unpack("<iiii", headers["dataWindow"][1])
    width, height = xmax - xmin + 1, ymax - ymin + 1

    channels = []  # (name, dtype) in file order (alphabetical per spec)
    craw = headers["channels"][1]
    coff = 0
    while craw[coff] != 0:
        cend = craw.index(b"\0", coff)
        cname = craw[coff:cend].decode()
        (ptype,) = struct.unpack_from("<i", craw, cend + 1)
        channels.append((cname, _PIXEL_DTYPES[ptype]))
        coff = cend + 1 + 16
    lines_per_block = _LINES_PER_BLOCK[comp]
    n_blocks = -(-height // lines_per_block)
    offsets = struct.unpack_from(f"<{n_blocks}q", data, off)

    planes = {name: np.zeros((height, width), np.float32) for name, _ in channels}
    row_bytes = sum(width * dt.itemsize for _, dt in channels)
    for block_off in offsets:
        y, nbytes = struct.unpack_from("<ii", data, block_off)
        raw = data[block_off + 8 : block_off + 8 + nbytes]
        y0 = y - ymin
        n_lines = min(lines_per_block, height - y0)
        expected = row_bytes * n_lines
        if comp in (2, 3) and nbytes < expected:
            raw = _exr_unzip(raw)
        # vectorized scanline decode: view the block as (lines, row_bytes)
        # and slice each channel's byte band across all lines at once
        buf = np.frombuffer(raw, np.uint8)[: row_bytes * n_lines]
        rows2d = buf.reshape(n_lines, row_bytes)
        pos = 0
        for cname, dt in channels:
            nb = width * dt.itemsize
            band = np.ascontiguousarray(rows2d[:, pos : pos + nb])
            planes[cname][y0 : y0 + n_lines, :] = band.view(dt).astype(np.float32)
            pos += nb

    out = np.zeros((height, width, 4), np.float32)
    out[..., 3] = 1.0
    for i, ch in enumerate("RGBA"):
        if ch in planes:
            out[..., i] = planes[ch]
        elif ch != "A" and "Y" in planes:  # grayscale EXR
            out[..., i] = planes["Y"]
    return out


def _exr_unzip(raw: bytes) -> bytes:
    """EXR ZIP/ZIPS post-decompression reconstruction (delta + interleave)."""
    e = np.frombuffer(zlib.decompress(raw), np.uint8).astype(np.int64)
    # vectorized form of the recurrence d[i] = d[i] + d[i-1] - 128 (mod 256)
    d = ((np.cumsum(e - 128) + 128) % 256).astype(np.uint8)
    half = (len(d) + 1) // 2
    out = np.empty(len(d), np.uint8)
    out[0::2] = d[:half]
    out[1::2] = d[half : len(d)]
    return out.tobytes()


def load_exr_image(path: str):
    """EXR -> (width, height, RGBA8 bytes-like array), matching the
    reference's load_exr_image (src/lib.rs:270-308): Reinhard x/(1+x) on RGB,
    clamp, *255, truncate to u8; alpha clamp*255 truncate."""
    hdr = read_exr(path)
    height, width = hdr.shape[:2]
    rgb = hdr[..., :3]
    mapped = rgb / (1.0 + rgb)
    rgba8 = np.empty((height, width, 4), np.uint8)
    rgba8[..., :3] = (np.clip(mapped, 0.0, 1.0) * 255.0).astype(np.uint8)
    rgba8[..., 3] = (np.clip(hdr[..., 3], 0.0, 1.0) * 255.0).astype(np.uint8)
    return width, height, rgba8


def write_exr(path: str, hdr: np.ndarray, channels=None) -> None:
    """Write an uncompressed fp32 scanline EXR (for tests and asset export).

    `channels` overrides the channel names (e.g. ("Y",) for grayscale)."""
    hdr = np.asarray(hdr, np.float32)
    if hdr.ndim == 2:
        hdr = hdr[..., None]
    height, width = hdr.shape[:2]
    nch = hdr.shape[2]
    names = list(channels) if channels else ["R", "G", "B", "A"][:nch]
    file_order = sorted(names)  # EXR requires alphabetical channel order

    def attr(name, typ, payload):
        return name.encode() + b"\0" + typ.encode() + b"\0" + struct.pack("<i", len(payload)) + payload

    chan_payload = b""
    for n in file_order:
        chan_payload += n.encode() + b"\0" + struct.pack("<iiii", 2, 0, 1, 1)
    chan_payload += b"\0"
    dw = struct.pack("<iiii", 0, 0, width - 1, height - 1)
    header = (
        attr("channels", "chlist", chan_payload)
        + attr("compression", "compression", b"\0")
        + attr("dataWindow", "box2i", dw)
        + attr("displayWindow", "box2i", dw)
        + attr("lineOrder", "lineOrder", b"\0")
        + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
        + attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
        + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
        + b"\0"
    )
    preamble = struct.pack("<ii", _EXR_MAGIC, 2) + header
    table_off = len(preamble) + 8 * height
    row_bytes = 8 + 4 * width * nch
    offsets = struct.pack(f"<{height}q", *[table_off + i * row_bytes for i in range(height)])
    chunks = []
    for y in range(height):
        payload = b"".join(
            hdr[y, :, names.index(n)].astype("<f4").tobytes() for n in file_order
        )
        chunks.append(struct.pack("<ii", y, len(payload)) + payload)
    with open(path, "wb") as f:
        f.write(preamble + offsets + b"".join(chunks))
