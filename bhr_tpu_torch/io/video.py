"""Video export: Motion-JPEG in an AVI container, dependency-free (the
port's own copy of bhr_tpu/io/video.py).

The reference presents frames to a winit window in real time; headless
rendering needs a portable animation artifact instead. ffmpeg is not
assumed — MJPEG/AVI is the one mainstream video format writable from
scratch: a RIFF container where every frame is an independent JPEG (encoded
here with PIL). Plays in VLC/mpv/browsers and imports into editors.

Layout written:
    RIFF('AVI ' LIST('hdrl' avih LIST('strl' strh strf))
               LIST('movi' ('00dc' jpeg)*)
               idx1)
"""

from __future__ import annotations

import io
import struct

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    pad = b"\0" if len(payload) % 2 else b""
    return tag + struct.pack("<I", len(payload)) + payload + pad


def _list(tag: bytes, payload: bytes) -> bytes:
    return _chunk(b"LIST", tag + payload)


def _encode_jpeg(frame_rgba: np.ndarray, quality: int) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(frame_rgba, "RGBA").convert("RGB").save(
        buf, "JPEG", quality=quality
    )
    return buf.getvalue()


def write_mjpeg_avi(path: str, frames, fps: float = 30.0, quality: int = 90) -> None:
    """Write frames (uint8 (F, H, W, 4) array or iterable of (H, W, 4)) as
    an MJPEG AVI at `fps`."""
    frames = np.asarray(frames)
    if frames.ndim == 3:
        frames = frames[None]
    n, height, width = frames.shape[0], frames.shape[1], frames.shape[2]
    jpegs = [_encode_jpeg(f, quality) for f in frames]

    usec_per_frame = int(round(1_000_000 / fps))
    max_bytes = max(len(j) for j in jpegs)

    avih = _chunk(
        b"avih",
        struct.pack(
            "<14I",
            usec_per_frame,  # dwMicroSecPerFrame
            max_bytes * int(fps),  # dwMaxBytesPerSec (approx)
            0,  # dwPaddingGranularity
            0x10,  # dwFlags: AVIF_HASINDEX
            n,  # dwTotalFrames
            0,  # dwInitialFrames
            1,  # dwStreams
            max_bytes,  # dwSuggestedBufferSize
            width,
            height,
            0, 0, 0, 0,  # reserved
        ),
    )
    strh = _chunk(
        b"strh",
        b"vids"
        + b"MJPG"
        + struct.pack(
            "<IHHIIIIIIIIhhhh",
            0, 0, 0,  # flags, priority, language
            0,  # initial frames
            1, int(round(fps)),  # scale, rate -> fps
            0, n,  # start, length
            max_bytes,  # suggested buffer
            0xFFFFFFFF,  # quality (default)
            0,  # sample size (varies)
            0, 0, width, height,  # rcFrame
        ),
    )
    strf = _chunk(
        b"strf",
        struct.pack(
            "<IiiHH4sIiiII",
            40, width, height, 1, 24, b"MJPG",
            width * height * 3, 0, 0, 0, 0,
        ),
    )
    hdrl = _list(b"hdrl", avih + _list(b"strl", strh + strf))

    movi_payload = b"movi"
    offsets = []
    for j in jpegs:
        offsets.append(len(movi_payload))
        movi_payload += _chunk(b"00dc", j)
    movi = _chunk(b"LIST", movi_payload)

    idx = b""
    for off, j in zip(offsets, jpegs):
        # offset is relative to the start of 'movi' (the tag itself)
        idx += b"00dc" + struct.pack("<III", 0x10, off, len(j))
    idx1 = _chunk(b"idx1", idx)

    riff_payload = b"AVI " + hdrl + movi + idx1
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(riff_payload)) + riff_payload)


def read_avi_info(path: str) -> dict:
    """Parse an AVI header back (used by tests): frames, size, codec."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI "
    i = data.index(b"avih") + 8
    (usec, _, _, _, total, _, streams, _, w, h) = struct.unpack_from("<10I", data, i)
    i = data.index(b"strh")
    codec = data[i + 12 : i + 16]  # fccHandler (fccType "vids" is at +8)
    return {
        "frames": total,
        "width": w,
        "height": h,
        "fps": round(1_000_000 / usec, 3),
        "codec": codec.decode(),
        "n_chunks": data.count(b"00dc") - total,  # movi chunks (idx1 repeats the tag)
    }
