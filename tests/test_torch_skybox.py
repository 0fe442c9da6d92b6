"""The port's skybox loading (bhr_tpu_torch/io/skybox.py, io/native.py) and
texture packing against bhr_tpu's, on the same seeds and the same files:
arrays equal, packed words equal. EXR files cross both ways: written by
one package, read by the other, for the NONE, ZIPS and ZIP scanline
schemes. The ZIP files are written here, by the inverse of the reader's
reconstruction, so that nothing but the PIZ tests needs the native OpenEXR
codec; those skip where the port's `exr_available()` is false.
"""

import struct
import zlib

import numpy as np
import pytest
import torch

import bhr_tpu_torch as T
from bhr_tpu.io import native as jnative
from bhr_tpu.io import skybox as jsky
from bhr_tpu.ops.sampling import luma_pack_texture as j_luma_pack
from bhr_tpu.ops.sampling import pack_texture_rgba8 as j_pack
from bhr_tpu_torch.io import native as tnative
from bhr_tpu_torch.io import skybox as tsky
from bhr_tpu_torch.ops.sampling import luma_pack_texture, pack_texture_rgba8

LINES = {"none": (0, 1), "zips": (2, 1), "zip": (3, 16)}  # scheme: (enum, lines per block)


@pytest.fixture(autouse=True, scope="module")
def native_built():
    """native/libbhr_native.so built before the tests, through the port's
    loader (one build at a time, renamed into place when whole). bhr_tpu's
    loader remembers its first answer for the life of the process; where
    that was a failure from before the library was whole, it is asked
    once more."""
    if tnative.available() and jnative._load() is None:
        jnative._tried = False
        jnative._load()


def write_exr_scanline(path, hdr, scheme):
    """A fp32 RGBA scanline EXR in the NONE, ZIPS or ZIP scheme: the
    layout of io/skybox.write_exr with compressed blocks (interleave split,
    delta, zlib: the inverse of the readers' `_exr_unzip`)."""
    hdr = np.asarray(hdr, np.float32)
    height, width, nch = hdr.shape
    names = ["R", "G", "B", "A"][:nch]
    order = sorted(names)
    comp, lines = LINES[scheme]

    def attr(name, typ, payload):
        return (name.encode() + b"\0" + typ.encode() + b"\0" + struct.pack("<i", len(payload))
                + payload)

    chans = b"".join(n.encode() + b"\0" + struct.pack("<iiii", 2, 0, 1, 1) for n in order) + b"\0"
    dw = struct.pack("<iiii", 0, 0, width - 1, height - 1)
    header = (attr("channels", "chlist", chans)
              + attr("compression", "compression", bytes([comp]))
              + attr("dataWindow", "box2i", dw) + attr("displayWindow", "box2i", dw)
              + attr("lineOrder", "lineOrder", b"\0")
              + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
              + attr("screenWindowWidth", "float", struct.pack("<f", 1.0)) + b"\0")
    blocks = []
    for y0 in range(0, height, lines):
        raw = b"".join(hdr[y, :, names.index(n)].astype("<f4").tobytes()
                       for y in range(y0, min(y0 + lines, height)) for n in order)
        if comp:
            d = np.frombuffer(raw, np.uint8)
            split = np.concatenate([d[0::2], d[1::2]]).astype(np.int64)
            delta = split.copy()
            delta[1:] = (split[1:] - split[:-1] + 128) % 256
            packed = zlib.compress(delta.astype(np.uint8).tobytes())
            if len(packed) < len(raw):  # a block that does not shrink is stored raw
                raw = packed
        blocks.append(struct.pack("<ii", y0, len(raw)) + raw)
    preamble = struct.pack("<ii", 20000630, 2) + header
    offsets, off = [], len(preamble) + 8 * len(blocks)
    for b in blocks:
        offsets.append(off)
        off += len(b)
    with open(path, "wb") as f:
        f.write(preamble + struct.pack(f"<{len(blocks)}q", *offsets) + b"".join(blocks))


@pytest.mark.parametrize("shape,seed", [((32, 64), 5), ((48, 80), 2020), ((17, 33), 0)])
def test_procedural_starfield_equals_jax(shape, seed):
    got = tsky.procedural_starfield(*shape, seed=seed)
    want = jsky.procedural_starfield(*shape, seed=seed)
    assert got.dtype == np.uint8 and got.shape == shape + (4,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("source", ["procedural", "uint8", "float-rgb", "float-rgba"])
def test_load_skybox_equals_jax(source):
    rng = np.random.default_rng(3)
    src = {"procedural": None, "uint8": rng.integers(0, 256, (8, 16, 4), np.uint8),
           "float-rgb": rng.random((8, 16, 3), np.float32),
           "float-rgba": rng.random((8, 16, 4), np.float32) * 1.2 - 0.1}[source]
    got = T.load_skybox(src, seed=11, shape=(32, 64))
    want = jsky.load_skybox(src, seed=11, shape=(32, 64))
    assert got.dtype == np.float32 and got.shape[-1] == 4
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scheme", ["none", "zips", "zip"])
def test_exr_schemes_read_equal(tmp_path, scheme):
    """A NONE / ZIPS / ZIP file (odd sizes: a partial last block; smooth
    content, so that ZIP blocks really are compressed) decodes to the
    written values in both packages' pure-Python readers."""
    rng = np.random.default_rng(4)
    hdr = np.cumsum(rng.random((37, 53, 4), np.float32) * 0.01, axis=1, dtype=np.float32)
    hdr = (np.round(hdr * 64) / 64).astype(np.float32)
    p = str(tmp_path / f"{scheme}.exr")
    write_exr_scanline(p, hdr, scheme)
    got = tsky.read_exr_python(p)
    np.testing.assert_array_equal(got, hdr)
    np.testing.assert_array_equal(got, jsky.read_exr_python(p))
    np.testing.assert_array_equal(tsky.load_exr_image(p)[2], jsky.load_exr_image(p)[2])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_exr_written_by_one_read_by_the_other(tmp_path, writer):
    rng = np.random.default_rng(5)
    hdr = (rng.random((12, 20, 4), np.float32) * 5.0).astype(np.float32)
    p = str(tmp_path / "x.exr")
    (jsky if writer == "jax" else tsky).write_exr(p, hdr)
    reader = tsky if writer == "jax" else jsky
    np.testing.assert_array_equal(reader.read_exr_python(p), hdr)
    np.testing.assert_array_equal(T.load_skybox(p), jsky.load_skybox(p))
    # lib.rs:294-303: x / (1 + x), clamp, * 255, truncation
    np.testing.assert_array_equal((T.load_skybox(p)[..., :3] * 255.0).round().astype(np.uint8),
                                  (np.clip(hdr[..., :3] / (1 + hdr[..., :3]), 0, 1) * 255.0)
                                  .astype(np.uint8))


def test_exr_grayscale_and_errors(tmp_path):
    lum = np.random.default_rng(6).random((6, 9), np.float32)
    p = str(tmp_path / "y.exr")
    tsky.write_exr(p, lum, channels=("Y",))
    np.testing.assert_array_equal(tsky.read_exr_python(p), jsky.read_exr_python(p))
    bad = tmp_path / "bad.exr"
    bad.write_bytes(b"not an exr file at all")
    with pytest.raises(ValueError, match="not an EXR"):
        tsky.read_exr_python(str(bad))


def test_png_skybox_equals_jax(tmp_path):
    from PIL import Image

    img = np.random.default_rng(7).integers(0, 256, (6, 10, 4), np.uint8)
    p = str(tmp_path / "sky.png")
    Image.fromarray(img, "RGBA").save(p)
    got = T.load_skybox(p)
    np.testing.assert_array_equal(got, jsky.load_skybox(p))
    np.testing.assert_allclose(got, img.astype(np.float32) / 255.0, atol=1e-7)


@pytest.mark.parametrize("channels", [3, 4])
def test_pack_texture_word_equal(channels, small_skybox):
    tex = small_skybox[..., :channels]
    got = pack_texture_rgba8(tex)
    want = np.asarray(j_pack(tex))
    assert got.dtype == torch.int32 and got.shape == tex.shape[:2]
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    # from_numpy carries either form across with the same bits
    for source in (tex, want):
        np.testing.assert_array_equal(T.texture_from_numpy(source).numpy().view(np.uint32), want)


def test_luma_pack_word_equal(small_skybox):
    want_l, want_c = (np.asarray(a) for a in j_luma_pack(j_pack(small_skybox)))
    got_l, got_c = luma_pack_texture(pack_texture_rgba8(small_skybox))
    np.testing.assert_array_equal(got_l.numpy().view(np.uint32), want_l)
    np.testing.assert_array_equal(got_c.numpy().view(np.uint32), want_c)
    pair = T.texture_from_numpy(small_skybox, texture_filter="luma")
    assert torch.equal(pair[0], got_l) and torch.equal(pair[1], got_c)


def test_trace_result_from_numpy():
    res = T.trace_result_from_numpy(np.ones((2, 3, 3)), np.zeros((2, 3, 3)),
                                    np.full((2, 3), 2), np.full((2, 3), 7, np.int64))
    assert res.final_pos.dtype == torch.float32 and res.status.dtype == torch.int32
    assert res.steps.dtype == torch.int32 and int(res.steps.sum()) == 42


def test_piz_without_the_native_codec_raises(tmp_path, monkeypatch):
    """Where the native library is unavailable a PIZ file raises the
    pure-Python reader's error, as in bhr_tpu."""
    p = str(tmp_path / "piz.exr")
    tsky.write_exr(p, np.ones((4, 4, 4), np.float32))
    data = bytearray(open(p, "rb").read())
    i = data.index(b"compression\0compression\0") + len(b"compression\0compression\0") + 4
    data[i] = 4  # PIZ
    open(p, "wb").write(bytes(data))
    monkeypatch.setattr(tnative, "exr_available", lambda: False)
    with pytest.raises(ValueError, match="unsupported EXR compression 4"):
        tsky.read_exr(p)


def _need_native():
    if not tnative.exr_available():
        pytest.skip("native OpenEXR codec unavailable (native/libbhr_native.so)")


def test_piz_roundtrip_native(tmp_path):
    _need_native()
    hdr = (np.random.default_rng(8).pareto(2.0, (32, 48, 4)) * 0.5).astype(np.float32)
    hdr[..., 3] = 1.0
    p = str(tmp_path / "piz.exr")
    tnative.write_exr_native(p, hdr, compression="piz", half=True)
    back = tnative.read_exr_native(p)
    np.testing.assert_array_equal(back, hdr.astype(np.float16).astype(np.float32))
    np.testing.assert_array_equal(tsky.read_exr(p), back)


def test_piz_skybox_loads_and_renders(tmp_path):
    _need_native()
    hdr = (np.random.default_rng(9).random((32, 64, 4)) * 2.0).astype(np.float32)
    hdr[..., 3] = 1.0
    p = str(tmp_path / "sky_piz.exr")
    tnative.write_exr_native(p, hdr, compression="piz", half=True)
    np.testing.assert_array_equal(T.load_skybox(p), jsky.load_skybox(p))
    r = T.BlackHoleRenderer(16, 8, skybox=p, device="cpu")
    assert r.render_frame().shape == (8, 16, 4)


def test_a_built_library_opens_without_the_build_lock(monkeypatch):
    """The port's loader opens a library that is already whole without
    taking native/.build.lock, so a read-only checkout with a built library
    loads it and no load waits for a build it does not need."""
    assert tnative.available()  # built by the module fixture

    def no_lock(*a):
        raise AssertionError("took the build lock for a library that opens")
    monkeypatch.setattr(tnative.fcntl, "flock", no_lock)
    assert hasattr(tnative._build_and_open(), "bhr_write_png")


def test_native_zip_matches_python_reader(tmp_path):
    _need_native()
    hdr = np.random.default_rng(12).random((21, 35, 4), np.float32)
    for comp in ("zip", "zips", "none"):
        p = str(tmp_path / f"n_{comp}.exr")
        tnative.write_exr_native(p, hdr, compression=comp, half=False)
        np.testing.assert_array_equal(tsky.read_exr_python(p), hdr)
        np.testing.assert_array_equal(tnative.read_exr_native(p), hdr)
