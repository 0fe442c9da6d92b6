"""Rendering over a (dp, sp) grid of devices (PyTorch port of
bhr_tpu/parallel/mesh.py).

  * **sp**: the pixel rows of a frame are cut into bands, one per device
    of the axis. Rays are independent, so a band needs no communication:
    its ray-gen takes the band's first row and refers to the frame's size,
    and each band is bit for bit the same rows of the whole frame.
  * **dp**: the frames of an animation are cut into contiguous blocks, one
    per row of the grid.

bhr_tpu's mesh is one controller over `jax.devices()`: one process, and
`render_frame_sharded` hands the whole frame back to its caller. So is
this one: a `Mesh` is a grid of `torch.device`s in one process, and a frame
is one Python loop that launches each band's kernel on its device's
current stream. Launches do not wait for the device, so every device is
busy at once and nothing communicates in the hot loop; the bands are then
copied to the grid's first device. The one reduction bhr_tpu makes over
'sp' -- each frame's mean luminance, a psum -- is the sum of the bands'
partial sums there. A device may stand in the grid more than once: one
card then renders the bands one after another, and a grid of "cpu"
devices runs every plain version.

bhr_tpu's `use_pallas`, `tile` and `interpret` arguments and its jit caches
(`_frame_program`, `_animation_program`) have no counterpart: each band
runs the route its whole frame takes (renderer._FramePlan, one a device and
call), whose kernel wrappers launch the kernel on a CUDA device and run the
plain version on the CPU.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.camera import orbit_camera
from ..models.disk import DiskParams
from ..models.neural import NeuralSurrogate
from ..ops.neural_kernel import as_surrogate, weights_stamp
from ..ops.sampling import unpack_frame
from ..ops.trace import TraceConfig
from ..renderer import _FramePlan


class Mesh:
    """A (dp, sp) grid of torch devices: `devices[i][j]` renders band j of
    the frames of row i. `shape` is {"dp": rows, "sp": bands}, as a jax
    Mesh's."""

    def __init__(self, devices, axis_names=("dp", "sp")):
        self.devices = tuple(tuple(torch.device(d) for d in row) for row in devices)
        if not self.devices or len({len(row) for row in self.devices}) != 1 or not self.devices[0]:
            raise ValueError("a mesh is a non-empty rectangular grid of devices")
        self.axis_names = tuple(axis_names)
        self._surrogates = {}  # device -> (source, its weights_stamp, the copy there)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, (len(self.devices), len(self.devices[0]))))

    def surrogate_on(self, params: NeuralSurrogate, device: torch.device) -> NeuralSurrogate:
        """`params` on `device`: itself where its weights lie there, else
        the mesh's copy for that device, made again only when the source or
        its weights change, so the neural kernel prepares its operands
        there once and not once a call."""
        if all(b.device == device for b in params.buffers()):
            return params
        stamp = weights_stamp(params)
        held = self._surrogates.get(device)
        if held is None or held[0] is not params or held[1] != stamp:
            copy = NeuralSurrogate([(w.to(device), b.to(device)) for w, b in params])
            self._surrogates[device] = held = (params, stamp, copy)
        return held[2]


def make_mesh(n_devices: int | None = None, axis_names=("dp", "sp"), shape=None,
              devices=None) -> Mesh:
    """A (dp, sp) mesh over `devices` (default: every visible CUDA device;
    without one it raises: a mesh of plain versions is asked for with
    devices=["cpu"] * n). A device may be named more than once.

    The default shape puts as many devices as possible on sp with dp
    absorbing the rest, as bhr_tpu's: for 8 devices (2, 4).
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh found no CUDA device; pass devices= (e.g. "
                               "['cpu'] * 8 for a mesh of plain versions)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"make_mesh({n}) has only {len(devices)} devices")
    devices = devices[:n]
    if shape is None:
        shape = (1, 1) if n == 1 else ((2, n // 2) if n % 2 == 0 else (1, n))
    dp, sp = shape
    if dp * sp != n:
        raise ValueError(f"a mesh of shape {tuple(shape)} needs {dp * sp} devices, not {n}")
    return Mesh([devices[i * sp:(i + 1) * sp] for i in range(dp)], axis_names)


def _on(x, device: torch.device):
    """An input of a band on `device`: a tensor, a pair of tensors (the luma
    tables) or DiskParams, moved there if it is not."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple):
        return tuple(_on(v, device) for v in x)
    if isinstance(x, DiskParams):
        return DiskParams(*(_on(getattr(x, f.name), device) for f in dataclasses.fields(x)))
    raise TypeError(f"cannot place a {type(x).__name__} on a device")


class _Bands:
    """The bands of one call (bhr_tpu/parallel/mesh.py:59-197): each
    device's renderer._FramePlan, so a band takes its whole frame's route --
    for the surrogate N4 where `kernel_takes` the net at `neural_precision`
    (Kerr nets too; bhr_tpu's band tests 16/2 shapes and drops the tier),
    with a skybox N3's band. The luma tier's chroma grid anchors at the
    band's first row, as bhr_tpu's band does."""

    def __init__(self, mesh: Mesh, scene, *, multires: int, neural_params, **plan):
        if multires and (plan["config"].integrator == "neural"
                         or plan["tonemap"] != "passthrough"):
            raise ValueError("sharded multires supports geodesic integrators with passthrough "
                             "tonemap only")
        self.mesh = mesh
        self.scene = scene
        self.n_sp = mesh.shape["sp"]
        self.band_h = -(-scene.screen_height // self.n_sp)  # ceil: the last band is padded
        self.plan = dict(plan, divisor=multires, neural_params=(
            None if neural_params is None else as_surrogate(neural_params)))
        self.plans = {}

    def render(self, camera, j: int, device: torch.device) -> torch.Tensor:
        """Band j of the frame of `camera` on `device` -> packed int32
        (band_h, W) there."""
        if device not in self.plans:
            placed = {k: (self.mesh.surrogate_on(v, device) if isinstance(v, NeuralSurrogate)
                          else _on(v, device) if k in ("skybox", "disk_params", "lut") else v)
                      for k, v in self.plan.items()}
            self.plans[device] = _FramePlan(self.scene, device=device, **placed)
        return self.plans[device].render(camera, row0=j * self.band_h,
                                         local_shape=(self.band_h, self.scene.screen_width))


def render_frame_sharded(camera, scene, skybox, mesh: Mesh, *,
                         config: TraceConfig = TraceConfig(), disk_params=None, lut=None,
                         fast_math: bool = False, tonemap: str = "passthrough", seed: int = 2020,
                         texture_filter: str = "bilinear", neural_params=None,
                         neural_precision: str = "default", multires: int = 0) -> torch.Tensor:
    """One frame with its pixel rows cut into bands over the mesh's 'sp'
    axis (bhr_tpu/parallel/mesh.py:231-273) -> uint8 (H, W, 4) on the
    mesh's first device.

    Band j of the first dp row's devices renders rows [j * band_h, (j + 1)
    * band_h), band_h = ceil(H / sp): heights that do not divide over sp
    pad the last band past the image, and the padded rows are sliced off.
    `skybox` is None (the star field of `seed`) or a packed int32 texture
    (ops/sampling.pack_texture_rgba8; for texture_filter "luma",
    luma_pack_texture's pair); `neural_params` a NeuralSurrogate or (W, b)
    pairs, rendered at `neural_precision` as the renderer renders them.
    Each input is copied once a call to each device that needs it; the
    surrogate once a mesh (Mesh.surrogate_on).
    """
    bands = _Bands(mesh, scene, skybox=skybox, config=config, disk_params=disk_params, lut=lut,
                   fast_math=fast_math, tonemap=tonemap, seed=seed, texture_filter=texture_filter,
                   neural_params=neural_params, neural_precision=neural_precision,
                   multires=multires)
    first = mesh.devices[0][0]
    parts = [bands.render(camera, j, device) for j, device in enumerate(mesh.devices[0])]
    frame = torch.cat([p.to(first) for p in parts])[:scene.screen_height]
    return unpack_frame(frame)


def render_animation_sharded(times, scene, skybox, mesh: Mesh, *, orbit=(0.3, 15.0, 5.0),
                             config: TraceConfig = TraceConfig(), disk_params=None, lut=None,
                             fast_math: bool = False, tonemap: str = "passthrough",
                             with_stats: bool = True, seed: int = 2020,
                             texture_filter: str = "bilinear", neural_params=None,
                             neural_precision: str = "default", multires: int = 0):
    """Orbit frames at `times` with frames over 'dp' and rows over 'sp'
    (bhr_tpu/parallel/mesh.py:276-379) -> uint8 (F, H, W, 4) on the mesh's
    first device, and with `with_stats` each frame's mean luminance (the
    green channel's mean over the image), fp32 (F,).

    `times` (F values, F divisible by dp) is cut into dp contiguous
    blocks; row i of the mesh renders block i, its devices a band each, as
    render_frame_sharded does. `orbit` is (rotation_speed, radius,
    height) of core/camera.orbit_camera. The luminance is bhr_tpu's psum
    over 'sp': each band's sum over its rows inside the image (padded rows
    masked) divided by H * W, and the bands' partial sums added on the
    first device. Frames are issued a block step at a time across the rows
    of the mesh, so every device has work queued; nothing waits for a
    device.
    """
    times = torch.as_tensor(times, dtype=torch.float32).cpu()
    n_dp = mesh.shape["dp"]
    n_frames = times.shape[0]
    if n_frames % n_dp:
        raise ValueError(f"len(times)={n_frames} must divide over dp={n_dp}")
    bands = _Bands(mesh, scene, skybox=skybox, config=config, disk_params=disk_params, lut=lut,
                   fast_math=fast_math, tonemap=tonemap, seed=seed, texture_filter=texture_filter,
                   neural_params=neural_params, neural_precision=neural_precision,
                   multires=multires)
    height, width = scene.screen_height, scene.screen_width
    band_h = bands.band_h
    first = mesh.devices[0][0]
    speed, radius, cam_h = (float(x) for x in orbit)
    frames = torch.empty((n_frames, bands.n_sp * band_h, width), dtype=torch.int32, device=first)
    lum_parts = [[] for _ in range(n_frames)]
    per_row = n_frames // n_dp
    for k in range(per_row):
        for i, row in enumerate(mesh.devices):
            f = i * per_row + k
            cam = orbit_camera(times[f], radius=radius, height=cam_h, rotation_speed=speed)
            for j, device in enumerate(row):
                row0 = j * band_h
                band = bands.render(cam, j, device)
                if with_stats:
                    green = ((band >> 8) & 0xFF).to(torch.float32)
                    rows = torch.arange(row0, row0 + band_h, device=band.device)
                    valid = (rows < height).to(torch.float32)[:, None]
                    denom = torch.full((), float(height * width), dtype=torch.float32,
                                       device=band.device)
                    lum_parts[f].append(((green * valid).sum() / denom).to(first))
                frames[f, row0:row0 + band_h].copy_(band)
    frames = unpack_frame(frames[:, :height])
    if not with_stats:
        return frames
    # the bands' partial sums, added in band order
    lums = torch.stack([sum(parts[1:], parts[0]) for parts in lum_parts])
    return frames, lums


def shard_image(image: torch.Tensor, mesh: Mesh) -> tuple:
    """An image's rows as the mesh's bands (bhr_tpu/parallel/mesh.py:382):
    band j, rows [j * band_h, (j + 1) * band_h) clipped to the image, on
    device j of the mesh's first row."""
    n_sp = mesh.shape["sp"]
    band_h = -(-image.shape[0] // n_sp)
    return tuple(image[j * band_h:(j + 1) * band_h].to(d) for j, d in enumerate(mesh.devices[0]))
