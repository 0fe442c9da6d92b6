"""The neural surrogate's CUDA kernel, its wrapper and its plain PyTorch
version (PyTorch port of bhr_tpu/ops/neural_pallas.py).

`neural_render_packed` wraps csrc/neural_mlp.cu, which replaces
`_build_kernel(emit="frame")` for the Schwarzschild net (N1) and the Kerr
net (N2): ray-gen, features, the tanh MLP, envelope, rotation, star field
and the packed word in one launch per frame. `neural_render_packed_reference`
is its plain version: the same per-pixel arithmetic in the same order
(bhr_tpu's kernel's: an rsqrt-normalised ray, the tangent scaled by
1 / max(s, 1e-12), capture where the logit is positive, round-half-up),
with the matrix chain through models/neural.mlp_apply. The wrapper runs the
plain version for a CPU device; for a CUDA device it launches the kernel or
raises -- it never falls back.

The kernel computes the ``default`` tier (bf16 operands, fp32
accumulation, on the tensor cores) and the ``highest`` one (fp32 on the
CUDA cores); models/neural.py says what each means. The renderer sends it
the nets bhr_tpu sends its kernel (`kernel_takes`: hidden widths that are
multiples of 128); the kernel holds those of at most 8 layers up to what a
block's shared memory holds (`kernel_plan`: widths up to 1152 in the
default tier, 1024 in the highest) and raises for any other. The default
tier has three layouts of the same bits, chosen by the net's widths alone
(`kernel_plan`): the held one (a warp's 32 pixels through every layer,
every weight in shared memory) for nets up to 128 wide whose weights fit,
the streamed one (warpgroups on wgmma, the weights streamed through a ring)
for the others up to 256 wide, the chunked one beyond.
`neural_trace_dirs` is the same kernel's direction-plane output (N3,
bhr_tpu's emit="dirs"): it stores the unit directions and the capture
status as a TraceResult instead of shading them, for frames with a texture
skybox, whose epilogue (renderer.shade_image) samples the texture. Its
plain version is `neural_trace_dirs_reference`. Each takes a band of rows
(`row0`, `local_shape`): `neural_render_packed_band` is bhr_tpu's N4, the
frame kernel over rows [row0, row0 + band_h), which parallel/mesh.py
renders on each device of its 'sp' axis.
"""

from __future__ import annotations

import torch

from ..core.camera import Camera
from ..core.math import on_device, rsqrt, sqrt_rn
from ..core.scene import SceneParams
from ..models.neural import (
    _BC_FACTOR,
    NeuralSurrogate,
    envelope,
    fourier_octaves,
    mlp_apply,
    rotate_in_plane,
)
from ..models.neural_kerr import criticality_kerr
from .sampling import pack_rgba8_planes
from .starfield import procedural_background, seed_term
from ..utils import tracing
from ..utils.build import MAX_LAYERS, MlpDesc
from .trace import STATUS_CAPTURED, STATUS_ESCAPED, TraceConfig, TraceResult
from .trace_kernel import (
    _P_ASPECT,
    _P_BH,
    _P_CAM,
    _P_FOVF,
    _P_FWD,
    _P_HF,
    _P_RIGHT,
    _P_RS,
    _P_SPIN,
    _P_UP,
    _P_WF,
    _check_out,
    _kernel_device,
    _kernel_params,
    _local_shape,
    _raise_on_error,
    build_params,
)

SMEM_LIMIT = 232448  # bytes of shared memory a block may use (sm_90)
KERNEL_TIERS = ("default", "highest")
# The block plans: (pixels a block, rows a weight chunk, chunk buffers,
# register width). Default tier, held layout (csrc/neural_mlp.cu
# neural_fused_kernel, register width 128), for nets up to 128 wide whose
# weights fit beside the warps' staging rows: a warp owns 32 pixels through
# every layer, _HELD_WARPS warps a block, the weights held whole (0
# buffers). Streamed layout (neural_fused_kernel_ws, register width 256),
# for the other nets up to 256 wide: STREAMED_PLAN, a cluster of two blocks
# of two consumer warpgroups of 64 pixels takes rounds of 256 pixels, the
# weights streamed in chunks of 64 output channels through a ring of 4.
# Wider nets take the chunked layout (register width 0):
# pixels a block and output channels a weight chunk (mma items are 16
# pixels x 64 channels). fp32 tier: pixels a block and W rows a weight
# slab. There a thread holds 8 pixels x 16 channels of a warp tile of
# 32 x 128, and a layer's whole output stays in registers until it
# overwrites the one activation buffer, so a block of 256 threads takes at
# most _MAX_OUTPUTS = pix x widest outputs: 256 pixels for the 128-wide
# nets, 128 for the 256-wide, 32 for the 1024-wide. Two chunk buffers
# before one, then the largest chunk.
_HELD_WARPS = 12
_PIX = {"default": (128, 64, 32, 16), "highest": (256, 128, 64, 32)}
_CHUNK = {"default": (64,), "highest": (32, 16)}
_MAX_OUTPUTS = 256 * 8 * 16
# the streamed layout (222,336 bytes of shared memory at most): consumer
# warpgroups a block, their pixels (wgmma's M), the widest input
_WS_CONSUMERS, _WS_M, _WS_KMAX = 2, 64, 256
STREAMED_PLAN = (2 * _WS_CONSUMERS * _WS_M, 64, 4, 256)


def as_surrogate(params) -> NeuralSurrogate:
    """`params` as a NeuralSurrogate: itself, or one built from (W, b) pairs."""
    return params if isinstance(params, NeuralSurrogate) else NeuralSurrogate(params)


def kernel_tier(precision) -> str:
    """The kernel's tier for `precision` (None is "default"); raises for
    "high", which bhr_tpu sends to its staged path."""
    precision = "default" if precision is None else precision
    if precision not in KERNEL_TIERS:
        raise ValueError(f"the neural kernel computes the {KERNEL_TIERS} tiers, not "
                         f"{precision!r}; render it through ops/neural_trace (the renderer "
                         "routes it there)")
    return precision


def padded_inputs(n_in: int) -> int:
    """The first layer's input width padded with zeros to a multiple of 16
    (the mma's K): 16 for the Schwarzschild net, 32 for Kerr's 22."""
    return -(-n_in // 16) * 16


def mlp_dims(params) -> list[int]:
    """[padded inputs, hidden widths..., outputs]: csrc/neural_mlp.cu's
    MlpDesc.dims."""
    params = as_surrogate(params)
    return [padded_inputs(params[0][0].shape[0]), *params.widths, params[-1][0].shape[1]]


def smem_bytes(dims, plan, precision: str) -> int:
    """Shared memory of a block of `plan` for a net of widths `dims`
    (mlp_dims), as csrc/neural_mlp.cu counts it (fused_smem_bytes,
    ws_smem_bytes, smem_bytes). Held: each warp's 32 staging rows of
    regs + 8 bf16, the hidden layers' W^T held whole (rows of in + 8 bf16),
    the head's weights in fp32, 8 floats of geometry a pixel. Streamed: a
    ring of `nbuf` slots of n_chunk x 256 bf16, each consumer warpgroup's 64
    staging rows of 264 bf16, two rounds of the block's 128 pixels'
    features in rows of 40 bf16, the head's weights in fp32 and 8 + 2 nbuf
    mbarriers. Chunked: two activation buffers of
    pix rows of hmax + 8 bf16 and `nbuf` chunks of n_chunk rows of W^T at
    that stride; fp32 tier: one
    activation buffer of hmax rows of pix + 4 floats and `nbuf` slabs of
    n_chunk rows of hmax floats (hmax: the widest of dims but the
    outputs)."""
    pix, n_chunk, nbuf, regs = plan
    hmax = max(dims[:-1])
    if kernel_tier(precision) == "highest":
        return (hmax * (pix + 4) + nbuf * n_chunk * hmax) * 4
    if regs == STREAMED_PLAN[3]:
        px = _WS_CONSUMERS * _WS_M
        return (nbuf * n_chunk * _WS_KMAX * 2 + px * (_WS_KMAX + 8) * 2 + 2 * px * (32 + 8) * 2
                + dims[-1] * dims[-2] * 4 + (2 * nbuf + 4 + 2 * _WS_CONSUMERS) * 8)
    if regs:
        held = sum(n * (k + 8) for k, n in zip(dims[:-2], dims[1:-1]))
        return ((_HELD_WARPS * 32 * (regs + 8) + held) * 2
                + (dims[-1] * dims[-2] + _HELD_WARPS * 32 * 8) * 4)
    return (2 * pix + nbuf * n_chunk) * (hmax + 8) * 2


def kernel_shapes_ok(params) -> bool:
    """bhr_tpu's `neural_shapes_ok` (bhr_tpu/renderer.py:169-183): at
    least 2 layers, the Schwarzschild (16 in, 2 out) or Kerr (22 in, 3 out)
    shapes, and hidden widths that are multiples of 128."""
    layers = list(params)
    return (len(layers) >= 2
            and (layers[0][0].shape[0], layers[-1][0].shape[1]) in ((16, 2), (22, 3))
            and all(w.shape[1] % 128 == 0 for w, _ in layers[:-1]))


def kernel_plan(params, precision) -> tuple[int, int, int, int] | None:
    """(pixels per block, channels per weight chunk or W rows per slab,
    chunk buffers, register width) for this net and tier, or None when no
    block of the kernel holds it: a net that `kernel_shapes_ok` refuses,
    more than MAX_LAYERS layers, or a widest layer for which no block fits
    in shared memory (`smem_bytes`) and, in the fp32 tier, in registers
    (_MAX_OUTPUTS); widths up to 1152 fit in the default tier, 1024 in the
    fp32 one. The default tier takes its layout by the net's widths alone:
    up to 128 wide with every weight held if they fit, else up to 256 wide
    streamed; wider nets take the chunked layout."""
    if not kernel_shapes_ok(params) or len(params) > MAX_LAYERS:
        return None
    params = as_surrogate(params)
    precision = kernel_tier(precision)
    dims = mlp_dims(params)
    hmax = max(dims[:-1])
    if precision == "default" and hmax <= 256:
        held = (32 * _HELD_WARPS, 0, 0, 128)
        if hmax <= 128 and smem_bytes(dims, held, precision) <= SMEM_LIMIT:
            return held
        return STREAMED_PLAN
    for pix in _PIX[precision]:
        if precision == "highest" and pix * hmax > _MAX_OUTPUTS:
            continue
        for nbuf in (2, 1):
            for nc in _CHUNK[precision]:
                if smem_bytes(dims, (pix, nc, nbuf, 0), precision) <= SMEM_LIMIT:
                    return pix, nc, nbuf, 0
    return None


def kernel_takes(params, scene: SceneParams, *, tonemap: str, precision) -> bool:
    """True where bhr_tpu takes its kernel (bhr_tpu/renderer.py:166-192):
    the analytic star field (the caller has no skybox), the passthrough
    tonemap, no debug view, the default or highest tier and a net that
    `kernel_shapes_ok` takes. `neural_render_packed` raises for such a net
    when `kernel_plan` finds no block for it; the frame never goes to the
    staged route instead."""
    return (tonemap == "passthrough" and scene.debug_mode == 0 and precision in KERNEL_TIERS
            and kernel_shapes_ok(params))


def dirs_kernel_takes(params, scene: SceneParams, *, dtype: str, precision) -> bool:
    """True where bhr_tpu sends a neural frame with a texture skybox to its
    direction-plane kernel (bhr_tpu/renderer.py:210-218): no debug view,
    neural_dtype float32, the default or highest tier and a net that
    `kernel_shapes_ok` takes -- whatever the tonemap, which the epilogue
    applies."""
    return (scene.debug_mode == 0 and str(dtype) == "float32" and precision in KERNEL_TIERS
            and kernel_shapes_ok(params))


def wgmma_chunks(wt: torch.Tensor, rows: int = STREAMED_PLAN[1]) -> torch.Tensor:
    """W^T (out, in) as the streamed layout's chunks (csrc/neural_mlp.cu
    ws_desc), same shape: `rows` output channels a chunk, contiguous, each
    as wgmma's K-major B without swizzle -- for each group of 8 inputs in
    order, the chunk's groups of 8 channels, 8 inputs (16 bytes) a
    channel."""
    n, k = wt.shape
    return (wt.reshape(n // rows, rows // 8, 8, k // 8, 8).permute(0, 3, 1, 2, 4)
            .reshape(n, k).contiguous())


def prep_weights(params, *, precision, device, row_pad: int = 0, chunks: bool = False) -> tuple:
    """The kernel's operands (bhr_tpu/ops/neural_pallas.py:85-107 without
    the TPU's pads), contiguous on `device`: per layer the weights with the
    first layer's inputs zero-padded to `padded_inputs`, and the bias in
    fp32. ``default``: W^T (out, in) in bf16, the mma's B operand, each row
    followed by `row_pad` zeros (the held layout's shared-memory rows, 8),
    or with `chunks` the hidden layers' as `wgmma_chunks` (the streamed
    layout's) and the head's as it is; ``highest``: W (in, out) in fp32,
    whose slabs of rows are contiguous."""
    highest = kernel_tier(precision) == "highest"
    layers = as_surrogate(params)
    ops = []
    for i, (w, b) in enumerate(layers):
        w = w.to(device=device, dtype=torch.float32)
        if i == 0:
            w = torch.nn.functional.pad(w, (0, 0, 0, padded_inputs(w.shape[0]) - w.shape[0]))
        if not highest:
            w = torch.nn.functional.pad(w.t(), (0, row_pad)).to(torch.bfloat16)
            if chunks and i < len(layers) - 1:
                w = wgmma_chunks(w)
        ops.append((w.contiguous(), b.to(device=device, dtype=torch.float32).contiguous()))
    return tuple(ops)


def weights_stamp(params: NeuralSurrogate) -> tuple:
    """What changes when a weight or bias of `params` changes: another
    tensor, or an in-place write such as load_state_dict's."""
    return tuple((t.data_ptr(), 0 if t.is_inference() else t._version) for t in params.buffers())


def _mlp_desc(params: NeuralSurrogate, precision: str, device: torch.device, plan):
    """The kernel's MlpDesc for `params`, with its operands, kept on the
    module per tier and device (their pointers are in the descriptor) and
    prepared again once `weights_stamp` changes."""
    with tracing.span("host.params"):
        key = (precision, str(device))
        stamp = weights_stamp(params)
        held = params._kernel_operands.get(key)
        if held is None or held[0] != stamp:
            with tracing.span("setup.neural_prepare"):
                streamed = plan == STREAMED_PLAN
                ops = prep_weights(params, precision=precision, device=device,
                                   row_pad=8 if plan[3] and not streamed else 0,
                                   chunks=streamed)
                desc = MlpDesc()
                desc.n_layers = len(ops)
                for i, (w, b) in enumerate(ops):
                    desc.dims[i] = (params[i][0].shape[0] if i
                                    else padded_inputs(params[0][0].shape[0]))
                    desc.w[i] = w.data_ptr()
                    desc.b[i] = b.data_ptr()
                desc.dims[len(ops)] = params[-1][0].shape[1]
                desc.pix, desc.n_chunk, desc.nbuf, desc.regs = plan
                params._kernel_operands[key] = held = (stamp, ops, desc)
        return held[2]


def _directions_reference(params: NeuralSurrogate, camera: Camera, scene: SceneParams,
                          precision: str, device: torch.device, row0: int = 0,
                          local_shape=None):
    """The kernel's per-pixel arithmetic up to the store, plain, on any
    device: the unit direction planes (vx, vy, vz) and the capture logit
    (bhr_tpu/ops/neural_pallas.py:155-336 operation for operation, with
    the MLP through mlp_apply at `precision`), over the frame or the band
    of `local_shape` rows from `row0`."""
    kerr = params.model == "kerr"
    f32 = torch.float32
    p = build_params(camera, scene, TraceConfig()).to(device)
    cam, fwd, right, up, bh = (p[i:i + 3] for i in (_P_CAM, _P_FWD, _P_RIGHT, _P_UP, _P_BH))
    rs, fovf, spin = p[_P_RS], p[_P_FOVF], p[_P_SPIN]
    h, w = _local_shape(scene, 1, local_shape)

    # ray-gen (core/camera.generate_rays), normalised by rsqrt; the band's
    # rows in integers, then converted, against the frame's height
    u = (torch.arange(w, dtype=f32, device=device)[None, :] / p[_P_WF] - 0.5) * 2.0 * p[_P_ASPECT]
    rows = (torch.arange(h, device=device) + int(row0)).to(f32)
    v = (rows[:, None] / p[_P_HF] - 0.5) * -2.0
    uf, vf = u * fovf, v * fovf
    d = [fwd[i] + right[i] * uf + up[i] * vf for i in range(3)]
    inv = rsqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    dx, dy, dz = (di * inv for di in d)

    # plane basis: u_hat is a per-frame constant
    rel = [cam[i] - bh[i] for i in range(3)]
    r0 = sqrt_rn(rel[0] * rel[0] + rel[1] * rel[1] + rel[2] * rel[2])
    ux, uy, uz = (ri / r0 for ri in rel)
    c = dx * ux + dy * uy + dz * uz
    wx, wy, wz = dx - c * ux, dy - c * uy, dz - c * uz
    s_raw = sqrt_rn(wx * wx + wy * wy + wz * wz)
    s_inv = 1.0 / torch.clamp_min(s_raw, 1e-12)
    whx, why, whz = wx * s_inv, wy * s_inv, wz * s_inv
    s = torch.clamp(s_raw, 0.0, 1.0)

    # features (models/neural.ray_features; the Kerr spin block)
    ones = torch.ones_like(c)
    r0s = r0 * s
    t = r0s / (_BC_FACTOR * rs) - 1.0
    feats = [(rs / r0) * ones, c, s, torch.clamp(_BC_FACTOR * rs / (r0s + 1e-6), 0.0, 4.0),
             (0.25 * rs) * ones, (0.25 * torch.log(r0)) * ones,
             0.2 * torch.log(torch.abs(t) + 1e-3), torch.tanh(8.0 * t), *fourier_octaves(c, s)]
    if kerr:
        nyp = uz * whx - ux * whz
        xi = spin * nyp
        t = criticality_kerr(r0, rs, s, xi)  # the envelope's coordinate is tk
        feats += [spin * ones, xi, (spin * uy) * ones, spin * why,
                  0.2 * torch.log(torch.abs(t) + 1e-3), torch.tanh(8.0 * t)]
    weights = [(wi.to(device), bi.to(device)) for wi, bi in params]
    out = mlp_apply(weights, torch.stack(feats, dim=-1).reshape(h * w, -1),
                    precision=precision).reshape(h, w, -1)

    # envelope, rotation by delta (and the tilt chi), renormalisation
    e_d = envelope(r0, rs, s, c, t)
    cos_phi, sin_phi = rotate_in_plane(c, s, out[..., 0] * e_d)
    if kerr:
        chi = out[..., 1] * (e_d * (torch.abs(spin) + 1e-3))
        cc, sc = torch.cos(chi), torch.sin(chi)
        nxp = uy * whz - uz * why
        nzp = ux * why - uy * whx
        a, b = cc * cos_phi, cc * sin_phi
        vx = a * ux + b * whx + sc * nxp
        vy = a * uy + b * why + sc * nyp
        vz = a * uz + b * whz + sc * nzp
    else:
        vx = cos_phi * ux + sin_phi * whx
        vy = cos_phi * uy + sin_phi * why
        vz = cos_phi * uz + sin_phi * whz
    vinv = rsqrt(vx * vx + vy * vy + vz * vz)
    return vx * vinv, vy * vinv, vz * vinv, out[..., -1]


def neural_render_packed_reference(params, camera: Camera, scene: SceneParams, *,
                                   seed: int = 2020, precision="default", device,
                                   row0: int = 0, local_shape=None) -> torch.Tensor:
    """The frame kernel's plain PyTorch version, on any device -> packed
    int32 (H, W), or the band `row0` / `local_shape`: `_directions_reference`,
    then the star field, captured rays (a positive logit) black,
    round-half-up (bhr_tpu/ops/neural_pallas.py:345-362)."""
    vx, vy, vz, logit = _directions_reference(as_surrogate(params), camera, scene,
                                              kernel_tier(precision), torch.device(device),
                                              row0, local_shape)
    r_, g_, b_ = procedural_background(vx, vy, vz, seed=seed)
    live = (logit <= 0.0).to(torch.float32)
    return pack_rgba8_planes(r_ * live, g_ * live, b_ * live, half_up=True)


def _trace_result(vel: torch.Tensor, status: torch.Tensor, camera: Camera,
                  scene: SceneParams) -> TraceResult:
    """The TraceResult of a neural trace (bhr_tpu/ops/neural_pallas.py:
    506-516): final_pos the camera position (an expanded view: shading
    reads it for the disk only, and the surrogate has none), steps
    max_steps everywhere. Built by fill kernels: no host sync."""
    h, w = status.shape
    return TraceResult(
        final_pos=on_device(camera.position, vel.device).expand(h, w, 3),
        final_vel=vel,
        status=status,
        steps=torch.full((h, w), scene.max_steps, dtype=torch.int32, device=vel.device),
    )


def neural_trace_dirs_reference(params, camera: Camera, scene: SceneParams, *,
                                precision="default", device, row0: int = 0,
                                local_shape=None) -> TraceResult:
    """`neural_trace_dirs`'s plain PyTorch version, on any device: the
    frame kernel's plain version up to the rotation and renormalisation,
    without the star field; status is STATUS_CAPTURED where the logit is
    positive, else STATUS_ESCAPED."""
    vx, vy, vz, logit = _directions_reference(as_surrogate(params), camera, scene,
                                              kernel_tier(precision), torch.device(device),
                                              row0, local_shape)
    status = torch.where(logit > 0.0, STATUS_CAPTURED, STATUS_ESCAPED).to(torch.int32)
    return _trace_result(torch.stack([vx, vy, vz], dim=-1), status, camera, scene)


def _launch(params: NeuralSurrogate, camera, scene, precision: str, plan, device: torch.device,
            seed, row0: int, shape, out, vel, status) -> None:
    """Launch csrc/neural_mlp.cu on the current stream over the `shape`
    (rows, width) from row `row0` into `out` (the packed frame) or into
    `vel` and `status` (the direction planes)."""
    from ..utils.build import load_neural_mlp

    lib = load_neural_mlp()
    desc = _mlp_desc(params, precision, device, plan)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.bhr_neural_render(
        _kernel_params(camera, scene, TraceConfig(), row0), seed_term(seed),
        int(params.model == "kerr"), int(precision == "highest"), shape[0], shape[1], desc,
        device.index, *(None if t is None else t.data_ptr() for t in (out, vel, status)),
        stream,
    )
    _raise_on_error(lib, rc, "neural_render launch")


def _count_net(params: NeuralSurrogate, plan) -> None:
    """Count a successful launch by its net: a Kerr net's, and one of the
    streamed layout (neural_fused_kernel_ws)."""
    tracing.COUNTS["launch.neural_mlp.kerr"] += params.model == "kerr"
    tracing.COUNTS["launch.neural_mlp.streamed"] += plan == STREAMED_PLAN


def _plan(params: NeuralSurrogate, precision: str) -> tuple[int, int, int, int]:
    """`kernel_plan`, or a ValueError for a net no block holds."""
    plan = kernel_plan(params, precision)
    if plan is None:
        raise ValueError(f"the neural kernel has no block for a net of {len(params)} layers and "
                         f"hidden widths {params.widths} at precision {precision!r}: it takes up "
                         f"to {MAX_LAYERS} layers of widths that are multiples of 128, up to "
                         "1152 (default) or 1024 (highest) (see kernel_plan)")
    return plan


def neural_render_packed(params, camera: Camera, scene: SceneParams, *, seed: int = 2020,
                         precision="default", device, out: torch.Tensor | None = None,
                         row0: int = 0, local_shape=None) -> torch.Tensor:
    """One neural frame as a single kernel launch -> packed int32 (H, W)
    (bhr_tpu/ops/neural_pallas.py:421-461); with `local_shape` (band_h, W),
    the band of rows [row0, row0 + band_h) of that frame, bit for bit its
    rows (N4; ray-gen divides by the frame's height).

    `params` is a NeuralSurrogate (Schwarzschild or Kerr by its shapes; the
    Kerr spin comes from the scene) or a sequence of (W, b); `precision`
    is "default" (or None) or "highest". On a CPU device this is
    `neural_render_packed_reference`. On a CUDA device it launches
    csrc/neural_mlp.cu on the current stream, without a host sync (the
    weights are prepared on the device at the first call and kept on the
    module), and raises when CUDA is not available or the launch fails. On
    either device it raises for a net that `kernel_plan` finds no block
    for. `out`, if given, is a contiguous int32 (H, W) tensor on `device`
    that receives the frame or band.
    """
    with tracing.span("kernel.neural_mlp"):
        params = as_surrogate(params)
        precision = kernel_tier(precision)
        plan = _plan(params, precision)
        device = _kernel_device(device, "neural_render_packed")
        shape = _local_shape(scene, 1, local_shape)
        if out is not None:
            _check_out(out, shape, torch.int32, device, "out")
        if device.type == "cpu":
            frame = neural_render_packed_reference(params, camera, scene, seed=seed,
                                                   precision=precision, device=device, row0=row0,
                                                   local_shape=local_shape)
            return frame if out is None else out.copy_(frame)
        if out is None:
            out = torch.empty(shape, dtype=torch.int32, device=device)
        _launch(params, camera, scene, precision, plan, device, seed, row0, shape, out, None, None)
        tracing.COUNTS["launch.neural_mlp"] += 1
        tracing.COUNTS["launch.neural_mlp.band"] += local_shape is not None
        _count_net(params, plan)
        return out


def neural_render_packed_band(params, camera: Camera, scene: SceneParams, row0: int,
                              band_h: int, *, seed: int = 2020, precision="default",
                              device) -> torch.Tensor:
    """Rows [row0, row0 + band_h) of a neural frame -> packed int32
    (band_h, W) (bhr_tpu/ops/neural_pallas.py:519-550, N4): one
    neural_mlp launch, as `neural_render_packed` with that band. Unlike
    bhr_tpu's, it takes the precision tier."""
    return neural_render_packed(params, camera, scene, seed=seed, precision=precision,
                                device=device, row0=row0,
                                local_shape=(band_h, scene.screen_width))


def neural_trace_dirs(params, camera: Camera, scene: SceneParams, *, precision="default",
                      device, out: TraceResult | None = None, row0: int = 0,
                      local_shape=None) -> TraceResult:
    """The neural deflection field of one frame as a single kernel launch
    -> TraceResult (bhr_tpu/ops/neural_pallas.py:464-516): final_vel the
    predicted unit directions, status STATUS_CAPTURED where the capture
    logit is positive and STATUS_ESCAPED elsewhere, final_pos the camera
    position and steps max_steps (see `_trace_result`). It feeds the
    shading epilogue of frames with a texture skybox.

    `params`, `precision`, `row0` and `local_shape` as `neural_render_packed`
    takes them, and it raises for the same nets. On a CPU device this is
    `neural_trace_dirs_reference`. On a CUDA device it launches
    csrc/neural_mlp.cu with its direction-plane outputs on the current
    stream, without a host sync, and raises when CUDA is not available or
    the launch fails. `out`, if given, is a TraceResult on `device` whose
    contiguous final_vel fp32 (H, W, 3) and status int32 (H, W) receive
    the planes; its final_pos and steps are not written.
    """
    with tracing.span("kernel.neural_mlp"):
        params = as_surrogate(params)
        precision = kernel_tier(precision)
        plan = _plan(params, precision)
        device = _kernel_device(device, "neural_trace_dirs")
        h, w = _local_shape(scene, 1, local_shape)
        if out is not None:
            _check_out(out.final_vel, (h, w, 3), torch.float32, device, "out.final_vel")
            _check_out(out.status, (h, w), torch.int32, device, "out.status")
        if device.type == "cpu":
            result = neural_trace_dirs_reference(params, camera, scene, precision=precision,
                                                 device=device, row0=row0, local_shape=local_shape)
            if out is None:
                return result
            out.final_vel.copy_(result.final_vel)
            out.status.copy_(result.status)
            return _trace_result(out.final_vel, out.status, camera, scene)
        vel = torch.empty((h, w, 3), dtype=torch.float32, device=device) if out is None \
            else out.final_vel
        status = (torch.empty((h, w), dtype=torch.int32, device=device) if out is None
                  else out.status)
        _launch(params, camera, scene, precision, plan, device, 0, row0, (h, w), None, vel, status)
        tracing.COUNTS["launch.neural_mlp.dirs"] += 1
        _count_net(params, plan)
        return _trace_result(vel, status, camera, scene)
