"""Smoke run of bhr_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's kernels from this checkout with nvcc, one nvcc per
library started together (bhr_tpu_torch/csrc/render_mono.cu, the
monolithic trace + shade kernel, csrc/trace_planes.cu, the staged trace
kernel, csrc/shade_planes.cu, the staged epilogue's kernel,
csrc/neural_mlp.cu, the neural surrogate's kernel,
trace_planes.cu once more with the acceleration that utils/plugin.py
records from examples/plugins/paczynski_wiita.py, and csrc/probes.cu, the
probe kernels of tools/hopper_probe.py), holds every kernel
variant against its plain PyTorch version on the card, and drives the
renderer's paths:
  * the main path at 1920x1080x500, Euler on the Schwarzschild metric
    through BlackHoleRenderer.render_frame and OrbitAnimator.render_frames,
    both math tiers (one render_mono launch per frame, each of the
    instantiation with its flags fixed at 0), with the loop step that
    instantiation runs as built (tools/sass_walk.py's route walk of the
    built library's SASS), its issue floor and the kernel's share of the
    issue rate at the SM clock read under load; then its front
    end: frames issued back to back with a TimestampQuery each (no host
    sync; the queries' median within 10% of the kernel's time by CUDA
    events), 4 PathAnimator frames along the orbit (bit-equal to
    OrbitAnimator's), and render_to_dir of 2 frames read back;
  * BASELINE config 4 at 1920x1080x500 (rk4, adaptive dt, accretion disk,
    camera [15,5,0]): the fast tier one render_mono launch, the exact tier
    one trace_planes launch of the instantiation with its flags fixed at
    adaptive | disk (one launch.trace_planes.fixed a frame) and one
    shade_planes launch (the staged
    epilogue's kernel, csrc/shade_planes.cu), frame by frame and as a
    4-frame animation with no host sync; then shade_planes alone on that
    frame's exact planes, every word against the plain epilogue, its device
    time beside its bound and the plain epilogue's time;
  * BASELINE config 5 at 3840x2160x2000 (exact Kerr, spin 0.9, the disk,
    Euler, camera [15,5,0]): the same two routes, one frame held against
    the whole plain frame, then 2 orbit frames with no host sync, each held
    against the plain version on a band of 256 rows through the shadow and
    the disk (the whole plain frame takes about a minute); each fast frame
    one launch.render_mono.ks.fast, each exact frame one
    launch.trace_planes.fixed, the exact frame's planes, the frame and its
    orbit frames with the output hashes pinned in EXACT5_SHA; each launch's
    loop step as built (the instantiations with the flags fixed at 20,
    beside the exact one that reads them at run time) and its issue floor
    beside the kernel's time;
  * kerr_lt at 1920x1080x500, spin 0.9, camera [15,5,0]: fast monolithic,
    exact staged, and its step heatmap;
  * the debug step heatmap (one trace_planes launch and the epilogue);
  * a small matrix at 160x96x200: every integrator x {fixed, adaptive dt}
    x {schwarzschild, flat, kerr, kerr_lt} x tier x {the passthrough
    route, srgb-tonemapped staged};
  * the neural surrogate (integrator "neural"): a matrix at 160x96 over
    the five committed nets, both tiers and two cameras, and over seeded
    random nets of widths 128 to 1152 that reach every other block plan
    and instantiation of the kernel (PLAN_NETS); the main path at
    1920x1080 through render_frame (N1 Schwarzschild and N2 Kerr at spin
    0.9 in the default tier, N2 and N1 at the highest tier), one neural_mlp
    launch a frame; 8 OrbitAnimator frames with no host sync (no
    launch.neural_mlp.kerr or .streamed among them); 4 OrbitAnimator frames
    of N2 at 3840x2160, spin 0.9 (the benchmark's kerr09sky4k), each one
    launch of the streamed layout counted under launch.neural_mlp.kerr and
    .streamed, held against the plain version on a band of 256 rows; the
    held layout's two instantiations against their pinned SASS hashes
    (HELD_SASS); the streamed layout's wgmma sums against mma.sync's, bit
    for bit, on the committed 256-wide nets' hidden layers; the staged
    routes (srgb tonemap; "auto" resolved to "high"), with no kernel
    launch; and each variant's time beside its plain version's, its bound
    and the staged route's MLP chain through torch.matmul (cuBLAS); for
    the highest tier (the frames of N1 and N2, N2's direction planes and
    its band) the share of the fp32 bound and the kernel/chain ratio (the
    build line gives -Xptxas -v's registers and spills of its two
    instantiations, "kerr,highest" and "schwarzschild,highest");
  * texture skyboxes: at 160x96x200 with a 256x512 texture from a seed,
    every texture tier (TEX_TIERS: filter x subsample) x {euler, rk4 +
    disk, kerr} x math tier, the kernel's trace and the device epilogue
    against the all-plain frame; at 1920x1080x500 with the 2048x4096
    load_skybox(None) texture (32 MB packed on the card) the main path in
    both tiers with the bilinear, nearest and luma filters (one
    trace_planes launch a frame, the trace and the texture epilogue timed
    apart), BASELINE config 4's scene with the skybox, cache_deflection
    over 8 frames of a camera that stands still (1 launch, 8 shades), and
    8 OrbitAnimator frames with no host sync;
  * multires at 1920x1080x500, divisors 2 and 3, euler without and rk4 +
    adaptive dt with the disk, both tiers: trace_planes' strided and
    masked ray-gen against their plain versions on every pixel, then
    render_frame_multires with the star field and with the texture
    against the full frame at bhr_tpu's budget (2 launches a frame), the
    strided pass, the masked pass and the whole frame timed beside the
    full render; and 8 OrbitAnimator frames of a multires renderer;
  * the neural surrogate with a skybox (the direction-plane output of
    neural_mlp, N3): at 160x96 the five committed nets and PLAN_NETS, at
    1920x1080 N1 and N2 at both kernel tiers: directions and status
    against the plain version, the shaded frame against the all-plain
    one, and the kernel's time beside the frame kernel's;
  * row bands and the mesh (bhr_tpu_torch/parallel/mesh.py) at
    1920x1080x500 on a mesh of the one card named 4 times: the main path
    in both tiers and BASELINE config 4's exact (staged) frame through
    render_frame_sharded at (1, 4), a height that does not divide over
    sp = 7, and 4 orbit frames of render_animation_sharded at (2, 2), each
    bit-equal to the whole frame on every pixel; N4 (the neural kernel's
    band) for N1 and N2 in both kernel tiers at sp = 4, bit-equal to
    neural_render_packed's whole frame, one band against its plain version
    and its time beside the whole frame's, and with the texture (the
    direction planes' band, N3) bit-equal to render_frame's; multires
    bands at divisor 3
    (Euler fast, config 4 exact; star field and texture), each bit-equal to
    render_frame_multires;
  * plugin physics: paczynski_wiita.py through
    BlackHoleRenderer(custom_physics=) at 1920x1080x500, euler, rk4 and
    leapfrog in both tiers, one trace_planes launch a frame: the planes
    against the plain trace and the frame against the all-plain frame at
    the trace bars, and the kernel's time beside the plain version's;
    then 3 OrbitAnimator frames of the plugin at 3840x2160x500 in the
    exact tier (the benchmark's pw4k), each one trace_planes launch of the
    plugin's build, one shade_planes launch and no render_mono, the plugin
    recorded once in the process (plugin.records), with the profiler's
    name of the kernel the launch runs;
  * every exact plane and frame held above -- the main path's frame,
    config 4's frame and planes, its strided and masked passes (and the
    main path's), rk4 and leapfrog exact render_mono frames and
    trace_planes planes, kerr_lt's, config 5's frame and planes, the
    plugin's planes and its 4K orbit frames and planes -- bit-equal to
    its plain version on 100% of its pixels (the phases themselves hold
    EXACT_SAME_MIN);
  * the probes (python -m bhr_tpu_torch.tools.hopper_probe, the questions
    of bhr_tpu's six probe scripts): probe_ieee over 4M inputs (every
    divide and root against the correctly rounded result, the Markstein
    and rsqrt sequences bit-equal to their plain versions; the exact
    tier's quotients by a shared denominator, csrc/common.cuh div_shared,
    bit-equal to __fdiv_rn, sign of zero included, on those inputs, every
    denominator mantissa of [1, 2), the loop's ranges and an edge set; the
    exact Kerr-Schild loop's reciprocals and roots behind its group guard
    bit-equal to __fdiv_rn(1, x) and __fsqrt_rn on every non-negative
    float32, and its escape threshold deciding as the root does on every
    float32),
    probe_gather from __constant__, shared and device memory and by warp
    shuffles (exact on the probes' shapes and on 1920x1080 lookups, and ns a
    lookup), probe_dot at the bf16, bf16x3 and fp32 tiers against a
    float64 product (within 1e-2, 1e-5 and 1e-5 of max |C|) and at the
    neural probes' shapes (the bf16 chain with its sums rounded to bf16),
    probe_concat's sublane concatenations bit-equal to their plain
    versions, and the Kerr net through neural_mlp; it prints every check
    and every answer line.
Each path is driven with the launch counts set to 0 just before it and
read just after. Every frame is held against its plain version on the same
inputs: exact tier packed words bit-equal on >= 99.9% of pixels, fast tier
channels within 1 level on >= 99.5%, and in both tiers the kernel's ray
status agrees with the plain version's on >= 99.5% of pixels and every
ray the plain version captures is black in the kernel's frame on >= 99.5%
of them. Neural frames are held to bhr_tpu's bars for its neural kernel
(tests/test_neural.py:262-266, tests/test_neural_kerr.py:478-479): the
default tier bit-equal on >= 99% of pixels, off by more than 2 levels on
<= 0.1%, its capture (black) mask equal on >= 99.9%; the highest tier
bit-equal on >= 99.9% -- the matrix sums are taken in another order
(bf16 operands in the tensor cores against cuBLAS's fp32 products), and
near the capture fold a last-bit difference in an output moves a pixel.
The strided and masked traces are held like any trace_planes launch, on
every pixel (exact tier: every plane bit-equal on >= 99.9%; both tiers:
status and steps equal on >= 99.5%, directions within 1e-4 on >= 99.5% of
the matched rays). A multires frame is held to bhr_tpu's budget against
the full frame (tests/test_multires.py:97-151: mean error under 3 levels,
pixels off by more than 16 levels under 4%). The direction planes are
held on status (equal on >= 99.9%) and direction: within 1e-6 on >= 99.9%
at the highest tier (the fp32 sums are taken in another order than
cuBLAS's: an ulp, 1.2e-7, on about a tenth of the pixels of a random
net), within 1e-4 on >= 99.5% at the default tier. Bands are held
bit-equal to the whole frame's rows on 100% of pixels; the plugin's
kernel as any trace_planes trace and frame.
Each phase prints one line; any failed check raises, so the
script exits non-zero and prints no result. The line before the last is a
JSON record of every kernel variant (its launches on the paths driven, its
time and its plain version's, and its bound: the larger of the operations
it must do over the card's peak for their type -- fp32 at 67 TFLOP/s, the
neural default tier's products at 989 TFLOP/s bf16 -- and the bytes it
must write over 3.35 TB/s; for the neural kernel also the cuBLAS MLP
chain's time and, at the default tier, the bf16 tensor-core chain's
(bf16_chain_ms), whose floor (tools/neural_floor.py: mma.sync rate, SASS
issue and L2 terms measured in this run) and share the neural_timing lines
print before the kernel's time; for a probe kernel, its bytes or its products at the bf16
or fp32 peak, its device time with the host's issue hidden, and the one
PyTorch call of the same function where there is one); the last line is
{"ok": true, "device": {...}}.

Needs one CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import json
import os
import re
import statistics
import subprocess
import tempfile
import time

import torch

W, H, STEPS = 1920, 1080, 500
W5, H5, STEPS5 = 3840, 2160, 2000  # BASELINE config 5 (scripts/golden_diff.py:50-51)
BAND5 = (H5 // 2 - 128, H5 // 2 + 128)  # rows held against the plain version per orbit frame
CONFIG5_FRAMES = 2
# BASELINE config 5's exact outputs, as they were before its launch took the
# instantiation with its flags fixed (sha256 of the bytes, 16 hex digits, as
# tools/time_trace.py's output_sha256): the planes of its frame, the frame,
# and its CONFIG5_FRAMES orbit frames
EXACT5_SHA = {"planes": "d971d8b272a95dc5", "frame": "cf2c9c47fcbea4b7", "orbit0": "cf2c9c47fcbea4b7",
              "orbit1": "89edee72cb9265d8"}
SPIN = 0.9
SMALL = (160, 96, 200)
N_FRAMES = 8
REPEATS = 5  # timed runs of N_FRAMES kernel frames; the median is reported
BASELINE_FRAMES = 4
# Keys of the launch counts (bhr_tpu_torch/utils/tracing.COUNTS)
N_MONO, N_TRACE = "launch.render_mono", "launch.trace_planes"
N_STRIDED, N_MASKED, N_CUSTOM = (f"{N_TRACE}.{v}" for v in ("strided", "masked", "custom"))
N_MONO_KS, N_TRACE_KS = f"{N_MONO}.ks", f"{N_TRACE}.ks"  # the Kerr-Schild launches
N_MONO_KS_FAST, N_TRACE_KS_FAST = f"{N_MONO_KS}.fast", f"{N_TRACE_KS}.fast"  # fast tier's
N_FIXED = f"{N_TRACE}.fixed"  # trace_planes launches of an instantiation with fixed flags
N_NEURAL = "launch.neural_mlp"
N_DIRS, N_BAND = f"{N_NEURAL}.dirs", f"{N_NEURAL}.band"
N_NEURAL_KERR, N_STREAMED = f"{N_NEURAL}.kerr", f"{N_NEURAL}.streamed"  # by net and layout
KERR_SKY_FRAMES = 4  # 4K orbit frames of the Kerr net (bench_torch's kerr09sky4k)
PW4K_FRAMES = 3  # 4K exact orbit frames of the plugin (bench_torch's pw4k)
N_RECORDS = "plugin.records"  # recordings of a physics plugin, over the whole process
# The held layout's instantiations (csrc/neural_mlp.cu neural_fused_kernel<·,
# 128>), pinned to the SASS they had before the streamed layout moved to
# wgmma (sass_walk.function_hash of nvcc 12.8's build for sm_90a): the
# Schwarzschild orbit cell runs the first.
HELD_SASS = {"neural_fused_kernelILb0ELi128E": "534c177058543837",
             "neural_fused_kernelILb1ELi128E": "06a4d1b4edb7940b"}
N_SHADE, N_PLAIN = "launch.shade_planes", "epilogue.plain"
# Bars of a kernel against its plain version.
EXACT_SAME_MIN = 0.999  # bit-equal packed words (tests/test_pallas_parity.py:484-491)
FAST_MIN = 0.995  # every channel within 1 level
STATUS_MIN = 0.995  # ray status agrees; captured rays are black in the frame
SIDE = ([15.0, 5.0, 0.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])  # scripts/golden_diff.py:128
STATUS_CAPTURED = 2  # bhr_tpu_torch.ops.trace.STATUS_CAPTURED
STATUS_DISK = 3
# The card's peaks for the bound (NVIDIA H100 SXM data sheet): fp32 outside
# the tensor cores, and device memory.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# fp32 operations of one ray-step, counted from bhr_tpu_torch/csrc/
# trace_ray.cuh: each add, sub, mul, div, sqrt, rsqrt, rcp, min and max is
# one operation, an FMA two. What a step evaluates more than once on the
# same inputs counts once, and values of the launch's constants alone (4 a^2,
# the radius guard, the drag's j) not at all; the per-ray ray-gen, initial
# momentum and shading are left out. Keys: (model, tier, integrator) at
# fixed dt with no disk; step_ops adds adaptive dt and the disk test.
#  * Schwarzschild. Exact: loop test |rel| 6, accel 30 (10 of them on the
#    position alone), axpy 6, guarded radius 7, renormalisation 9; euler
#    6 + 30 + 2 axpys + 9; rk4 6 + 4 accels + 1 + 3 radii + 8 axpys + 2
#    weighted sums of 15 + 9; leapfrog 6 + 30 + 2 axpys + 7 + 30 + 6 + 20
#    (the last accel shares the position terms at new_rel) + 6 + 9. Fast:
#    euler |rel|^2 5 + physics_substep 30 + 6 + vnorm 9; sl_deriv 33 (17 on
#    the position alone; the first one's |rel|^2 is the loop test's); rk4 4
#    sl_deriv + 8 axpys + 2 weighted sums of 12 + 9; leapfrog 33 + 2 axpys +
#    33 + 6 + 16 + 6 + 9.
#  * kerr_lt adds the drag to each acceleration: exact 23 (11 on the
#    position alone), fast 26 (14) in sl_deriv, 29 in physics_substep, which
#    also drops the clamp (1).
#  * Kerr-Schild: ks_all 134 = the geometry at q 95 (ks_r2 14, of which the
#    loop test's is the same; f and l 20 more; dr, df, dl 61) + s 6, f s 1,
#    dq 6, s^2/2 2, dp 24. Euler: ks_all without dq 128 + axpy 6 + dq at
#    (q, p') 13 + axpy 6; rk4 4 ks_all + 8 axpys + 2 weighted sums of 15;
#    leapfrog dp at (q, p) 128, dq at (q, p_half) on the same geometry 13,
#    dq alone at q_mid 47, dp at (q', p_half) 128, dp at (q', p_pred) on the
#    same geometry 33, 5 axpys. The exact tier adds the escape test's |q| 1.
#    The fast tier's own form (dp through r, SFU roots): the geometry at q
#    49 (|q|^2 5, radii 19 with two rsqrts and two rcps, f and l 12, the
#    gradient through r 13), dq's terms at p 13 as above, dp's 41 (s 6, f s
#    1, s^2/2 2, u_r and K 14, the three components 18). Euler: 49 + 41 +
#    axpy 6 + 13 + axpy 6; rk4 4 (49 + 41 + 6) + 8 axpys + 2 weighted sums
#    of 15; leapfrog dp at (q, p) 90, dq at (q, p_half) 13, dq alone at q_mid
#    (the geometry without its gradient, 36) 49, dp at (q', p_half) 90, dp
#    at (q', p_pred) on the same geometry 41, 5 axpys.
OPS_PER_STEP = {
    ("schwarzschild", "exact", "euler"): 57, ("schwarzschild", "exact", "rk4"): 235,
    ("schwarzschild", "exact", "leapfrog"): 126, ("schwarzschild", "fast", "euler"): 50,
    ("schwarzschild", "fast", "rk4"): 213, ("schwarzschild", "fast", "leapfrog"): 115,
    ("kerr_lt", "exact", "euler"): 57 + 23, ("kerr_lt", "exact", "rk4"): 235 + 4 * 23,
    ("kerr_lt", "exact", "leapfrog"): 126 + 2 * 23 + 12, ("kerr_lt", "fast", "euler"): 50 - 1 + 29,
    ("kerr_lt", "fast", "rk4"): 213 + 4 * 26, ("kerr_lt", "fast", "leapfrog"): 115 + 2 * 26 + 12,
    ("kerr", "exact", "euler"): 154, ("kerr", "exact", "rk4"): 615,
    ("kerr", "exact", "leapfrog"): 380, ("kerr", "fast", "euler"): 115,
    ("kerr", "fast", "rk4"): 462, ("kerr", "fast", "leapfrog"): 313,
}
# Adaptive dt: 5 operations on the loop's radius, the fast tier's radius
# r^2 rsqrt(r^2) (1 where the step has the rsqrt; none for Kerr-Schild,
# whose geometry takes r so), and the dt-scaled step sizes the integrator
# rebuilds every step.
ADAPTIVE_STEP_SIZES = {"euler": 0, "rk4": 2, "leapfrog": 1}  # dt/2, dt/6
DISK_OPS = 1  # the crossing test's sign product
# packed word; 6 fp32 + 2 int32 planes; the masked launch also reads its fp32 mask
BYTES_PER_PIXEL = {"render_mono": 4, "trace_planes": 32, "trace_planes[strided]": 32,
                   "trace_planes[masked]": 36}
# The neural kernel (csrc/neural_mlp.cu). Its bound is the largest of the
# MLP's FLOPs (2 in * out a layer a pixel) over the tensor cores' bf16 peak
# (default tier) or the fp32 peak (highest), the per-pixel fp32 operations
# over the fp32 peak, and the 4 bytes a pixel written over the memory rate.
# Per-pixel operations, counted from the kernel as OPS_PER_STEP is (each
# add, sub, mul, div, min, max, abs, floor, sqrt, rsqrt and each tanh,
# log, log1p, exp, sin and cos one operation; values of the launch's
# constants alone, such as rs / r0, not at all; the star field's integer
# hashing not at all): ray-gen 30, plane basis 24, the 16 features 33,
# envelope and rotation 21, direction 9 (Kerr: the tilt 27), renormalising
# 9, the star field 345, quantizing 18, the head's biases 2; Kerr adds 33
# for its 6 features and 1 bias. Each hidden unit adds its bias and tanh.
PEAK_BF16_TENSOR = 989e12
NEURAL_PIXEL_OPS = {"schwarzschild": 30 + 24 + 33 + 21 + 9 + 9 + 345 + 18 + 2,
                    "kerr": 30 + 24 + 33 + 33 + 21 + 27 + 9 + 345 + 18 + 3}
NEURAL_DEFAULT_BARS = dict(same=0.99, off2=1e-3, black=0.999)
NEURAL_HIGHEST_SAME = 0.999
NEURAL_ASSETS = {  # (model, asset)
    "n1": ("schwarzschild", "neural_schwarzschild.npz"),
    "n1_fp32": ("schwarzschild", "neural_schwarzschild.npz"),  # the same net at "highest"
    "n1_orbit": ("schwarzschild", "neural_schwarzschild_orbit.npz"),
    "n1_xl": ("schwarzschild", "neural_schwarzschild_orbit_xl.npz"),
    "n2": ("kerr", "neural_kerr.npz"),
    "n2_fp32": ("kerr", "neural_kerr_default.npz"),
}
# Seeded random nets, hidden widths (w, 128, w), that reach every block plan
# of csrc/neural_mlp.cu the committed nets do not (ops/neural_kernel.
# kernel_plan: pixels per block, channels per weight chunk (default tier)
# or W rows per weight slab (highest), chunk buffers, register width of the
# fused layout), the one held instantiation they do not (Kerr, 128 wide)
# and the streamed layout's mixed widths (Kerr, 256 then 128);
# tests/test_torch_neural.py:PLAN_NETS is the same list and checks
# that it covers every plan): (tier, model, w, seed), each seed picked so
# that the capture mask is mixed at both cameras.
PLAN_NETS = (("default", "kerr", 128, 0), ("default", "kerr", 256, 0),
             ("default", "kerr", 384, 0), ("default", "schwarzschild", 512, 4),
             ("default", "kerr", 640, 0), ("default", "schwarzschild", 1152, 0),
             ("highest", "schwarzschild", 384, 0), ("highest", "kerr", 512, 0),
             ("highest", "schwarzschild", 640, 0), ("highest", "kerr", 768, 0),
             ("highest", "schwarzschild", 1024, 2))
# The staged epilogue's kernel (csrc/shade_planes.cu), counted as
# NEURAL_PIXEL_OPS is: the star field 345 and quantizing 18 a pixel of sky,
# a disk pixel's emission 104 (its hit point 3, radius 6, Kepler speed 5,
# tangent 10 and velocity 3, beta 6, v_hat 4, direction 9, cos 5, Doppler
# 6, emitter's redshift 6, g 3, temperature 4 and over g 1, table index 6
# and weights 2, beaming 3, edge 4, T / T_isco 1, intensity 5, colour 12;
# the observer's redshift is the launch's constant) and quantizing 18; a
# captured pixel quantizing 18. Bytes: direction 12, status 4 and the word
# 4 a pixel, the hit point 12 more a disk pixel.
SHADE_STAR_OPS, SHADE_DISK_OPS, SHADE_QUANT_OPS = 345, 104, 18
SHADE_BYTES, SHADE_DISK_BYTES = 20, 12
# Texture tiers (filter, subsample) of the small texture matrix, and the
# bars of the direction-plane kernel (N3) against its plain version.
TEX_TIERS = (("bilinear", 1), ("nearest", 1), ("luma", 1), ("bilinear", 2),
             ("bilinear", "checker"), ("nearest", 3))
SMALL_TEXTURE = (256, 512)
DIVISORS = (2, 3)
MULTIRES_MEAN_MAX, MULTIRES_OFF16_MAX = 3.0, 0.04
DIRS_STATUS_MIN = 0.999
DIRS_CLOSE, DIRS_DEFAULT_MIN = 1e-4, 0.995
DIRS_HIGHEST_CLOSE, DIRS_HIGHEST_MIN = 1e-6, 0.999
# What the direction-plane output leaves out of the neural kernel's
# per-pixel operations (the star field and the quantizer), and what it
# writes: 3 fp32 and 1 int32 a pixel.
NEURAL_SHADE_OPS = 345 + 18
DIRS_BYTES_PER_PIXEL = 16
# The default tier's instantiations the main path runs (ops/neural_kernel.
# kernel_plan's register width of the committed nets): the kernels line
# names them neural_mlp<model,default>; the other fused one is
# neural_mlp[fused]<model,width>, the chunked layout's (nets wider than
# 256) neural_mlp[chunked]<model,default>. Besides the committed nets, the
# timing phase times at full width the PLAN_NETS net of each that no
# committed net reaches: (model, width, seed).
MAIN_REGS = {"schwarzschild": 128, "kerr": 256}
TIMED_PLAN_NETS = {"neural_mlp[fused]<kerr,128>": ("kerr", 128, 0),
                   "neural_mlp[chunked]<kerr,default>": ("kerr", 384, 0),
                   "neural_mlp[chunked]<schwarzschild,default>": ("schwarzschild", 512, 4)}
# Bands and the mesh: the bands of a frame (sp), the height that does not
# divide over sp = 7, the (dp, sp) of the orbit frames, and the multires
# bands' divisor.
SP, SP_ODD, ANIM_MESH, BAND_DIVISOR = 4, 7, (2, 2), 3
# Plugin physics: the plugin, and the fp32 operations of a ray-step of the
# exact loop it runs in both tiers besides its accelerations, (others,
# calls): Schwarzschild's exact count less SCHW_ACCEL_OPS a call, where
# leapfrog's last call counted only its 20 ray-varying operations past the
# LEAPFROG_SHARED_OPS position terms it shares with the call before (the
# plugin's call is recorded whole). Each call adds the recorded plugin's
# ray-varying operations (utils/plugin.Program.varying_ops).
PLUGIN = "examples/plugins/paczynski_wiita.py"
SCHW_ACCEL_OPS, LEAPFROG_SHARED_OPS = 30, 10
ACCEL_CALLS = {"euler": 1, "rk4": 4, "leapfrog": 3}
CUSTOM_STEP_OPS = {
    integ: (OPS_PER_STEP[("schwarzschild", "exact", integ)] - calls * SCHW_ACCEL_OPS
            + (LEAPFROG_SHARED_OPS if integ == "leapfrog" else 0), calls)
    for integ, calls in ACCEL_CALLS.items()}
REPLACES = {
    ("render_mono", "schwarzschild"): "bhr_tpu/ops/pallas_trace.py:1280",
    ("trace_planes", "schwarzschild"): "bhr_tpu/ops/pallas_trace.py:1151 and :1335",
    ("render_mono", "kerr"): "bhr_tpu/ops/pallas_trace.py:548-700 (K6, in :1280)",
    ("trace_planes", "kerr"): "bhr_tpu/ops/pallas_trace.py:548-700 (K6, in :1151 and :1335)",
    ("render_mono", "kerr_lt"): "bhr_tpu/ops/pallas_trace.py:486-496 and :821-831 (K7, in :1280)",
    ("trace_planes", "kerr_lt"): "bhr_tpu/ops/pallas_trace.py:385-397, :486-496 and :821-831 "
                                 "(K7, in :1151 and :1335)",
    ("neural_mlp", "schwarzschild"): "bhr_tpu/ops/neural_pallas.py:135 (N1, _build_kernel "
                                     "emit='frame', called at :408)",
    ("neural_mlp", "kerr"): "bhr_tpu/ops/neural_pallas.py:229-267 and :318-330 (N2, in :135)",
    "strided": "bhr_tpu/ops/pallas_trace.py:745-755 (K4 strided ray-gen, in :1151; "
               "pallas_trace_image(stride=, local_shape=) :1941)",
    "masked": "bhr_tpu/ops/pallas_trace.py:769-783 (K4 masked ray-gen, in :1151; "
              "pallas_trace_image(mask=) :1941)",
    "dirs": "bhr_tpu/ops/neural_pallas.py:338-343 (N3, _build_kernel emit='dirs', called at "
            ":408 through neural_trace_dirs :464)",
    "band": "bhr_tpu/ops/neural_pallas.py:519-550 (N4, neural_render_packed_band, via _render "
            ":372 and pallas_call :408; called by bhr_tpu/parallel/mesh.py:116-120)",
    "custom": "bhr_tpu/ops/pallas_trace.py:351-361 and :1521-1650 (K5 with model='custom': "
              "kernel :1335's generic body, via _pallas_trace :1746 and pallas_call :1800)",
    "shade_planes": "no Pallas kernel: bhr_tpu leaves the staged epilogue "
                    "(bhr_tpu/renderer.py:316-395) to XLA's fusion",
    "probe_ieee": "scripts/ieee_probe.py:70 (run_kernel: k_div :80, k_sqrt :84, k_rsqrt :88, "
                  "k_recip_approx :92, k_mark :109, k_sqrt_seq :124)",
    "probe_gather": "scripts/gather_probe2.py:30, scripts/lut_butterfly_probe.py:31 and :152, "
                    "scripts/pallas_gather_bench.py:32 and :149",
    "probe_dot": "scripts/neural_precision_probe.py:53 (kernel_for :25), "
                 "scripts/neural_kernel_probe.py:52, :92, :111, :133, :155 (probe_k16_dot, "
                 "probe_hidden_chain, probe_head, probe_bf16_chain, probe_kerr_dot)",
    "probe_concat": "scripts/neural_kernel_probe.py:70 (probe_sublane_concat :60) and :177 "
                    "(probe_kerr_concat :163)",
}


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def compare(kernel_packed: torch.Tensor, plain_packed: torch.Tensor, fast: bool,
            kernel_status: torch.Tensor, plain_status: torch.Tensor, *,
            heatmap: bool = False) -> dict:
    """Hold a kernel frame against its plain version; raise if a bar fails.

    Capture is held on the ray status: the kernel's status plane (same
    configuration and tier) agrees with the plain version's on >=
    STATUS_MIN of pixels, and the rays the plain version captures are
    black in the kernel's frame on >= STATUS_MIN of them -- except in a
    step heatmap (`heatmap`), which colours every ray by its step count.
    Black pixels that are dark sky count for nothing; `black_frac` is
    printed only.
    """
    k = kernel_packed.contiguous().view(torch.uint8).view(*kernel_packed.shape, 4).int()
    p = plain_packed.contiguous().view(torch.uint8).view(*plain_packed.shape, 4).int()
    if not bool((k[..., 3] == 255).all()):
        raise AssertionError("kernel frame has alpha != 255")
    diff = (k[..., :3] - p[..., :3]).abs().amax(-1)
    k_black = (k[..., :3] == 0).all(-1)
    captured = plain_status == STATUS_CAPTURED
    stats = {
        "bit_same": (kernel_packed == plain_packed).float().mean().item(),
        "within_1": (diff <= 1).float().mean().item(),
        "max_abs_err": int(diff.max().item()),
        "status_agree": (kernel_status == plain_status).float().mean().item(),
        "captured_black": (k_black[captured].float().mean().item()
                           if bool(captured.any()) else 1.0),
        "captured_frac": captured.float().mean().item(),
        "black_frac": k_black.float().mean().item(),
    }
    ok = stats["bit_same"] >= EXACT_SAME_MIN if not fast else stats["within_1"] >= FAST_MIN
    ok = ok and stats["status_agree"] >= STATUS_MIN
    ok = ok and (heatmap or stats["captured_black"] >= STATUS_MIN)
    if not ok:
        raise AssertionError(f"kernel disagrees with its plain version: {stats}")
    return stats


def bar(fast: bool) -> str:
    frame = f"within_1 >= {FAST_MIN}" if fast else f"bit_same >= {EXACT_SAME_MIN}"
    return f"{frame}; status_agree, captured_black >= {STATUS_MIN}"


def fp32_timing(name: str, ms: float, bound_ms: float, chain_ms: float, smi: str) -> str:
    """One highest-tier variant's time against its fp32 bound and the
    cuBLAS MLP chain of the same call."""
    return (f"{name}: kernel {ms:.3f} ms, {bound_ms / ms:.1%} of the fp32 bound "
            f"{bound_ms:.3f} ms, cuBLAS MLP chain {chain_ms:.3f} ms, kernel/chain "
            f"{ms / chain_ms:.3f} on {smi}")


def step_ops(model: str, fast: bool, integrator: str, *, adaptive: bool, disk: bool,
             accel_ops: int = 0) -> int:
    """fp32 operations of one ray-step of a configuration (OPS_PER_STEP;
    for model "custom", CUSTOM_STEP_OPS with `accel_ops` a call)."""
    if model == "custom":  # the exact loop in both tiers
        others, calls = CUSTOM_STEP_OPS[integrator]
        n = others + calls * accel_ops + (5 + ADAPTIVE_STEP_SIZES[integrator] if adaptive else 0)
        return n + (DISK_OPS if disk else 0)
    n = OPS_PER_STEP[(model, "fast" if fast else "exact", integrator)]
    if adaptive:
        n += 5 + ADAPTIVE_STEP_SIZES[integrator] + (1 if fast and model != "kerr" else 0)
    return n + (DISK_OPS if disk else 0)


def bound(kernel: str, model: str, fast: bool, integrator: str, ray_steps: int, pixels: int, *,
          adaptive: bool, disk: bool, accel_ops: int = 0) -> tuple[float, str]:
    """(ms, 'operations' or 'bytes'): the least time the card could take
    to integrate `ray_steps` ray-steps and write `pixels` outputs."""
    ops = ray_steps * step_ops(model, fast, integrator, adaptive=adaptive, disk=disk,
                               accel_ops=accel_ops)
    t_ops = ops / PEAK_FP32 * 1e3
    t_bytes = pixels * BYTES_PER_PIXEL[kernel] / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sha16(*tensors) -> str:
    """sha256 of the tensors' bytes in order, 16 hex digits."""
    digest = hashlib.sha256()
    for t in tensors:
        digest.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return digest.hexdigest()[:16]


def cuda_ms(fn, n_frames: int, repeats: int = 1) -> float:
    """ms per frame of fn() (which renders n_frames) by CUDA events: the
    median over `repeats` runs."""
    runs = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / n_frames)
    return statistics.median(runs)


def host_ms(fn, repeats: int = 1) -> float:
    """ms the host takes to issue fn(), which returns without waiting for
    the device: the median over `repeats` calls, each made on a drained
    device. Where it comes near the frame's time by CUDA events, the frame
    waits for the host and the device idles between its kernels."""
    runs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        runs.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(runs)


def neural_compare(kernel_packed: torch.Tensor, plain_packed: torch.Tensor,
                   highest: bool) -> dict:
    """Hold a neural kernel frame against its plain version at the tier's
    bars (NEURAL_DEFAULT_BARS, NEURAL_HIGHEST_SAME); raise if one fails."""
    k = kernel_packed.contiguous().view(torch.uint8).view(*kernel_packed.shape, 4).int()
    p = plain_packed.contiguous().view(torch.uint8).view(*plain_packed.shape, 4).int()
    if not bool((k[..., 3] == 255).all()):
        raise AssertionError("kernel frame has alpha != 255")
    diff = (k[..., :3] - p[..., :3]).abs().amax(-1)
    k_black, p_black = (k[..., :3] == 0).all(-1), (p[..., :3] == 0).all(-1)
    stats = {"bit_same": (kernel_packed == plain_packed).float().mean().item(),
             "off_by_more_than_2": (diff > 2).float().mean().item(),
             "max_abs_err": int(diff.max().item()),
             "black_agree": (k_black == p_black).float().mean().item(),
             "black_frac": k_black.float().mean().item()}
    b = NEURAL_DEFAULT_BARS
    ok = (stats["bit_same"] >= (NEURAL_HIGHEST_SAME if highest else b["same"])
          and stats["off_by_more_than_2"] <= b["off2"] and stats["black_agree"] >= b["black"])
    if not ok:
        raise AssertionError(f"neural kernel disagrees with its plain version: {stats}")
    return stats


def random_net(model: str, width: int, seed: int) -> list:
    """(W, b) numpy pairs of a tanh MLP with hidden widths (width, 128,
    width) for `model`: N(0, 1/fan_in) weights (a quarter of that scale in
    the head) and biases of standard deviation 0.1, from numpy's generator
    at `seed`."""
    import numpy as np

    rng = np.random.default_rng(seed)
    kerr = model == "kerr"
    dims = [22 if kerr else 16, width, 128, width, 3 if kerr else 2]
    layers = []
    for i, (a, b) in enumerate(zip(dims, dims[1:])):
        scale = (0.25 if i == len(dims) - 2 else 1.0) / np.sqrt(a)
        layers.append((rng.standard_normal((a, b)) * scale, rng.standard_normal(b) * 0.1))
    return layers


def neural_bar(highest: bool) -> str:
    b = NEURAL_DEFAULT_BARS
    same = NEURAL_HIGHEST_SAME if highest else b["same"]
    return (f"bit_same >= {same}, off_by_more_than_2 <= {b['off2']}, "
            f"black_agree >= {b['black']}")


def neural_bound(params, model: str, highest: bool, pixels: int,
                 dirs: bool = False) -> tuple[float, str]:
    """(ms, 'operations' or 'bytes'): the least time the card could take to
    render `pixels` neural pixels with `params` (see NEURAL_PIXEL_OPS), or
    with `dirs` to write their direction planes unshaded."""
    mlp = 2 * sum(w.shape[0] * w.shape[1] for w, _ in params) * pixels
    hidden = sum(w.shape[1] for w, _ in list(params)[:-1])
    t_mlp = mlp / (PEAK_FP32 if highest else PEAK_BF16_TENSOR) * 1e3
    pixel_ops = NEURAL_PIXEL_OPS[model] - (NEURAL_SHADE_OPS if dirs else 0)
    t_pix = (pixel_ops + 2 * hidden) * pixels / PEAK_FP32 * 1e3
    t_bytes = pixels * (DIRS_BYTES_PER_PIXEL if dirs else 4) / PEAK_BYTES * 1e3
    t_ops = max(t_mlp, t_pix)
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def neural_variant(model: str, highest: bool, plan=None) -> str:
    """The kernels line's name of the neural_mlp instantiation a launch of
    `plan` runs (MAIN_REGS)."""
    if highest:
        return f"neural_mlp<{model},highest>"
    regs = MAIN_REGS[model] if plan is None else plan[3]
    if regs == 0:
        return f"neural_mlp[chunked]<{model},default>"
    if regs == MAIN_REGS[model]:
        return f"neural_mlp<{model},default>"
    return f"neural_mlp[fused]<{model},{regs}>"


def neural_floor_line(name: str, terms: dict, ms: float, smi: str) -> str:
    """One default-tier variant's floor (tools/neural_floor.py) and the
    kernel's share of it."""
    return (f"{name}: floor {terms['floor_ms']:.3f} ms ({terms['bound_by']}), the largest of "
            f"tensor {terms['tensor_ms']:.3f} ms ({terms['mma']} {terms['instruction']}), issue "
            f"{terms['issue_ms']:.3f} ms ({terms['issue_pixel']} SASS a pixel, "
            f"{terms['issue_output']} a hidden output), L2 {terms['l2_ms']:.3f} ms "
            f"({terms['weight_bytes']} bytes of weights copied); their sum "
            f"{terms['sum_ms']:.3f} ms; kernel {ms:.3f} ms, {terms['floor_ms'] / ms:.1%} of the "
            f"floor, on {smi}")


def trace_compare(k, p, fast: bool) -> dict:
    """Hold a kernel trace (TraceResult) against its plain version on every
    pixel; raise if a bar fails."""
    same = (k.status == p.status) & (k.steps == p.steps)
    vd = (k.final_vel - p.final_vel).abs().amax(-1)
    stats = {"status_steps_same": same.float().mean().item(),
             "vel_close": (vd[same] <= DIRS_CLOSE).float().mean().item(),
             "max_abs_err": vd[same].max().item(),  # of a direction, on the matched rays
             "vel_bit_same": (k.final_vel == p.final_vel).all(-1).float().mean().item(),
             "pos_bit_same": (k.final_pos == p.final_pos).all(-1).float().mean().item()}
    ok = stats["status_steps_same"] >= STATUS_MIN and stats["vel_close"] >= STATUS_MIN
    if not fast:
        ok = ok and min(stats["vel_bit_same"], stats["pos_bit_same"]) >= EXACT_SAME_MIN
    if not ok:
        raise AssertionError(f"trace disagrees with its plain version: {stats}")
    return stats


def multires_compare(multi: torch.Tensor, full: torch.Tensor) -> dict:
    """Hold a multires frame against the full frame at bhr_tpu's budget
    (uint8 (H, W, 4) frames); raise if it fails."""
    err = (multi.int() - full.int()).abs()[..., :3].float()
    stats = {"mean_err": err.mean().item(),
             "off_by_more_than_16": (err.amax(-1) > 16).float().mean().item()}
    if stats["mean_err"] >= MULTIRES_MEAN_MAX or stats["off_by_more_than_16"] >= MULTIRES_OFF16_MAX:
        raise AssertionError(f"multires frame outside the budget: {stats}")
    return stats


def dirs_compare(k, p, highest: bool) -> dict:
    """Hold the direction planes of the neural kernel (N3) against their
    plain version; raise if a bar fails."""
    vd = (k.final_vel - p.final_vel).abs().amax(-1)
    stats = {"status_agree": (k.status == p.status).float().mean().item(),
             "vel_close": (vd <= DIRS_CLOSE).float().mean().item(),
             "vel_within_1e-6": (vd <= DIRS_HIGHEST_CLOSE).float().mean().item(),
             "vel_bit_same": (vd == 0).float().mean().item(),
             "max_abs_err": vd.max().item(),
             "captured_frac": (k.status == STATUS_CAPTURED).float().mean().item()}
    ok = stats["status_agree"] >= DIRS_STATUS_MIN and (
        stats["vel_within_1e-6"] >= DIRS_HIGHEST_MIN if highest
        else stats["vel_close"] >= DIRS_DEFAULT_MIN)
    if not ok or not bool(torch.isfinite(k.final_vel).all()):
        raise AssertionError(f"direction planes disagree with their plain version: {stats}")
    return stats


def dirs_bar(highest: bool) -> str:
    vel = (f"vel within {DIRS_HIGHEST_CLOSE} on >= {DIRS_HIGHEST_MIN}" if highest
           else f"vel within {DIRS_CLOSE} on >= {DIRS_DEFAULT_MIN}")
    return f"status_agree >= {DIRS_STATUS_MIN}, {vel}"


def textured_neural_compare(frame: torch.Tensor, plain: torch.Tensor, highest: bool) -> dict:
    """Hold a neural frame shaded from a texture against the all-plain
    frame (packed words): bit-equal on the tier's share of pixels and off
    by more than 2 levels on <= 0.1%."""
    k = frame.contiguous().view(torch.uint8).view(*frame.shape, 4).int()
    p = plain.contiguous().view(torch.uint8).view(*plain.shape, 4).int()
    diff = (k[..., :3] - p[..., :3]).abs().amax(-1)
    stats = {"bit_same": (frame == plain).float().mean().item(),
             "off_by_more_than_2": (diff > 2).float().mean().item(),
             "max_abs_err": int(diff.max().item())}
    b = NEURAL_DEFAULT_BARS
    if (stats["bit_same"] < (NEURAL_HIGHEST_SAME if highest else b["same"])
            or stats["off_by_more_than_2"] > b["off2"] or not bool((k[..., 3] == 255).all())):
        raise AssertionError(f"textured neural frame disagrees with the plain one: {stats}")
    return stats


class Variants:
    """Per-variant record for the `kernels` line: main-path launches,
    the largest level difference against the plain version, the times of
    the kernel and its plain version, and the bound of the timed work.
    A variant is (kernel, tier, integrator, model); Schwarzschild and flat
    share their keys (flat is a runtime flag of the same instantiation)."""

    def __init__(self):
        self.rec = {}

    def key(self, kernel: str, fast: bool, integrator: str, model: str = "schwarzschild") -> str:
        suffix = "" if model in ("schwarzschild", "flat") else f",{model}"
        return f"{kernel}<{'fast' if fast else 'exact'},{integrator}{suffix}>"

    def get(self, kernel, fast, integrator, model="schwarzschild") -> dict:
        return self.rec.setdefault(
            self.key(kernel, fast, integrator, model),
            {"kernel": kernel, "model": model if model != "flat" else "schwarzschild",
             "launches": 0, "max_abs_err": 0, "ms": None, "plain_ms": None, "bound_ms": None,
             "bound_by": None, "config": None})

    def launched(self, kernel, fast, integrator, n, model="schwarzschild"):
        self.get(kernel, fast, integrator, model)["launches"] += n

    def err(self, kernel, fast, integrator, e, model="schwarzschild"):
        r = self.get(kernel, fast, integrator, model)
        r["max_abs_err"] = max(r["max_abs_err"], e)

    def neural(self, model: str, highest: bool, plan=None) -> dict:
        """The record of neural_mlp's variant for a model and tier, and at
        the default tier for the layout of `plan` (kernel_plan's; None: the
        main path's)."""
        return self.rec.setdefault(
            neural_variant(model, highest, plan),
            {"kernel": "neural_mlp", "model": model, "launches": 0, "max_abs_err": 0, "ms": None,
             "plain_ms": None, "bound_ms": None, "bound_by": None, "library_ms": None,
             "config": None})

    def other(self, name: str, kernel: str, replaces: str) -> dict:
        """The record of a variant named outright (the strided and masked
        ray-gen of trace_planes; the direction planes of neural_mlp)."""
        return self.rec.setdefault(
            name, {"kernel": kernel, "replaces": replaces, "launches": 0, "max_abs_err": 0,
                   "ms": None, "plain_ms": None, "bound_ms": None, "bound_by": None,
                   "library_ms": None, "config": None})

    def timed(self, kernel, fast, integrator, model, *, ms, plain_ms, ray_steps, pixels, config,
              adaptive=False, disk=False):
        r = self.get(kernel, fast, integrator, model)
        b, by = bound(kernel, model, fast, integrator, ray_steps, pixels, adaptive=adaptive,
                      disk=disk)
        r.update(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by, config=config,
                 ray_steps=ray_steps)


def main() -> None:
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    phase("device", f"{kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi, flush=True)

    import bhr_tpu_torch as bt
    from bhr_tpu_torch.core.camera import generate_rays
    from bhr_tpu_torch.models import neural as tn
    from bhr_tpu_torch.models import neural_kerr as tnk
    from bhr_tpu_torch.ops import neural_kernel as nk
    from bhr_tpu_torch.ops import shade_kernel as sk
    from bhr_tpu_torch.ops import trace_kernel as tk
    from bhr_tpu_torch.ops.multires import deflection_edges
    from bhr_tpu_torch.ops.neural_trace import neural_trace_image
    from bhr_tpu_torch.ops.sampling import unpack_frame as unpack
    from bhr_tpu_torch.ops.trace import trace_rays
    from bhr_tpu_torch.parallel import mesh as pm
    from bhr_tpu_torch.renderer import shade_image, shade_image_reference
    from bhr_tpu_torch.tools import hopper_probe as hp
    from bhr_tpu_torch.tools import neural_floor as nf
    from bhr_tpu_torch.tools import sass_walk
    from bhr_tpu_torch.utils import build, plugin, tracing
    from bhr_tpu_torch.utils.timing import device_time_ms

    # 2. build: one nvcc per library, started together; the plugin's
    # trace_planes is built from the header its recording gives
    plugin_accel, plugin_cap = plugin.load_plugin(PLUGIN)
    plugin_program = plugin.program(plugin_accel)
    plugin_source = plugin.cuda_source(plugin_accel)
    with concurrent.futures.ThreadPoolExecutor(7) as pool:
        floor_job = pool.submit(nf.build_floor, build.nvcc_path(), build.NVCC_FLAGS,
                                build.CSRC_DIR, build.BUILD_DIR / "neural_floor")
        jobs = {name: pool.submit(build.build, name, sources, *extra) for name, sources, *extra in
                (("render_mono", build.RENDER_MONO_SOURCES),
                 ("trace_planes", build.TRACE_PLANES_SOURCES),
                 ("neural_mlp", build.NEURAL_MLP_SOURCES),
                 ("trace_planes_custom", build.TRACE_PLANES_SOURCES, plugin_source),
                 ("probes", build.PROBE_SOURCES),
                 ("shade_planes", build.SHADE_PLANES_SOURCES))}
        floor_paths = floor_job.result()
        for name, job in jobs.items():
            info = job.result()
            phase("build", f"{info.path.name} in {info.seconds:.1f} s; ptxas: "
                  f"{sass_walk.ptxas_summary(info.log)}")
    build.load_render_mono()
    build.load_trace_planes()
    build.load_neural_mlp()
    build.load_trace_planes_custom(plugin_source)
    build.load_probes()
    build.load_shade_planes()
    cuobjdump = sass_walk.cuobjdump_path(build.nvcc_path())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if cuobjdump:  # the held layout's instantiations, bit for bit as before
        funcs = sass_walk.parse_sass(sass_walk.sass_of(
            build.build("neural_mlp", build.NEURAL_MLP_SOURCES).path, cuobjdump))
        held = {tag: sass_walk.function_hash(ins) for f, ins in funcs.items()
                for tag in HELD_SASS if tag in f}
        phase("held_sass", f"neural_fused_kernel<·, 128> SASS hashes {held}, pinned "
              f"{HELD_SASS}")
        if held != HELD_SASS:
            raise AssertionError(f"the held layout's SASS moved: {held} against {HELD_SASS}")
    else:
        phase("held_sass", "not measured: no cuobjdump beside nvcc")

    var = Variants()
    side = bt.Camera.new(*SIDE)

    C = tracing.COUNTS  # the launch counts, keyed by the constants N_*

    def reset():
        """Clears the launch counts; the plugin's recordings count for the
        whole process."""
        records = C[N_RECORDS]
        C.clear()
        if records:
            C[N_RECORDS] = records

    def counts():
        return C[N_MONO], C[N_TRACE], C[N_NEURAL]

    def all_counts():
        """(render_mono, trace_planes, of which strided, of which masked,
        neural frame, neural direction planes) launches since reset()."""
        return (C[N_MONO], C[N_TRACE], C[N_STRIDED], C[N_MASKED],
                C[N_NEURAL], C[N_DIRS])

    def plain_trace(cam, scene, config, fast, rows=None):
        """The plain trace of the frame, or of its rows rows[0] .. rows[1] - 1
        (a band, where the whole frame's plain trace takes too long)."""
        if rows is None:
            return tk.trace_image_reference(cam, scene, config, fast_math=fast, device="cuda")
        origins, dirs = generate_rays(cam, scene.screen_width, scene.screen_height, scene.fov,
                                      device="cuda")
        return trace_rays(origins[rows[0]:rows[1]], dirs[rows[0]:rows[1]],
                          scene.black_hole_position, scene.schwarzschild_radius, scene.spin,
                          scene.max_steps, config, fast_math=fast)

    def plain_mono(cam, scene, config, fast, rows=None):
        """The monolithic frame's plain version: (packed frame, trace)."""
        res = plain_trace(cam, scene, config, fast, rows)
        return tk.shade_packed_reference(res, cam, scene, config, fast_math=fast), res

    def plain_staged(cam, scene, config, fast, renderer, tonemap="passthrough", rows=None,
                     res=None):
        """The staged frame's plain version: the plain trace (or `res`), the
        plain epilogue."""
        if res is None:
            res = plain_trace(cam, scene, config, fast, rows)
        plan = renderer._frame_plan(scene, staged=True)
        frame = shade_image_reference(res, cam, scene, plan.disk_params, plan.lut,
                                      tonemap=tonemap, seed=plan.seed)
        return frame, res

    def band(x, rows):
        return x if rows is None else x[rows[0]:rows[1]]

    exact_bits = {}  # exact planes and frames: the share of pixels bit-equal to the plain version

    def hold_bits(name, kernel, plain):
        """Records the share of pixels on which an exact kernel's output --
        a packed frame, or a TraceResult's four planes, compared as bits --
        equals its plain version's; the exact_bits phase asks 100% of each."""
        if isinstance(kernel, torch.Tensor):
            same = kernel.contiguous().view(torch.int32) == plain.contiguous().view(torch.int32)
        else:
            same = (kernel.status == plain.status) & (kernel.steps == plain.steps)
            for plane in ("final_pos", "final_vel"):
                same &= (getattr(kernel, plane).contiguous().view(torch.int32)
                         == getattr(plain, plane).contiguous().view(torch.int32)).all(-1)
        exact_bits[name] = same.float().mean().item()

    def shares(res) -> dict:
        return {"disk_frac": (res.status == STATUS_DISK).float().mean().item(),
                "captured_frac": (res.status == STATUS_CAPTURED).float().mean().item(),
                "ray_steps": int(res.steps.sum().item())}

    def check_mono(cam, scene, config, fast, frame, rows=None, plain=None):
        """A monolithic frame (or its band of `rows`) against its plain
        version (`plain`, or computed here), with the kernel's status from a
        comparison launch of the planes kernel."""
        plain, plain_res = plain or plain_mono(cam, scene, config, fast, rows)
        k_status = tk.trace_image(cam, scene, config, fast_math=fast, device="cuda").status
        s = compare(band(frame, rows), plain, fast, band(k_status, rows), plain_res.status)
        var.err("render_mono", fast, config.integrator, s["max_abs_err"], config.model)
        s.update(shares(plain_res))
        return s

    def check_staged(cam, scene, config, fast, renderer, frame, tonemap="passthrough",
                     rows=None, plain_res=None):
        """A staged frame (or its band) against the plain trace (`plain_res`,
        or computed here) and the same epilogue."""
        plain, plain_res = plain_staged(cam, scene, config, fast, renderer, tonemap, rows,
                                        plain_res)
        k_res = tk.trace_image(cam, scene, config, fast_math=fast, device="cuda")
        s = compare(band(frame, rows), plain, fast, band(k_res.status, rows), plain_res.status)
        var.err("trace_planes", fast, config.integrator, s["max_abs_err"], config.model)
        s.update(shares(plain_res))
        return s, k_res, plain_res

    def issue(name, what, fast, flags, ws, ms, launch, kernel="render_mono"):
        """The `name` line: the loop step an Euler launch of `kernel` with
        these flags runs as built (tools/sass_walk.py route_step on the built
        library's SASS), beside the step of the instantiation that reads the
        flags at run time where the launch runs one that fixes them, and the
        issue floor of `ws` warp-steps at the SM clock read while launch()
        (about `ms` each) runs, against `ms`."""
        if cuobjdump is None:
            phase(name, "not measured: no cuobjdump on PATH or beside nvcc to read the "
                  "built library's SASS")
            return
        sources = build.TRACE_PLANES_SOURCES if kernel == "trace_planes" else \
            build.RENDER_MONO_SOURCES
        funcs = sass_walk.parse_sass(sass_walk.sass_of(build.build(kernel, sources).path,
                                                       cuobjdump))
        route = sass_walk.route_step(funcs, kernel, fast, "euler", flags)
        runtime = ""
        if "flags=" in route["function"]:
            read = sass_walk.route_step({f: ins for f, ins in funcs.items()
                                         if sass_walk.kernel_tag(f) and
                                         sass_walk.kernel_tag(f)[4] is None},
                                        kernel, fast, "euler", flags)
            runtime = (f" (beside {read['function']}, the flags read at run time: "
                       f"{read['step_instructions']} SASS / {read['step_mufu']} MUFU)")
        clock = sass_walk.sm_clock_under_load(launch, ms)
        floor = sass_walk.issue_floor_ms(route["step_instructions"], ws, sms,
                                         float(clock.split(",")[0]))
        phase(name, f"{route['function']} on {what}: {route['step_instructions']} SASS "
              f"/ {route['step_mufu']} MUFU a loop step as built (walked along flags {flags})"
              f"{runtime}, {ws} warp-steps/frame, SM clock {clock.split(',')[0].strip()} MHz "
              f"under load: issue floor {floor:.3f} ms against the kernel's {ms:.3f} ms, "
              f"{floor / ms:.1%} of the issue rate, on {smi}")

    def animate(renderer, n_frames):
        """n_frames orbit frames with no host sync (sync debug mode
        'error'), timed by CUDA events: (frames, ms/frame)."""
        anim = bt.OrbitAnimator(renderer)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda.set_sync_debug_mode("error")  # a host sync in the loop raises
        frames = anim.render_frames(n_frames, packed=True)
        torch.cuda.set_sync_debug_mode("default")
        end.record()
        torch.cuda.synchronize()
        return frames, start.elapsed_time(end) / n_frames, anim

    def shade_rec() -> dict:
        return var.other("shade_planes<exact>", "shade_planes", REPLACES["shade_planes"])

    def staged_shading(what: str, fast: bool, n: int) -> None:
        """Asserts that the n frames (or epilogues) since reset() were shaded
        as their route says: a staged frame by one shade_planes launch each,
        a monolithic one by none, and none by the plain epilogue; counts the
        launches in shade_planes' `kernels` entry."""
        want = (0 if fast else n, 0)
        if (C[N_SHADE], C[N_PLAIN]) != want:
            raise AssertionError(f"{what}: {C[N_SHADE]} shade_planes launches and "
                                 f"{C[N_PLAIN]} plain epilogues, not {want}")
        shade_rec()["launches"] += C[N_SHADE]

    # 3. every variant against its plain version, small: the two cameras of
    # the main path, then the matrix of integrators, dt, models, tiers and paths
    sw, sh, ss = SMALL
    scene = bt.SceneParams(screen_width=sw, screen_height=sh, max_steps=ss, spin=SPIN)
    for cam_name, cam in {"default": bt.Camera.default(), "side": side}.items():
        for fast in (True, False):
            kf = tk.render_packed(cam, scene, fast_math=fast, device="cuda")
            torch.cuda.synchronize()
            s = check_mono(cam, scene, bt.TraceConfig(), fast, kf)
            phase("small", f"{sw}x{sh}x{ss} {cam_name} {'fast' if fast else 'exact'} "
                  f"({bar(fast)}): " + json.dumps(s))
    n_cases, worst = 0, {}
    models = ("schwarzschild", "flat", "kerr", "kerr_lt")
    for integ in ("euler", "rk4", "leapfrog"):
        for adaptive in (False, True):
            for model in models:
                for fast in (True, False):
                    for tonemap in ("passthrough", "srgb"):
                        r = bt.BlackHoleRenderer(sw, sh, integ, model=model, adaptive=adaptive,
                                                 fast_math=fast, tonemap=tonemap, device="cuda")
                        mono = r._frame_plan(scene).route == "mono"
                        reset()
                        frame = r.render_frame(side, scene)
                        torch.cuda.synchronize()
                        launched = (C[N_MONO], C[N_TRACE])
                        packed = frame.view(torch.int32).view(sh, sw)
                        if launched != ((1, 0) if mono else (0, 1)):
                            raise AssertionError(f"{r.config} {tonemap} launched {launched}")
                        if mono:
                            var.launched("render_mono", fast, integ, 1, model)
                            s = check_mono(side, scene, r.config, fast, packed)
                        else:
                            var.launched("trace_planes", fast, integ, 1, model)
                            s, _, _ = check_staged(side, scene, r.config, fast, r, packed, tonemap)
                        n_cases += 1
                        for key in ("bit_same", "within_1", "status_agree", "captured_black"):
                            worst[key] = min(worst.get(key, 1.0), s[key])
                        worst["max_abs_err"] = max(worst.get("max_abs_err", 0),
                                                   s["max_abs_err"])
                        if not fast:
                            worst["exact_bit_same"] = min(worst.get("exact_bit_same", 1.0),
                                                          s["bit_same"])
    phase("matrix", f"{n_cases} cases at {sw}x{sh}x{ss}, spin {SPIN} (3 integrators x "
          f"fixed/adaptive x {'/'.join(models)} x fast/exact x passthrough (monolithic, "
          f"but exact kerr_lt staged)/srgb staged), each 1 launch of its kernel and held to its "
          f"tier's bar; worst over the cases (exact_bit_same: over the exact tier's): "
          + json.dumps(worst))

    # 4. main path at full size, both tiers
    full_scene = bt.SceneParams(screen_width=W, screen_height=H, max_steps=STEPS)
    records = {}
    for fast in (True, False):
        tier = "fast" if fast else "exact"
        renderer = bt.BlackHoleRenderer(W, H, fast_math=fast, device="cuda")
        reset()
        frame = renderer.render_frame(bt.Camera.default(), full_scene)
        torch.cuda.synchronize()
        launches = (C[N_MONO], C[N_TRACE])
        if launches != (1, 0):
            raise AssertionError(f"render_frame launched {launches}, not one render_mono")
        var.launched("render_mono", fast, "euler", 1)
        if frame.shape != (H, W, 4) or frame.dtype != torch.uint8:
            raise AssertionError(f"frame is {frame.dtype} {tuple(frame.shape)}")
        s = check_mono(bt.Camera.default(), full_scene, renderer.config, fast,
                       frame.view(torch.int32).view(H, W))
        if not fast:
            exact_bits["render_mono<exact,euler> main path frame"] = s["bit_same"]
        phase("render_frame", f"{W}x{H}x{STEPS} euler {tier} ({bar(fast)}): launches=1 "
              + json.dumps(s))
        records[tier] = {"renderer": renderer}

    # 5. main-path animation: kernel and plain version, ms/frame by CUDA
    # events, and every animation frame held against its plain version
    for tier, rec in records.items():
        fast = tier == "fast"
        anim = bt.OrbitAnimator(rec["renderer"])
        reset()
        frames = anim.render_frames(N_FRAMES, packed=True)  # warm-up
        anim_ms = cuda_ms(lambda: anim.render_frames(N_FRAMES, packed=True), N_FRAMES, REPEATS)
        launches = C[N_MONO]
        if frames.shape != (N_FRAMES, H, W) or launches != (1 + REPEATS) * N_FRAMES \
                or C[N_TRACE]:
            raise AssertionError(f"animation gave {tuple(frames.shape)} in {launches} launches")
        var.launched("render_mono", fast, "euler", launches)
        cams = [bt.orbit_camera(t) for t in anim.frame_times(N_FRAMES)]
        scratch = torch.empty_like(frames[0])

        def kernel_frames():  # back to back, so host work hides behind the kernel
            for cam in cams:
                tk.render_packed(cam, full_scene, fast_math=fast, device="cuda", out=scratch)

        ms = cuda_ms(kernel_frames, N_FRAMES, REPEATS)
        plain_res, plain = [None] * N_FRAMES, [None] * N_FRAMES

        def plain_frames():  # render_packed_reference, keeping the trace for the status
            for k, cam in enumerate(cams):
                plain_res[k] = tk.trace_image_reference(cam, full_scene, fast_math=fast,
                                                        device="cuda")
                plain[k] = tk.shade_packed_reference(plain_res[k], cam, full_scene,
                                                     bt.TraceConfig(), fast_math=fast)

        plain_ms = cuda_ms(plain_frames, N_FRAMES)
        errs = []
        for k, cam in enumerate(cams):
            k_status = tk.trace_image(cam, full_scene, fast_math=fast, device="cuda").status
            errs.append(compare(frames[k], plain[k], fast, k_status,
                                plain_res[k].status)["max_abs_err"])
        var.err("render_mono", fast, "euler", max(errs))
        rec["anim_ms"] = anim_ms
        ray_steps = sum(int(r.steps.sum().item()) for r in plain_res) // N_FRAMES
        var.timed("render_mono", fast, "euler", "schwarzschild", ms=ms, plain_ms=plain_ms,
                  ray_steps=ray_steps, pixels=W * H,
                  config="euler, fixed dt, Camera.default() orbit, no disk (the main path)")
        phase("animation", f"{N_FRAMES} frames {W}x{H}x{STEPS} {tier}: render_frames "
              f"{anim_ms:.3f} ms/frame, kernel {ms:.3f} ms/launch (medians of {REPEATS}), "
              f"plain {plain_ms:.3f} ms/frame, {ray_steps} ray-steps/frame, launches={launches}, "
              f"frames agree with the plain version ({bar(fast)}; max_abs_err {max(errs)}) "
              f"on {smi}")
        # the loop step the launch really runs, from the built library's SASS
        # (tools/sass_walk.py route_step, flags 0), and its share of the issue rate
        ws = sum(sass_walk.warp_steps(torch, r.steps) for r in plain_res) // N_FRAMES
        issue("issue", "the main path", fast, 0, ws, ms,
              lambda: tk.render_packed(cams[0], full_scene, fast_math=fast, device="cuda",
                                       out=scratch))

    # 5b. the front end on the main path, fast tier. (a) render_frame with a
    # TimestampQuery: frames issued back to back, so that each query's
    # begin event waits on the frame before it and brackets its own
    # frame's kernel, not the host's issue; recording makes no host sync
    renderer = records["fast"]["renderer"]
    cam = bt.Camera.default()
    n_q = 1 + REPEATS
    renderer.render_frame(cam, full_scene)  # warm-up
    torch.cuda.synchronize()
    queries = [bt.TimestampQuery() for _ in range(n_q)]
    reset()
    torch.cuda.set_sync_debug_mode("error")
    for q in queries:
        renderer.render_frame(cam, full_scene, timestamp_query=q)
    torch.cuda.set_sync_debug_mode("default")
    if (C[N_MONO], C[N_TRACE]) != (n_q, 0):
        raise AssertionError(f"{n_q} frames with a query launched {C[N_MONO]}, "
                             f"{C[N_TRACE]}, not one render_mono each")
    var.launched("render_mono", True, "euler", n_q)
    q_ms = statistics.median(q.gpu_time_ms for q in queries[1:])
    scratch = torch.empty((H, W), dtype=torch.int32, device="cuda")
    kernel_ms = device_time_ms(lambda: tk.render_packed(cam, full_scene, fast_math=True,
                                                        device="cuda", out=scratch),
                               iters=REPEATS, repeats=3)
    if abs(q_ms - kernel_ms) > 0.10 * kernel_ms:
        raise AssertionError(f"TimestampQuery {q_ms:.3f} ms against the kernel's "
                             f"{kernel_ms:.3f} ms by CUDA events")
    phase("timestamp_query", f"{W}x{H}x{STEPS} euler fast: {n_q} render_frame calls with a "
          f"TimestampQuery, 1 render_mono launch each, no host sync; gpu_time_ms median "
          f"{q_ms:.3f} ms (frames 2-{n_q}) against the kernel's {kernel_ms:.3f} ms by CUDA "
          f"events, issued behind a spin kernel ({100 * (q_ms / kernel_ms - 1):+.2f}%) on {smi}")
    # (b) PathAnimator along the orbit: bit-equal to OrbitAnimator's frames,
    # one launch a frame, no host sync; (c) render_to_dir of 2 frames
    path_anim = bt.PathAnimator(renderer, lambda t: bt.orbit_camera(t))
    want = bt.OrbitAnimator(renderer).render_frames(4, packed=True)
    reset()
    torch.cuda.set_sync_debug_mode("error")
    got = path_anim.render_frames(4, packed=True)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if C[N_MONO] != 4 or not torch.equal(got, want):
        raise AssertionError(f"PathAnimator: {C[N_MONO]} launches, bit-equal to "
                             f"OrbitAnimator: {torch.equal(got, want)}")
    var.launched("render_mono", True, "euler", 4)
    reset()
    with tempfile.TemporaryDirectory() as tmp:
        paths = path_anim.render_to_dir(tmp, 2, chunk_size=2)
        back = [bt.io.image.read_png(p) for p in paths]
        with open(os.path.join(tmp, "manifest.json")) as fh:
            manifest = json.load(fh)
    if C[N_MONO] != 2:
        raise AssertionError(f"render_to_dir of 2 frames launched {C[N_MONO]}")
    var.launched("render_mono", True, "euler", 2)
    for k in range(2):
        if not (torch.from_numpy(back[k]) == unpack(want[k].cpu())).all():
            raise AssertionError(f"render_to_dir frame {k} differs from the rendered frame")
    phase("path_animator", f"4 PathAnimator frames {W}x{H}x{STEPS} euler fast along "
          f"orbit_camera: 4 launches, no host sync, bit-equal to OrbitAnimator's; "
          f"render_to_dir 2 frames: 2 launches, PNGs read back equal, manifest camera_path "
          f"{manifest['camera_path']!r}")

    # 6. (a) BASELINE config 4: rk4, adaptive dt, the disk, camera [15,5,0];
    # the exact tier's frames each one trace_planes and one shade_planes launch
    cfg4 = dict(integrator="rk4", adaptive=True, disk=True)
    for fast in (True, False):
        tier = "fast" if fast else "exact"
        kernel = "render_mono" if fast else "trace_planes"
        renderer = bt.BlackHoleRenderer(W, H, fast_math=fast, device="cuda", **cfg4)
        reset()
        frame = renderer.render_frame(side, full_scene)
        torch.cuda.synchronize()
        launches = (C[N_MONO], C[N_TRACE])
        if launches != ((1, 0) if fast else (0, 1)):
            raise AssertionError(f"BASELINE 4 {tier} launched {launches}, not one {kernel}")
        var.launched(kernel, fast, "rk4", 1)
        staged_shading("BASELINE 4", fast, 1)
        if C[N_FIXED] != (0 if fast else 1):  # trace_planes<exact,rk4,flags=6>
            raise AssertionError(f"BASELINE 4 {tier} counted {C[N_FIXED]} fixed-flag launches")
        packed = frame.view(torch.int32).view(H, W)
        if fast:
            s = check_mono(side, full_scene, renderer.config, True, packed)
        else:
            s, k_res, p_res = check_staged(side, full_scene, renderer.config, False, renderer,
                                           packed)
            exact_bits["trace_planes<exact,rk4> config 4 frame"] = s["bit_same"]
            hold_bits("trace_planes<exact,rk4> config 4 planes", k_res, p_res)
            lut = renderer._frame_plan(full_scene).lut
            s["shade_kernel_ms"] = cuda_ms(
                lambda: shade_image(k_res, side, full_scene, renderer.disk_params(full_scene),
                                    lut, tonemap="passthrough", packed=True),
                1, REPEATS)
        bt.OrbitAnimator(renderer).render_frames(BASELINE_FRAMES, packed=True)  # warm-up
        reset()
        _, anim_ms, _ = animate(renderer, BASELINE_FRAMES)
        n = C[N_MONO] if fast else C[N_TRACE]
        if n != BASELINE_FRAMES or (C[N_TRACE] if fast else C[N_MONO]):
            raise AssertionError(f"BASELINE 4 animation launched {C[N_MONO]}, "
                                 f"{C[N_TRACE]}")
        var.launched(kernel, fast, "rk4", n)
        staged_shading("BASELINE 4 animation", fast, n)
        if C[N_FIXED] != (0 if fast else n):
            raise AssertionError(f"BASELINE 4 {tier} animation counted {C[N_FIXED]} fixed-flag "
                                 f"launches of {n}")
        phase("baseline4", f"{W}x{H}x{STEPS} rk4 adaptive disk {tier}: render_frame 1 {kernel} "
              f"launch{'' if fast else ' and 1 shade_planes launch'}"
              f"{'' if fast else ', 1 launch.trace_planes.fixed a frame'} ({bar(fast)}): "
              f"{json.dumps(s)}; "
              f"OrbitAnimator {BASELINE_FRAMES} frames {anim_ms:.3f} ms/frame with no host sync "
              f"(CUDA events, sync debug mode 'error') on {smi}")

    # 6. (b) the staged epilogue's kernel on BASELINE config 4's exact planes:
    # one shade_planes launch through shade_image, bit-equal to the plain
    # epilogue; its device time beside its bound, the plain epilogue's time
    # and the host's issue of each
    r4 = bt.BlackHoleRenderer(W, H, device="cuda", **cfg4)
    res4 = tk.trace_image(side, full_scene, r4.config, device="cuda")
    plan4 = r4._frame_plan(full_scene)
    shade_args = (res4, side, full_scene, plan4.disk_params, plan4.lut)
    reset()
    kframe = shade_image(*shade_args, tonemap="passthrough", packed=True)
    torch.cuda.synchronize()
    staged_shading("config 4's exact epilogue", False, 1)
    plain4 = shade_image_reference(*shade_args, tonemap="passthrough")
    differ = int((kframe != plain4).sum())
    if differ:
        raise AssertionError(f"shade_planes differs from the plain epilogue on {differ} words")
    shade_ms = device_time_ms(lambda: sk.shade_planes(*shade_args))
    shade_host_ms = host_ms(lambda: shade_image(*shade_args, tonemap="passthrough",
                                                packed=True), REPEATS)
    plain_shade_ms = cuda_ms(lambda: shade_image_reference(*shade_args, tonemap="passthrough"),
                             1, REPEATS)
    plain_host_ms = host_ms(lambda: shade_image_reference(*shade_args, tonemap="passthrough"),
                            REPEATS)
    n_disk = int((res4.status == STATUS_DISK).sum().item())
    n_sky = int((res4.status != STATUS_CAPTURED).sum().item()) - n_disk
    t_ops = (n_sky * SHADE_STAR_OPS + n_disk * SHADE_DISK_OPS
             + W * H * SHADE_QUANT_OPS) / PEAK_FP32 * 1e3
    t_bytes = (W * H * SHADE_BYTES + n_disk * SHADE_DISK_BYTES) / PEAK_BYTES * 1e3
    shade_rec().update(ms=shade_ms, plain_ms=plain_shade_ms, bound_ms=max(t_ops, t_bytes),
                       bound_by="operations" if t_ops >= t_bytes else "bytes",
                       config=f"BASELINE config 4 exact planes {W}x{H}")
    phase("shade_planes", f"{W}x{H} BASELINE config 4 exact planes ({n_disk} disk, {n_sky} sky "
          f"pixels): shade_image 1 shade_planes launch ({N_SHADE}), the plain epilogue taken 0 "
          f"times, 0 of {W * H} words differ from the plain epilogue; kernel {shade_ms:.4f} ms "
          f"(device time), bound {max(t_ops, t_bytes):.4f} ms (operations {t_ops:.4f}, bytes "
          f"{t_bytes:.4f}); the host's issue of shade_image {shade_host_ms:.3f} ms; the plain "
          f"epilogue {plain_shade_ms:.3f} ms by events, {plain_host_ms:.3f} ms of host issue, "
          f"on {smi}")

    # 7. (a) BASELINE config 5: exact Kerr at spin 0.9, the disk, Euler,
    # camera [15,5,0], 3840x2160x2000. One frame against the whole plain
    # frame (timed: the plain version's ms); then CONFIG5_FRAMES orbit
    # frames with no host sync, each against the plain version on BAND5.
    scene5 = bt.SceneParams(screen_width=W5, screen_height=H5, max_steps=STEPS5, spin=SPIN)
    cfg5 = dict(model="kerr", disk=True)
    for fast in (True, False):
        tier = "fast" if fast else "exact"
        kernel = "render_mono" if fast else "trace_planes"
        renderer = bt.BlackHoleRenderer(W5, H5, fast_math=fast, device="cuda", **cfg5)
        reset()
        frame = renderer.render_frame(side, scene5)
        torch.cuda.synchronize()
        launches = (C[N_MONO], C[N_TRACE])
        if launches != ((1, 0) if fast else (0, 1)):
            raise AssertionError(f"BASELINE 5 {tier} launched {launches}, not one {kernel}")
        if (C[N_MONO_KS], C[N_TRACE_KS]) != launches or \
                (C[N_MONO_KS_FAST], C[N_TRACE_KS_FAST]) != (launches if fast else (0, 0)):
            raise AssertionError(f"BASELINE 5 {tier} counted {C[N_MONO_KS]}, {C[N_TRACE_KS]} "
                                 f"Kerr-Schild launches ({C[N_MONO_KS_FAST]}, "
                                 f"{C[N_TRACE_KS_FAST]} fast) of {launches}")
        var.launched(kernel, fast, "euler", 1, "kerr")
        staged_shading("BASELINE 5", fast, 1)
        if C[N_FIXED] != (0 if fast else 1):  # trace_planes<exact,euler,ks,flags=20>
            raise AssertionError(f"BASELINE 5 {tier} counted {C[N_FIXED]} fixed-flag launches")
        if frame.shape != (H5, W5, 4):
            raise AssertionError(f"BASELINE 5 frame is {tuple(frame.shape)}")
        packed = frame.view(torch.int32).view(H5, W5)
        # the plain version timed alone, as in phase 10: the trace, and for
        # the monolithic kernel its shading; the comparison runs after
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        plain = (plain_mono(side, scene5, renderer.config, True) if fast else
                 plain_trace(side, scene5, renderer.config, False))
        t1.record()
        torch.cuda.synchronize()
        plain_ms = t0.elapsed_time(t1)
        if fast:
            s = check_mono(side, scene5, renderer.config, True, packed, plain=plain)
        else:
            s, k5, _ = check_staged(side, scene5, renderer.config, False, renderer, packed,
                                    plain_res=plain)
            exact_bits["trace_planes<exact,euler,ks> config 5 frame"] = s["bit_same"]
            hold_bits("trace_planes<exact,euler,ks> config 5 planes", k5, plain)
            hashes = {"planes": sha16(k5.final_pos, k5.final_vel, k5.status, k5.steps),
                      "frame": sha16(packed)}
            del k5
        ray_steps = s["ray_steps"]
        if fast:
            out = torch.empty((H5, W5), dtype=torch.int32, device="cuda")
            launch = lambda: tk.render_packed(side, scene5, renderer.config, fast_math=True,
                                              device="cuda", out=out)
        else:
            planes = tk.empty_trace_result(H5, W5, "cuda")
            launch = lambda: tk.trace_image(side, scene5, renderer.config, device="cuda",
                                            out=planes)
        ms = cuda_ms(lambda: [launch() for _ in range(3)], 3, REPEATS)
        var.timed(kernel, fast, "euler", "kerr", ms=ms, plain_ms=plain_ms,
                  ray_steps=ray_steps, pixels=W5 * H5, disk=True,
                  config="BASELINE config 5: kerr spin 0.9, euler, fixed dt, disk, camera "
                         "[15,5,0], 3840x2160x2000")
        # the loop step as built and its issue floor, warp-steps from the plain
        # frame's steps, as the main path's line
        issue("issue5" if fast else "issue5_exact", "BASELINE config 5", fast,
              tk.trace_flags(renderer.config),
              sass_walk.warp_steps(torch, (plain[1] if fast else plain).steps), ms, launch,
              kernel)
        reset()
        frames, anim_ms, anim = animate(renderer, CONFIG5_FRAMES)
        n = C[N_MONO] if fast else C[N_TRACE]
        if n != CONFIG5_FRAMES or (C[N_TRACE] if fast else C[N_MONO]):
            raise AssertionError(f"BASELINE 5 animation launched {C[N_MONO]}, "
                                 f"{C[N_TRACE]}")
        if (C[N_MONO_KS], C[N_TRACE_KS]) != (C[N_MONO], C[N_TRACE]) or \
                C[N_MONO_KS_FAST] + C[N_TRACE_KS_FAST] != (n if fast else 0):
            raise AssertionError(f"BASELINE 5 animation counted {C[N_MONO_KS]}, "
                                 f"{C[N_TRACE_KS]} Kerr-Schild launches ({C[N_MONO_KS_FAST]}, "
                                 f"{C[N_TRACE_KS_FAST]} fast) of {n}")
        var.launched(kernel, fast, "euler", n, "kerr")
        staged_shading("BASELINE 5 animation", fast, n)
        if C[N_FIXED] != (0 if fast else n):
            raise AssertionError(f"BASELINE 5 {tier} animation counted {C[N_FIXED]} fixed-flag "
                                 f"launches of {n}")
        if not fast:
            hashes.update({f"orbit{k}": sha16(f) for k, f in enumerate(frames)})
            if hashes != EXACT5_SHA:
                raise AssertionError(f"BASELINE 5 exact output hashes {hashes}, not {EXACT5_SHA}")
        band_stats = []
        for k, t in enumerate(anim.frame_times(CONFIG5_FRAMES)):
            cam = bt.orbit_camera(t)
            b = (check_mono(cam, scene5, renderer.config, True, frames[k], BAND5) if fast else
                 check_staged(cam, scene5, renderer.config, False, renderer, frames[k],
                              rows=BAND5)[0])
            band_stats.append({key: b[key] for key in ("bit_same", "within_1", "status_agree",
                                                      "max_abs_err", "disk_frac",
                                                      "captured_frac")})
        phase("baseline5", f"{W5}x{H5}x{STEPS5} kerr spin {SPIN} euler disk {tier}: "
              f"render_frame 1 {kernel} launch, held against the whole plain frame "
              f"({bar(fast)}): {json.dumps(s)}; kernel {ms:.3f} ms (median of {REPEATS} x 3), "
              f"plain {plain_ms:.1f} ms, {ray_steps} ray-steps integrated "
              f"({ray_steps / (W5 * H5 * STEPS5):.4f} of the nominal W*H*max_steps); "
              f"OrbitAnimator {CONFIG5_FRAMES} frames {anim_ms:.3f} ms/frame with no host sync "
              f"(CUDA events, sync debug mode 'error'), rows {BAND5[0]}-{BAND5[1] - 1} of each "
              f"held against the plain version: {json.dumps(band_stats)}"
              f"{'' if fast else f'; 1 {N_FIXED} a frame, output hashes {json.dumps(hashes)}'}"
              f" on {smi}")
        del frames, renderer

    # 8. (b) kerr_lt at 1920x1080x500, spin 0.9, camera [15,5,0]: fast
    # monolithic, exact staged, and the step heatmap (steps plane against
    # the plain version's)
    scene_lt = full_scene.replace(spin=SPIN)
    for fast in (True, False):
        tier = "fast" if fast else "exact"
        kernel = "render_mono" if fast else "trace_planes"
        renderer = bt.BlackHoleRenderer(W, H, fast_math=fast, device="cuda", model="kerr_lt")
        reset()
        frame = renderer.render_frame(side, scene_lt)
        torch.cuda.synchronize()
        launches = (C[N_MONO], C[N_TRACE])
        if launches != ((1, 0) if fast else (0, 1)):
            raise AssertionError(f"kerr_lt {tier} launched {launches}, not one {kernel}")
        var.launched(kernel, fast, "euler", 1, "kerr_lt")
        packed = frame.view(torch.int32).view(H, W)
        if fast:
            s = check_mono(side, scene_lt, renderer.config, True, packed)
        else:
            s, k_lt, p_lt = check_staged(side, scene_lt, renderer.config, False, renderer, packed)
            exact_bits["trace_planes<exact,euler> kerr_lt frame"] = s["bit_same"]
            hold_bits("trace_planes<exact,euler> kerr_lt planes", k_lt, p_lt)
        debug = scene_lt.replace(debug_mode=1)
        reset()
        hframe = renderer.render_frame(side, debug)
        torch.cuda.synchronize()
        if (C[N_MONO], C[N_TRACE]) != (0, 1):
            raise AssertionError(f"kerr_lt debug frame launched {C[N_MONO]}, "
                                 f"{C[N_TRACE]}")
        var.launched("trace_planes", fast, "euler", 1, "kerr_lt")
        k_res = tk.trace_image(side, debug, renderer.config, fast_math=fast, device="cuda")
        hplain, hres = plain_staged(side, debug, renderer.config, fast, renderer)
        steps_same = (k_res.steps == hres.steps).float().mean().item()
        if steps_same < STATUS_MIN:
            raise AssertionError(f"kerr_lt steps plane agrees on {steps_same}")
        h = compare(hframe.view(torch.int32).view(H, W), hplain, fast, k_res.status,
                    hres.status, heatmap=True)
        var.err("trace_planes", fast, "euler", h["max_abs_err"], "kerr_lt")
        # the fast frame keeps bhr_tpu's unclamped Euler step, so rays that
        # pass r ~ r_s part from the plain version; its margin is printed
        margin = (f"margin over its bar: {round((s['within_1'] - FAST_MIN) * W * H)} pixels "
                  f"(within 1 level on {s['within_1']:.6f} against {FAST_MIN}); " if fast else "")
        phase("kerr_lt", f"{W}x{H}x{STEPS} kerr_lt spin {SPIN} euler {tier}: render_frame 1 "
              f"{kernel} launch ({bar(fast)}): {json.dumps(s)}; {margin}heatmap 1 trace_planes launch, "
              f"steps plane equal to the plain version's on {steps_same:.6f} (bar {STATUS_MIN}), "
              f"frame {json.dumps(h)}")

    # 9. (b) the debug step heatmap, both tiers: the steps plane against the
    # plain version's
    debug_scene = full_scene.replace(debug_mode=1)
    for fast in (True, False):
        tier = "fast" if fast else "exact"
        renderer = bt.BlackHoleRenderer(W, H, fast_math=fast, device="cuda")
        reset()
        frame = renderer.render_frame(bt.Camera.default(), debug_scene)
        torch.cuda.synchronize()
        if (C[N_MONO], C[N_TRACE]) != (0, 1):
            raise AssertionError(f"debug frame launched {C[N_MONO]}, {C[N_TRACE]}")
        var.launched("trace_planes", fast, "euler", 1)
        k_res = tk.trace_image(bt.Camera.default(), debug_scene, fast_math=fast, device="cuda")
        plain, plain_res = plain_staged(bt.Camera.default(), debug_scene, renderer.config,
                                        fast, renderer)
        steps_same = (k_res.steps == plain_res.steps).float().mean().item()
        if steps_same < STATUS_MIN:
            raise AssertionError(f"steps plane agrees on {steps_same}")
        s = compare(frame.view(torch.int32).view(H, W), plain, fast, k_res.status,
                    plain_res.status, heatmap=True)
        var.err("trace_planes", fast, "euler", s["max_abs_err"])
        phase("debug", f"{W}x{H}x{STEPS} debug_mode=1 {tier}: 1 trace_planes launch; steps "
              f"plane equal to the plain version's on {steps_same:.6f} (bar {STATUS_MIN}); "
              f"frame ({bar(fast)}, but for captured_black: the heatmap colours every ray): "
              f"{json.dumps(s)}")

    # 10. times of every other variant at 1920x1080x500: kernel launches
    # back to back (median of REPEATS runs of 3) beside one run of its plain
    # version, whose step counts give the ray-steps of the bound
    disk_cfg = dict(adaptive=True, disk=True)
    both, fast_only, exact_only = (True, False), (True,), (False,)
    timing = [  # (kernel, integrator, model, tiers, camera, config); the rest is timed above
        ("render_mono", "rk4", "schwarzschild", both, side, disk_cfg),
        ("render_mono", "leapfrog", "schwarzschild", both, side, disk_cfg),
        ("trace_planes", "euler", "schwarzschild", both, bt.Camera.default(), {}),
        ("trace_planes", "rk4", "schwarzschild", both, side, disk_cfg),
        ("trace_planes", "leapfrog", "schwarzschild", both, side, disk_cfg),
        ("render_mono", "euler", "kerr", exact_only, side, {}),
        ("render_mono", "rk4", "kerr", both, side, disk_cfg),
        ("render_mono", "leapfrog", "kerr", both, side, disk_cfg),
        ("trace_planes", "euler", "kerr", fast_only, side, {}),
        ("trace_planes", "rk4", "kerr", both, side, disk_cfg),
        ("trace_planes", "leapfrog", "kerr", both, side, disk_cfg),
        ("render_mono", "euler", "kerr_lt", fast_only, side, {}),
        ("render_mono", "rk4", "kerr_lt", fast_only, side, disk_cfg),
        ("render_mono", "leapfrog", "kerr_lt", fast_only, side, disk_cfg),
        ("trace_planes", "euler", "kerr_lt", both, side, {}),
        ("trace_planes", "rk4", "kerr_lt", both, side, disk_cfg),
        ("trace_planes", "leapfrog", "kerr_lt", both, side, disk_cfg),
    ]
    timing_scene = full_scene.replace(spin=SPIN)
    for kernel, integ, model, tiers, cam, kw in timing:
        for fast in tiers:
            if kernel == "render_mono" and not fast:
                kw = {**kw, "disk": False}  # the exact tier's disk is staged
            config = bt.TraceConfig(integrator=integ, model=model, **kw)
            plain_res = [None, None]  # the plain trace, and the monolithic plain frame
            if kernel == "render_mono":
                out = torch.empty((H, W), dtype=torch.int32, device="cuda")

                def launch():
                    tk.render_packed(cam, timing_scene, config, fast_math=fast, device="cuda",
                                     out=out)

                def plain():
                    plain_res[0] = tk.trace_image_reference(cam, timing_scene, config,
                                                            fast_math=fast, device="cuda")
                    plain_res[1] = tk.shade_packed_reference(plain_res[0], cam, timing_scene,
                                                             config, fast_math=fast)
            else:
                planes = tk.empty_trace_result(H, W, "cuda")

                def launch():
                    tk.trace_image(cam, timing_scene, config, fast_math=fast, device="cuda",
                                   out=planes)

                def plain():
                    plain_res[0] = tk.trace_image_reference(cam, timing_scene, config,
                                                            fast_math=fast, device="cuda")
            launch()  # warm-up
            ms = cuda_ms(lambda: [launch() for _ in range(3)], 3, REPEATS)
            plain_ms = cuda_ms(plain, 1)
            ray_steps = int(plain_res[0].steps.sum().item())
            if not fast and model == "schwarzschild" and integ != "euler":
                hold_bits(f"{var.key(kernel, fast, integ, model)} "
                          f"{'frame' if kernel == 'render_mono' else 'planes'}",
                          out if kernel == "render_mono" else planes,
                          plain_res[1] if kernel == "render_mono" else plain_res[0])
            desc = (f"{model}{f' spin {SPIN}' if model != 'schwarzschild' else ''}, {integ}, "
                    f"{'adaptive' if config.adaptive else 'fixed'} dt, "
                    f"{'disk' if config.disk else 'no disk'}, camera {cam.position.tolist()}, "
                    f"{W}x{H}x{STEPS}")
            var.timed(kernel, fast, integ, model, ms=ms, plain_ms=plain_ms, ray_steps=ray_steps,
                      pixels=W * H, config=desc, adaptive=config.adaptive, disk=config.disk)
            r = var.get(kernel, fast, integ, model)
            phase("timing", f"{var.key(kernel, fast, integ, model)} ({desc}): kernel {ms:.3f} "
                  f"ms, plain {plain_ms:.3f} ms, {ray_steps} ray-steps, bound "
                  f"{r['bound_ms']:.3f} ms ({r['bound_by']}) on {smi}")

    # 11. the neural surrogate (integrator "neural"): (a) every committed
    # net at 160x96 through render_frame, both cameras, against the plain
    # version; one neural_mlp launch a frame
    def net_path(key):
        return tn.ASSETS_DIR / NEURAL_ASSETS[key][1]

    sw, sh = SMALL[:2]
    matrix = (("n1", "default", 0.0), ("n1_xl", "default", 0.0), ("n2", "default", SPIN),
              ("n2", "default", 0.0), ("n2_fp32", "highest", SPIN))
    worst = {}
    for key, tier, spin in matrix:
        model = NEURAL_ASSETS[key][0]
        highest = tier == "highest"
        r = bt.BlackHoleRenderer(sw, sh, "neural", model=model, neural_params=net_path(key),
                                 neural_precision=tier, device="cuda")
        for cam in (bt.Camera.default(), side):
            scene = bt.SceneParams(screen_width=sw, screen_height=sh, spin=spin)
            reset()
            frame = r.render_frame(cam, scene)
            torch.cuda.synchronize()
            if counts() != (0, 0, 1):
                raise AssertionError(f"neural {key} {tier} frame launched {counts()}")
            plain = nk.neural_render_packed_reference(r.neural_params, cam, scene, precision=tier,
                                                      device="cuda")
            st = neural_compare(frame.view(torch.int32).view(sh, sw), plain, highest)
            rec = var.neural(model, highest, nk.kernel_plan(r.neural_params, tier))
            rec["launches"] += 1
            rec["max_abs_err"] = max(rec["max_abs_err"], st["max_abs_err"])
            w = worst.setdefault(tier, {})
            for k in ("bit_same", "black_agree"):
                w[k] = min(w.get(k, 1.0), st[k])
            for k in ("off_by_more_than_2", "max_abs_err"):
                w[k] = max(w.get(k, 0), st[k])
    phase("neural_matrix", f"{2 * len(matrix)} frames at {sw}x{sh}: {', '.join(NEURAL_ASSETS[k][1] + ' ' + t + f' spin {sp}' for k, t, sp in matrix)}, "
          f"cameras default and [15,5,0], each 1 neural_mlp launch held to its tier's bar "
          f"(default: {neural_bar(False)}; highest: {neural_bar(True)}); worst by tier: "
          + json.dumps(worst))

    # every other block plan of the kernel, on the seeded random nets of
    # PLAN_NETS, both cameras, through render_frame
    plans = []
    for tier, model, width, seed in PLAN_NETS:
        highest = tier == "highest"
        net = bt.NeuralSurrogate(random_net(model, width, seed))
        plan = nk.kernel_plan(net, tier)
        r = bt.BlackHoleRenderer(sw, sh, "neural", model=model, neural_params=net,
                                 neural_precision=tier, device="cuda")
        for cam in (bt.Camera.default(), side):
            scene = bt.SceneParams(screen_width=sw, screen_height=sh,
                                   spin=SPIN if model == "kerr" else 0.0)
            reset()
            frame = r.render_frame(cam, scene)
            torch.cuda.synchronize()
            if counts() != (0, 0, 1):
                raise AssertionError(f"neural plan {plan} frame launched {counts()}")
            plain = nk.neural_render_packed_reference(r.neural_params, cam, scene, precision=tier,
                                                      device="cuda")
            st = neural_compare(frame.view(torch.int32).view(sh, sw), plain, highest)
            if not 0.05 <= st["black_frac"] <= 0.95:
                raise AssertionError(f"neural plan {plan}: the capture mask is not mixed: {st}")
            rec = var.neural(model, highest, plan)
            rec["launches"] += 1
            rec["max_abs_err"] = max(rec["max_abs_err"], st["max_abs_err"])
            plans.append({"tier": tier, "model": model, "hidden": list(net.widths),
                          "plan": list(plan), **{k: st[k] for k in ("bit_same", "black_agree",
                                                                    "black_frac")}})
    phase("neural_plans", f"{len(plans)} frames at {sw}x{sh} of seeded random nets, one per "
          f"block plan (pixels, channels a chunk, chunk buffers, register width) and camera, "
          f"each 1 neural_mlp "
          f"launch held to its tier's bar: " + json.dumps(plans))

    # (b) the neural main path at 1920x1080 through render_frame: the
    # default Schwarzschild and Kerr assets (N1, N2 at the default tier) and
    # the fp32-trained Kerr net at an explicit "highest"; N1 at "highest"
    # too (not its weights' operating point), so that each of the kernel's
    # four instantiations is timed at full width
    full_neural = bt.SceneParams(screen_width=W, screen_height=H)
    main = (("n1", {}, 0.0, bt.Camera.default()), ("n2", {}, SPIN, side),
            ("n2_fp32", dict(neural_params=net_path("n2_fp32"), neural_precision="highest"), SPIN,
             side), ("n1_fp32", dict(neural_precision="highest"), 0.0, bt.Camera.default()))
    kernel_frames = {}
    for key, kw, spin, cam in main:
        model = NEURAL_ASSETS[key][0]
        r = bt.BlackHoleRenderer(W, H, "neural", model=model, device="cuda", **kw)
        highest = r.neural_precision == "highest"
        scene = full_neural.replace(spin=spin)
        reset()
        frame = r.render_frame(cam, scene)
        torch.cuda.synchronize()
        if counts() != (0, 0, 1):
            raise AssertionError(f"neural main path {key} launched {counts()}")
        if frame.shape != (H, W, 4) or frame.dtype != torch.uint8:
            raise AssertionError(f"neural frame is {frame.dtype} {tuple(frame.shape)}")
        packed = frame.view(torch.int32).view(H, W)
        plain = nk.neural_render_packed_reference(r.neural_params, cam, scene,
                                                  precision=r.neural_precision, device="cuda")
        st = neural_compare(packed, plain, highest)
        rec = var.neural(model, highest, nk.kernel_plan(r.neural_params, r.neural_precision))
        rec["launches"] += 1
        rec["max_abs_err"] = max(rec["max_abs_err"], st["max_abs_err"])
        kernel_frames[key] = packed.clone()
        phase("neural_main", f"{W}x{H} {NEURAL_ASSETS[key][1]} ({model}, "
              f"{r.neural_precision}, spin {spin}, camera {cam.position.tolist()}): render_frame "
              f"1 neural_mlp launch ({neural_bar(highest)}): {json.dumps(st)}")

    # (c) OrbitAnimator: N_FRAMES frames with no host sync, each against its
    # plain version; ms/frame beside the main path's Euler frame
    r_orbit = bt.BlackHoleRenderer(W, H, "neural", neural_params=net_path("n1_orbit"),
                                   device="cuda")
    bt.OrbitAnimator(r_orbit).render_frames(1, packed=True)  # warm-up: the weights' operands
    reset()
    frames, neural_anim_ms, anim = animate(r_orbit, N_FRAMES)
    if counts() != (0, 0, N_FRAMES) or frames.shape != (N_FRAMES, H, W):
        raise AssertionError(f"neural animation launched {counts()}: {tuple(frames.shape)}")
    if (C[N_NEURAL_KERR], C[N_STREAMED]) != (0, 0):  # a 128-wide Schwarzschild net, held
        raise AssertionError(f"neural animation counted {C[N_NEURAL_KERR]} Kerr and "
                             f"{C[N_STREAMED]} streamed launches")
    orbit_plan = nk.kernel_plan(r_orbit.neural_params, "default")
    var.neural("schwarzschild", False, orbit_plan)["launches"] += N_FRAMES
    errs = []
    for k, t in enumerate(anim.frame_times(N_FRAMES)):
        plain = nk.neural_render_packed_reference(r_orbit.neural_params, bt.orbit_camera(t),
                                                  r_orbit.scene, device="cuda")
        errs.append(neural_compare(frames[k], plain, False))
    rec = var.neural("schwarzschild", False, orbit_plan)
    rec["max_abs_err"] = max([rec["max_abs_err"]] + [e["max_abs_err"] for e in errs])
    euler = {tier: records[tier]["anim_ms"] for tier in records}
    phase("neural_animation", f"{N_FRAMES} frames {W}x{H} neural_schwarzschild_orbit.npz: "
          f"OrbitAnimator {neural_anim_ms:.3f} ms/frame with no host sync (CUDA events, sync "
          f"debug mode 'error'), launches={N_FRAMES}; every frame held to {neural_bar(False)} "
          f"(worst bit_same {min(e['bit_same'] for e in errs):.6f}); against the main path's "
          f"Euler frame at {W}x{H}x{STEPS}: "
          + ", ".join(f"{tier} {ms:.3f} ms/frame, ratio {neural_anim_ms / ms:.4f}"
                      for tier, ms in euler.items()) + f" on {smi}")
    del frames

    # (c') the 4K Kerr orbit (bench_torch's kerr09sky4k): KERR_SKY_FRAMES
    # OrbitAnimator frames of N2 at spin 0.9 through the streamed layout, no
    # host sync, each against its plain version on the band BAND5 (the whole
    # plain frame's hidden activations take 8.5 GB apiece); one Kerr and one
    # streamed launch a frame
    r_k4 = bt.BlackHoleRenderer(W5, H5, "neural", model="kerr", neural_params=net_path("n2"),
                                device="cuda")
    r_k4.scene = bt.SceneParams(screen_width=W5, screen_height=H5, spin=SPIN)
    k4_plan = nk.kernel_plan(r_k4.neural_params, "default")
    if k4_plan != nk.STREAMED_PLAN:
        raise AssertionError(f"N2's plan is {k4_plan}, not the streamed layout")
    bt.OrbitAnimator(r_k4).render_frames(1, packed=True)  # warm-up: the weights' operands
    torch.cuda.synchronize()
    reset()
    n = KERR_SKY_FRAMES
    frames, k4_ms, anim = animate(r_k4, n)
    if (counts() != (0, 0, n) or (C[N_NEURAL_KERR], C[N_STREAMED]) != (n, n)
            or frames.shape != (n, H5, W5)):
        raise AssertionError(f"4K Kerr neural animation launched {counts()}, counted "
                             f"{C[N_NEURAL_KERR]} Kerr and {C[N_STREAMED]} streamed: "
                             f"{tuple(frames.shape)}")
    var.neural("kerr", False, k4_plan)["launches"] += n
    band_h = BAND5[1] - BAND5[0]
    errs = []
    for k, t in enumerate(anim.frame_times(n)):
        plain = nk.neural_render_packed_reference(r_k4.neural_params, bt.orbit_camera(t),
                                                  r_k4.scene, device="cuda", row0=BAND5[0],
                                                  local_shape=(band_h, W5))
        errs.append(neural_compare(frames[k][BAND5[0]:BAND5[1]], plain, False))
    rec = var.neural("kerr", False, k4_plan)
    rec["max_abs_err"] = max([rec["max_abs_err"]] + [e["max_abs_err"] for e in errs])
    mlp_flop = 2 * sum(w.shape[0] * w.shape[1] for w, _ in r_k4.neural_params) * W5 * H5
    phase("neural_kerr_4k", f"{n} frames {W5}x{H5} neural_kerr.npz spin {SPIN}, plan {k4_plan}: "
          f"OrbitAnimator {k4_ms:.3f} ms/frame with no host sync (CUDA events, sync debug "
          f"mode 'error'), {mlp_flop / (k4_ms * 1e9):.1f} MLP TFLOP/s; launches={n}, "
          f"{N_NEURAL_KERR}={C[N_NEURAL_KERR]}, {N_STREAMED}={C[N_STREAMED]}; rows "
          f"{BAND5[0]}-{BAND5[1] - 1} of each held to {neural_bar(False)} (worst bit_same "
          f"{min(e['bit_same'] for e in errs):.6f}, off_by_more_than_2 "
          f"{max(e['off_by_more_than_2'] for e in errs):.2e}) on {smi}")
    del frames, r_k4

    # (d) the staged routes: the srgb tonemap, and the fp32-trained Kerr net
    # at "auto", which resolves to "high"; no kernel launch
    r_srgb = bt.BlackHoleRenderer(W, H, "neural", tonemap="srgb", device="cuda")
    r_high = bt.BlackHoleRenderer(W, H, "neural", model="kerr", neural_params=net_path("n2_fp32"),
                                  device="cuda")
    if r_high.neural_precision != "high":
        raise AssertionError(f"'auto' resolved to {r_high.neural_precision}, not 'high'")
    for name, r, cam, scene in (("srgb", r_srgb, bt.Camera.default(), full_neural),
                                ("high", r_high, side, full_neural.replace(spin=SPIN))):
        r.render_frame(cam, scene)  # warm-up
        torch.cuda.synchronize()
        reset()
        ms = cuda_ms(lambda: r.render_frame(cam, scene), 1, REPEATS)
        if counts() != (0, 0, 0):
            raise AssertionError(f"staged neural {name} frame launched {counts()}")
        frame = r.render_frame(cam, scene).view(torch.int32).view(H, W)
        if name == "high":  # the highest kernel's frame, at the default tier's bars
            st = neural_compare(kernel_frames["n2_fp32"], frame, False)
        else:  # the rays it captures are black in the kernel's passthrough frame
            cap = neural_trace_image(r.neural_params, cam, scene, device="cuda").status == 2
            k = kernel_frames["n1"].view(torch.uint8).view(H, W, 4)[..., :3]
            st = {"captured_black": (k[cap] == 0).all(-1).float().mean().item(),
                  "captured_frac": cap.float().mean().item()}
            if st["captured_black"] < NEURAL_DEFAULT_BARS["black"]:
                raise AssertionError(f"staged srgb capture disagrees with the kernel: {st}")
        bt.OrbitAnimator(r).render_frames(1, packed=True)  # warm-up
        reset()
        _, anim_ms, _ = animate(r, 2)  # the staged route makes the host wait for nothing
        if counts() != (0, 0, 0):
            raise AssertionError(f"staged neural {name} animation launched {counts()}")
        phase("neural_staged", f"{W}x{H} {name} ({r.config.model}, precision "
              f"{r.neural_precision}, tonemap {r.tonemap}): 0 kernel launches, "
              f"{ms:.3f} ms/frame (render_frame, median of {REPEATS}); OrbitAnimator 2 "
              f"frames {anim_ms:.3f} ms/frame with no host sync (sync debug mode 'error'); "
              f"{json.dumps(st)}")

    # (e) times at 1920x1080: the kernel (median of REPEATS x 3 launches),
    # its plain version, the bound, and the staged route's MLP chain alone
    # (models/neural.mlp_apply: torch.matmul, i.e. cuBLAS, at the tier); at
    # the default tier also the bf16 tensor-core chain a PyTorch user would
    # write (tools/neural_floor.bf16_chain: each sum rounded to bf16, so not
    # the kernel's bits) and the floor (tools/neural_floor.py: the largest
    # of the mma.sync, SASS-issue and L2 terms, each measured on this card)
    # with the kernel's share of it. The committed nets, and the PLAN_NETS
    # net of each instantiation no committed net reaches (TIMED_PLAN_NETS).
    gen = torch.Generator(device="cuda").manual_seed(0)
    floor_in = None
    if cuobjdump:
        floor_in = nf.measure_inputs(floor_paths, torch, sass_walk, cuobjdump)
        l2 = ", ".join(f"{v['bytes_per_s'] / 1e12:.2f} TB/s at {k} bytes"
                       for k, v in floor_in["l2_read"].items())
        phase("neural_floor", f"inputs: mma.sync.m16n8k16 bf16 at "
              f"{floor_in['mma_rate']['cycles_per_mma_sm']:.4f} SM clocks each an SM "
              f"(nvidia-smi under load: {floor_in['mma_rate']['clocks_under_load']}), "
              f"wgmma.m64n64k16 at {floor_in['wgmma_rate']['cycles_per_wgmma_sm']:.4f} "
              f"({floor_in['wgmma_rate']['clocks_under_load']}); L2 read "
              f"rate {l2}; shortest SASS paths of the phases {json.dumps(floor_in['phases'])} "
              f"on {smi}")
        # the streamed layout's sums: wgmma k-steps in order against mma.sync's,
        # bit for bit, on the hidden layers of the committed 256-wide nets
        bits = nf.layer_bits(floor_paths["bench"], torch, [
            w for key in ("n2", "n1_xl") for w, _ in nk.prep_weights(
                (tnk if key == "n2" else tn).load_params(net_path(key))[0],
                precision="default", device="cuda")[:-1]])
        phase("neural_floor", f"wgmma k-steps against mma.sync's on N2's and the 256-wide "
              f"Schwarzschild net's hidden layers: {json.dumps(bits)}")
        if any(b["bit_same"] != 1.0 for b in bits):
            raise AssertionError(f"wgmma's sums are not mma.sync's: {bits}")
    else:
        phase("neural_floor", "not measured: no cuobjdump beside nvcc")
    timed = [(key, NEURAL_ASSETS[key][0], highest, cam, spin, NEURAL_ASSETS[key][1],
              (tnk if NEURAL_ASSETS[key][0] == "kerr" else tn).load_params(net_path(key))[0])
             for key, highest, cam, spin in (("n1", False, bt.Camera.default(), 0.0),
                                             ("n1_xl", False, side, 0.0),
                                             ("n2", False, side, SPIN),
                                             ("n2_fp32", True, side, SPIN),
                                             ("n1_fp32", True, bt.Camera.default(), 0.0))]
    timed += [(name, model, False, bt.Camera.default(), SPIN if model == "kerr" else 0.0,
               f"PLAN_NETS seed {seed}", bt.NeuralSurrogate(random_net(model, width, seed)))
              for name, (model, width, seed) in TIMED_PLAN_NETS.items()]
    neural_times = {}
    for key, model, highest, cam, spin, source, params in timed:
        tier = "highest" if highest else "default"
        params = params.to("cuda")
        plan = nk.kernel_plan(params, tier)
        name = neural_variant(model, highest, plan)
        scene = full_neural.replace(spin=spin)
        out = torch.empty((H, W), dtype=torch.int32, device="cuda")

        def launch():
            nk.neural_render_packed(params, cam, scene, precision=tier, device="cuda", out=out)

        launch()  # warm-up
        ms = cuda_ms(lambda: [launch() for _ in range(3)], 3, REPEATS)
        plain_ms = cuda_ms(lambda: nk.neural_render_packed_reference(
            params, cam, scene, precision=tier, device="cuda"), 1)
        feats = torch.randn((W * H, params[0][0].shape[0]), generator=gen, device="cuda")
        tn.mlp_apply(params, feats, precision=tier)  # warm-up
        library_ms = cuda_ms(lambda: tn.mlp_apply(params, feats, precision=tier), 1, REPEATS)
        b, by = neural_bound(params, model, highest, W * H)
        desc = (f"{source} (hidden {params.widths}), {tier}, spin {spin}, camera "
                f"{cam.position.tolist()}, {W}x{H}, block plan {plan}, "
                f"{nk.smem_bytes(nk.mlp_dims(params), plan, tier)} bytes of shared memory")
        neural_times[key] = {"ms": ms, "library_ms": library_ms}
        rec = var.neural(model, highest, plan)
        rec.update(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=library_ms,
                   config=desc)
        chains = f"cuBLAS MLP chain {library_ms:.3f} ms"
        if not highest:
            layers = [(w.to(torch.bfloat16), bias.to(torch.bfloat16)) for w, bias in params]
            xb = feats.to(torch.bfloat16)
            nf.bf16_chain(layers, xb)  # warm-up
            bf16_ms = cuda_ms(lambda: nf.bf16_chain(layers, xb), 1, REPEATS)
            neural_times[key]["bf16_chain_ms"] = rec["bf16_chain_ms"] = bf16_ms
            chains += (f" (fp32 operands), bf16 tensor-core chain {bf16_ms:.3f} ms (bf16 "
                       "torch.matmul, bias, torch.tanh; each sum rounded to bf16, not bit-equal)")
            if floor_in:
                mhz = float(sass_walk.sm_clock_under_load(launch, ms).split(",")[0])
                terms = nf.frame_floor(floor_in, nk.mlp_dims(params), plan, W * H,
                                       model == "kerr", mhz)
                neural_times[key]["floor_ms"] = terms["floor_ms"]
                phase("neural_timing", neural_floor_line(f"{name} frame", terms, ms, smi))
        phase("neural_timing", f"{name} ({desc}): kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"{chains}, bound {b:.3f} ms ({by}) on {smi}")
        if highest:
            phase("neural_timing", fp32_timing(f"{name} frame", ms, b, library_ms, smi))
        del params, feats

    # 12. texture skyboxes, small: every texture tier x {euler, rk4 + disk,
    # kerr} x math tier; the kernel's trace and the device epilogue against
    # the plain trace and the same epilogue
    sw, sh, ss = SMALL
    scene = bt.SceneParams(screen_width=sw, screen_height=sh, max_steps=ss, spin=SPIN)
    small_tex = bt.load_skybox(None, seed=7, shape=SMALL_TEXTURE)
    n_cases, worst = 0, {}
    tex_configs = (dict(), dict(integrator="rk4", disk=True), dict(model="kerr"))
    for kw in tex_configs:
        for fast in (True, False):
            plain_res = None
            for filt, sub in TEX_TIERS:
                r = bt.BlackHoleRenderer(sw, sh, fast_math=fast, device="cuda", skybox=small_tex,
                                         texture_filter=filt, texture_subsample=sub, **kw)
                if plain_res is None:
                    plain_res = plain_trace(side, scene, r.config, fast)
                reset()
                frame = r.render_frame(side, scene)
                torch.cuda.synchronize()
                if all_counts() != (0, 1, 0, 0, 0, 0):
                    raise AssertionError(f"textured {r.config} frame launched {all_counts()}")
                var.launched("trace_planes", fast, r.config.integrator, 1, r.config.model)
                plain = r._frame_plan(scene).shade(plain_res, side)
                k_status = tk.trace_image(side, scene, r.config, fast_math=fast,
                                          device="cuda").status
                st = compare(frame.view(torch.int32).view(sh, sw), plain, fast, k_status,
                             plain_res.status)
                var.err("trace_planes", fast, r.config.integrator, st["max_abs_err"],
                        r.config.model)
                n_cases += 1
                for key in ("bit_same", "within_1", "status_agree", "captured_black"):
                    worst[key] = min(worst.get(key, 1.0), st[key])
                worst["max_abs_err"] = max(worst.get("max_abs_err", 0), st["max_abs_err"])
    phase("textures_small", f"{n_cases} frames at {sw}x{sh}x{ss}, a {SMALL_TEXTURE[0]}x"
          f"{SMALL_TEXTURE[1]} texture (seed 7): tiers {list(TEX_TIERS)} x (euler, rk4 + disk, "
          f"kerr spin {SPIN}) x fast/exact, each 1 trace_planes launch and the device epilogue, "
          f"held to its tier's bar against the plain trace and the same epilogue; worst over "
          f"the cases: " + json.dumps(worst))

    # 13. texture skyboxes at full width: the 2048x4096 procedural texture
    # (32 MB packed on the card). (a) The main path with a skybox, both
    # tiers x bilinear / nearest / luma: one trace_planes launch a frame,
    # the trace and the texture epilogue timed apart
    big_tex = bt.load_skybox(None)
    default_cam = bt.Camera.default()
    planes = tk.empty_trace_result(H, W, "cuda")
    textured = {}
    for filt in ("bilinear", "nearest", "luma"):
        r = bt.BlackHoleRenderer(W, H, device="cuda", skybox=big_tex, texture_filter=filt)
        textured[filt] = r
        words = (r.skybox[0].numel() + r.skybox[1].numel() if filt == "luma"
                 else r.skybox.numel())
        for fast in (True, False):
            tier = "fast" if fast else "exact"
            r.fast_math = fast
            reset()
            frame = r.render_frame(default_cam, full_scene)
            torch.cuda.synchronize()
            if all_counts() != (0, 1, 0, 0, 0, 0):
                raise AssertionError(f"textured main path launched {all_counts()}")
            var.launched("trace_planes", fast, "euler", 1)
            plain_res = records[tier].get("plain_res")
            if plain_res is None:
                plain_res = records[tier]["plain_res"] = plain_trace(default_cam, full_scene,
                                                                     r.config, fast)
            plan = r._frame_plan(full_scene)
            plain = plan.shade(plain_res, default_cam)
            k_res = tk.trace_image(default_cam, full_scene, r.config, fast_math=fast,
                                   device="cuda", out=planes)
            st = compare(frame.view(torch.int32).view(H, W), plain, fast, k_res.status,
                         plain_res.status)
            var.err("trace_planes", fast, "euler", st["max_abs_err"])
            trace_ms = cuda_ms(lambda: [tk.trace_image(default_cam, full_scene, r.config,
                                                       fast_math=fast, device="cuda", out=planes)
                                        for _ in range(3)], 3, REPEATS)
            shade = lambda: plan.shade(k_res, default_cam)
            epilogue_ms = cuda_ms(lambda: [shade() for _ in range(3)], 3, REPEATS)
            stars_ms = cuda_ms(lambda: [shade_image_reference(k_res, default_cam, full_scene,
                                                              None, None, tonemap="passthrough")
                                        for _ in range(3)], 3, REPEATS)
            frame_ms = cuda_ms(lambda: r.render_frame(default_cam, full_scene), 1, REPEATS)
            issue_ms = host_ms(lambda: r.render_frame(default_cam, full_scene), REPEATS)
            phase("textures_main", f"{W}x{H}x{STEPS} euler {tier}, skybox 2048x4096 ({words * 4} "
                  f"bytes packed on the card), filter {filt}: render_frame 1 trace_planes launch "
                  f"({bar(fast)}): {json.dumps(st)}; trace {trace_ms:.3f} ms, texture epilogue "
                  f"{epilogue_ms:.3f} ms (the plain star-field epilogue on the same planes: "
                  f"{stars_ms:.3f} ms), render_frame {frame_ms:.3f} ms, which the host issues in "
                  f"{issue_ms:.3f} ms (medians of {REPEATS}) on {smi}")

    # (b) BASELINE config 4's scene with the skybox: staged in both tiers
    for fast in (True, False):
        tier = "fast" if fast else "exact"
        r = bt.BlackHoleRenderer(W, H, fast_math=fast, device="cuda", skybox=big_tex, **cfg4)
        reset()
        frame = r.render_frame(side, full_scene)
        torch.cuda.synchronize()
        if all_counts() != (0, 1, 0, 0, 0, 0):
            raise AssertionError(f"textured BASELINE 4 {tier} launched {all_counts()}")
        var.launched("trace_planes", fast, "rk4", 1)
        plain_res = plain_trace(side, full_scene, r.config, fast)
        plain = r._frame_plan(full_scene).shade(plain_res, side)
        k_res = tk.trace_image(side, full_scene, r.config, fast_math=fast, device="cuda",
                               out=planes)
        st = compare(frame.view(torch.int32).view(H, W), plain, fast, k_res.status,
                     plain_res.status)
        var.err("trace_planes", fast, "rk4", st["max_abs_err"])
        st.update(shares(plain_res))
        epilogue_ms = cuda_ms(lambda: r._frame_plan(full_scene).shade(k_res, side), 1, REPEATS)
        frame_ms = cuda_ms(lambda: r.render_frame(side, full_scene), 1, REPEATS)
        phase("textures_baseline4", f"{W}x{H}x{STEPS} rk4 adaptive disk {tier}, skybox 2048x4096 "
              f"bilinear: render_frame 1 trace_planes launch ({bar(fast)}): {json.dumps(st)}; "
              f"epilogue (texture + disk) {epilogue_ms:.3f} ms, render_frame {frame_ms:.3f} ms "
              f"(medians of {REPEATS}) on {smi}")

    # (c) cache_deflection: N_FRAMES frames of a camera that stands still
    # are 1 trace launch and N_FRAMES epilogues; (d) N_FRAMES orbit frames
    # with no host sync, each against the plain trace and the same epilogue
    r = bt.BlackHoleRenderer(W, H, fast_math=True, device="cuda", skybox=big_tex,
                             cache_deflection=True)
    want = textured["bilinear"]
    want.fast_math = True
    uncached = want.render_frame(side, full_scene)
    reset()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    cached = [r.render_frame(side, full_scene)]  # traces
    t0.record()
    cached += [r.render_frame(side, full_scene) for _ in range(N_FRAMES - 1)]
    t1.record()
    torch.cuda.synchronize()
    if all_counts() != (0, 1, 0, 0, 0, 0) or not all(torch.equal(c, uncached) for c in cached):
        raise AssertionError(f"cache_deflection launched {all_counts()} or changed the frame")
    var.launched("trace_planes", True, "euler", 1)
    cached_ms = t0.elapsed_time(t1) / (N_FRAMES - 1)
    r.render_frame(default_cam, full_scene)  # another camera: a new trace
    if C[N_TRACE] != 2:
        raise AssertionError(f"a moved camera did not trace again: {all_counts()}")
    var.launched("trace_planes", True, "euler", 1)
    phase("textures_cache", f"{W}x{H}x{STEPS} euler fast, skybox bilinear, cache_deflection: "
          f"{N_FRAMES} frames of one camera = 1 trace_planes launch, every frame equal to the "
          f"uncached one; a cached frame {cached_ms:.3f} ms (the epilogue alone); a moved "
          f"camera traces again")

    bt.OrbitAnimator(want).render_frames(1, packed=True)  # warm-up
    reset()
    frames, tex_anim_ms, anim = animate(want, N_FRAMES)
    if all_counts() != (0, N_FRAMES, 0, 0, 0, 0) or frames.shape != (N_FRAMES, H, W):
        raise AssertionError(f"textured animation launched {all_counts()}")
    var.launched("trace_planes", True, "euler", N_FRAMES)
    worst_anim = 1.0
    for k, t in enumerate(anim.frame_times(N_FRAMES)):
        cam = bt.orbit_camera(t)
        plain_res = plain_trace(cam, full_scene, want.config, True)
        plain = want._frame_plan(full_scene).shade(plain_res, cam)
        k_status = tk.trace_image(cam, full_scene, want.config, fast_math=True, device="cuda",
                                  out=planes).status
        st = compare(frames[k], plain, True, k_status, plain_res.status)
        var.err("trace_planes", True, "euler", st["max_abs_err"])
        worst_anim = min(worst_anim, st["within_1"])
    phase("textures_animation", f"{N_FRAMES} frames {W}x{H}x{STEPS} euler fast, skybox "
          f"bilinear: OrbitAnimator {tex_anim_ms:.3f} ms/frame with no host sync (CUDA events, "
          f"sync debug mode 'error'), {N_FRAMES} trace_planes launches; every frame held to "
          f"{bar(True)} (worst within_1 {worst_anim:.6f}); the star-field main path in the "
          f"same run: {records['fast']['anim_ms']:.3f} ms/frame on {smi}")
    del frames, cached, uncached

    # 14. multires at full width: (a) trace_planes' strided and masked
    # ray-gen against their plain versions on every pixel, and their times
    multires_cases = (("euler", {}, default_cam), ("rk4", cfg4, side))
    pass_ms = {}
    for integ, kw, cam in multires_cases:
        config = bt.TraceConfig(**kw)
        desc = (f"{integ}, {'adaptive' if config.adaptive else 'fixed'} dt, "
                f"{'disk' if config.disk else 'no disk'}, camera {cam.position.tolist()}, "
                f"{W}x{H}x{STEPS}")
        for fast in (True, False):
            tier = "fast" if fast else "exact"
            for d in DIVISORS:
                local = (-(-H // d), -(-W // d))
                args = dict(stride=d, local_shape=local)
                k_low = tk.trace_image(cam, full_scene, config, fast_math=fast, device="cuda",
                                       **args)
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                p_low = tk.trace_image_reference(cam, full_scene, config, fast_math=fast,
                                                 device="cuda", **args)
                t1.record()
                torch.cuda.synchronize()
                low_plain_ms = t0.elapsed_time(t1)
                st_low = trace_compare(k_low, p_low, fast)
                if not fast:
                    hold_bits(f"trace_planes[strided]<exact,{integ}> divisor {d}", k_low, p_low)
                low_planes = tk.empty_trace_result(*local, "cuda")
                low_ms = cuda_ms(lambda: [tk.trace_image(cam, full_scene, config, fast_math=fast,
                                                         device="cuda", out=low_planes, **args)
                                          for _ in range(3)], 3, REPEATS)
                edge = deflection_edges([k_low.final_vel[..., i] for i in range(3)],
                                        k_low.status, 0.05)
                edge = (edge.repeat_interleave(d, dim=0).repeat_interleave(d, dim=1)[:H, :W]
                        .contiguous())
                keep = edge.mean().item()
                k_fix = tk.trace_image(cam, full_scene, config, fast_math=fast, device="cuda",
                                       mask=edge)
                t0.record()
                p_fix = tk.trace_image_reference(cam, full_scene, config, fast_math=fast,
                                                 device="cuda", mask=edge)
                t1.record()
                torch.cuda.synchronize()
                fix_plain_ms = t0.elapsed_time(t1)
                st_fix = trace_compare(k_fix, p_fix, fast)
                if not fast:
                    hold_bits(f"trace_planes[masked]<exact,{integ}> divisor {d}", k_fix, p_fix)
                fix_ms = cuda_ms(lambda: [tk.trace_image(cam, full_scene, config, fast_math=fast,
                                                         device="cuda", out=planes, mask=edge)
                                          for _ in range(3)], 3, REPEATS)
                pass_ms[(integ, fast, d)] = (low_ms, fix_ms, keep)
                for what, ms, plain_ms, res, st, pixels, note in (
                        ("strided", low_ms, low_plain_ms, p_low, st_low, local[0] * local[1],
                         f"stride {d}, local {local[0]}x{local[1]}"),
                        ("masked", fix_ms, fix_plain_ms, p_fix, st_fix, W * H,
                         f"edge mask of the stride-{d} pass, keeps {keep:.4f} of the pixels")):
                    rec = var.other(f"trace_planes[{what}]<{tier},{integ}>", "trace_planes",
                                    REPLACES[what])
                    rec["max_abs_err"] = max(rec["max_abs_err"], st["max_abs_err"])
                    if d != DIVISORS[-1]:
                        continue  # the kernels line carries the last divisor's times
                    ray_steps = int(res.steps.sum().item())
                    b, by = bound(f"trace_planes[{what}]", "schwarzschild", fast, integ,
                                  ray_steps, pixels, adaptive=config.adaptive, disk=config.disk)
                    rec.update(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                               config=f"{desc}; {note}", ray_steps=ray_steps)
                phase("multires_kernels", f"{desc} {tier}, divisor {d}: strided "
                      f"{local[1]}x{local[0]} against its plain version on every pixel: "
                      f"{json.dumps(st_low)}, kernel {low_ms:.3f} ms, plain {low_plain_ms:.1f} ms; "
                      f"masked (the mask keeps {keep:.4f} of the pixels) on every pixel: "
                      f"{json.dumps(st_fix)}, kernel {fix_ms:.3f} ms, plain {fix_plain_ms:.1f} ms "
                      f"(kernels: medians of {REPEATS} x 3) on {smi}")

    # (b) render_frame_multires against the full frame: the star field and
    # the texture, with and without the disk, both tiers, 2 launches a frame
    for integ, kw, cam in multires_cases:
        for fast in (True, False):
            tier = "fast" if fast else "exact"
            for sky in (None, big_tex):
                r = bt.BlackHoleRenderer(W, H, fast_math=fast, device="cuda", skybox=sky, **kw)
                full = r.render_frame(cam, full_scene)
                full_ms = cuda_ms(lambda: r.render_frame(cam, full_scene), 1, REPEATS)
                full_issue_ms = host_ms(lambda: r.render_frame(cam, full_scene), REPEATS)
                for d in DIVISORS:
                    reset()
                    multi = r.render_frame_multires(cam, full_scene, divisor=d)
                    torch.cuda.synchronize()
                    if all_counts() != (0, 2, 1, 1, 0, 0):
                        raise AssertionError(f"multires frame launched {all_counts()}")
                    for what in ("strided", "masked"):
                        var.other(f"trace_planes[{what}]<{tier},{integ}>", "trace_planes",
                                  REPLACES[what])["launches"] += 1
                    st = multires_compare(multi, full)
                    ms = cuda_ms(lambda: r.render_frame_multires(cam, full_scene, divisor=d), 1,
                                 REPEATS)
                    issue_ms = host_ms(
                        lambda: r.render_frame_multires(cam, full_scene, divisor=d), REPEATS)
                    low_ms, fix_ms, keep = pass_ms[(integ, fast, d)]
                    phase("multires", f"{W}x{H}x{STEPS} {integ}{' adaptive disk' if kw else ''} "
                          f"{tier}, {'skybox bilinear' if sky is not None else 'star field'}, "
                          f"divisor {d}: 2 trace_planes launches (strided, masked); against the "
                          f"full frame (mean_err < {MULTIRES_MEAN_MAX}, off_by_more_than_16 < "
                          f"{MULTIRES_OFF16_MAX}): {json.dumps(st)}; multires frame {ms:.3f} ms "
                          f"(strided pass {low_ms:.3f}, masked pass {fix_ms:.3f} keeping "
                          f"{keep:.4f}; the host issues the frame in {issue_ms:.3f} ms), full "
                          f"render_frame {full_ms:.3f} ms (issued in {full_issue_ms:.3f} ms) "
                          f"(medians of {REPEATS}) on {smi}")

    # (c) OrbitAnimator with renderer.multires: 2 launches a frame, no host sync
    r = bt.BlackHoleRenderer(W, H, fast_math=True, device="cuda", skybox=big_tex,
                             multires=DIVISORS[-1], **cfg4)
    bt.OrbitAnimator(r).render_frames(1, packed=True)  # warm-up
    reset()
    frames, multi_anim_ms, anim = animate(r, N_FRAMES)
    if all_counts() != (0, 2 * N_FRAMES, N_FRAMES, N_FRAMES, 0, 0):
        raise AssertionError(f"multires animation launched {all_counts()}")
    for what in ("strided", "masked"):
        var.other(f"trace_planes[{what}]<fast,rk4>", "trace_planes",
                  REPLACES[what])["launches"] += N_FRAMES
    r.multires = 0
    full_frames, full_anim_ms, _ = animate(r, N_FRAMES)
    worst_multi = [multires_compare(unpack(frames[k]), unpack(full_frames[k]))
                   for k in range(N_FRAMES)]
    phase("multires_animation", f"{N_FRAMES} frames {W}x{H}x{STEPS} rk4 adaptive disk fast, "
          f"skybox bilinear, renderer.multires = {DIVISORS[-1]}: OrbitAnimator "
          f"{multi_anim_ms:.3f} ms/frame with no host sync (sync debug mode 'error'), "
          f"{2 * N_FRAMES} trace_planes launches; at full resolution {full_anim_ms:.3f} "
          f"ms/frame; every frame inside the budget (worst mean_err "
          f"{max(s['mean_err'] for s in worst_multi):.4f}, off_by_more_than_16 "
          f"{max(s['off_by_more_than_16'] for s in worst_multi):.6f}) on {smi}")
    del frames, full_frames

    # 15. the neural surrogate with a skybox: the direction-plane output of
    # neural_mlp (N3) and the texture epilogue. (a) 160x96: the committed
    # nets at their tiers and PLAN_NETS, both cameras
    sw, sh = SMALL[:2]
    small_nets = [(NEURAL_ASSETS[key][1], NEURAL_ASSETS[key][0], tier, spin, net_path(key))
                  for key, tier, spin in matrix]
    small_nets += [(f"random net {model} {width}", model, tier, SPIN if model == "kerr" else 0.0,
                    bt.NeuralSurrogate(random_net(model, width, seed)))
                   for tier, model, width, seed in PLAN_NETS]
    worst = {}
    for name, model, tier, spin, net in small_nets:
        highest = tier == "highest"
        r = bt.BlackHoleRenderer(sw, sh, "neural", model=model, neural_params=net,
                                 neural_precision=tier, device="cuda", skybox=small_tex)
        rec = var.other(f"neural_dirs<{model},{tier}>", "neural_mlp", REPLACES["dirs"])
        for cam in (default_cam, side):
            scene = bt.SceneParams(screen_width=sw, screen_height=sh, spin=spin)
            reset()
            frame = r.render_frame(cam, scene)
            torch.cuda.synchronize()
            if all_counts() != (0, 0, 0, 0, 0, 1):
                raise AssertionError(f"neural textured frame ({name}) launched {all_counts()}")
            rec["launches"] += 1
            k = nk.neural_trace_dirs(r.neural_params, cam, scene, precision=tier, device="cuda")
            p = nk.neural_trace_dirs_reference(r.neural_params, cam, scene, precision=tier,
                                               device="cuda")
            st = dirs_compare(k, p, highest)
            plain = r._frame_plan(scene).shade(p, cam)
            fs = textured_neural_compare(frame.view(torch.int32).view(sh, sw), plain, highest)
            rec["max_abs_err"] = max(rec["max_abs_err"], st["max_abs_err"])
            w = worst.setdefault(tier, {})
            for key in ("status_agree", "vel_close", "vel_within_1e-6", "vel_bit_same"):
                w[key] = min(w.get(key, 1.0), st[key])
            w["max_abs_err"] = max(w.get("max_abs_err", 0.0), st["max_abs_err"])
            w["frame_bit_same"] = min(w.get("frame_bit_same", 1.0), fs["bit_same"])
    phase("neural_dirs_matrix", f"{2 * len(small_nets)} frames at {sw}x{sh} with the "
          f"{SMALL_TEXTURE[0]}x{SMALL_TEXTURE[1]} texture: the {len(matrix)} committed-net cases "
          f"and the {len(PLAN_NETS)} PLAN_NETS, cameras default and [15,5,0], each 1 neural_mlp "
          f"launch with its direction-plane output, held against the plain version (default: "
          f"{dirs_bar(False)}; highest: {dirs_bar(True)}) and, shaded, against the all-plain "
          f"frame; worst by tier: " + json.dumps(worst))

    # the routes that stay staged with a skybox: bf16 operands, a debug view
    for kw, dbg in ((dict(neural_dtype="bfloat16"), 0), ({}, 1)):
        r = bt.BlackHoleRenderer(sw, sh, "neural", device="cuda", skybox=small_tex, **kw)
        reset()
        r.render_frame(side, bt.SceneParams(debug_mode=dbg))
        torch.cuda.synchronize()
        if all_counts() != (0, 0, 0, 0, 0, 0):
            raise AssertionError(f"staged neural textured frame launched {all_counts()}")

    # (b) 1920x1080: N1, N2 and N2 at the highest tier through render_frame,
    # the kernel's time beside the frame kernel's, its bound and the cuBLAS
    # chain timed above
    for key, kw, spin, cam in main:
        model = NEURAL_ASSETS[key][0]
        r = bt.BlackHoleRenderer(W, H, "neural", model=model, device="cuda", skybox=big_tex, **kw)
        tier = r.neural_precision
        highest = tier == "highest"
        scene = full_neural.replace(spin=spin)
        rec = var.other(f"neural_dirs<{model},{tier}>", "neural_mlp", REPLACES["dirs"])
        reset()
        frame = r.render_frame(cam, scene)
        torch.cuda.synchronize()
        if all_counts() != (0, 0, 0, 0, 0, 1):
            raise AssertionError(f"neural textured main path {key} launched {all_counts()}")
        rec["launches"] += 1
        out = tk.empty_trace_result(H, W, "cuda")
        k = nk.neural_trace_dirs(r.neural_params, cam, scene, precision=tier, device="cuda",
                                 out=out)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        p = nk.neural_trace_dirs_reference(r.neural_params, cam, scene, precision=tier,
                                           device="cuda")
        t1.record()
        torch.cuda.synchronize()
        plain_ms = t0.elapsed_time(t1)
        st = dirs_compare(k, p, highest)
        plan = r._frame_plan(scene)
        plain = plan.shade(p, cam)
        fs = textured_neural_compare(frame.view(torch.int32).view(H, W), plain, highest)
        ms = cuda_ms(lambda: [nk.neural_trace_dirs(r.neural_params, cam, scene, precision=tier,
                                                   device="cuda", out=out) for _ in range(3)],
                     3, REPEATS)
        epilogue_ms = cuda_ms(lambda: plan.shade(k, cam), 1, REPEATS)
        frame_ms = cuda_ms(lambda: r.render_frame(cam, scene), 1, REPEATS)
        b, by = neural_bound(r.neural_params, model, highest, W * H, dirs=True)
        desc = (f"{NEURAL_ASSETS[key][1]} (hidden {r.neural_params.widths}), {tier}, spin {spin}, "
                f"camera {cam.position.tolist()}, {W}x{H}")
        rec.update(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by, config=desc,
                   library_ms=neural_times[key]["library_ms"],
                   max_abs_err=max(rec["max_abs_err"], st["max_abs_err"]))
        chains = f"cuBLAS MLP chain {neural_times[key]['library_ms']:.3f} ms"
        if not highest:
            rec["bf16_chain_ms"] = neural_times[key]["bf16_chain_ms"]
            chains += f", bf16 tensor-core chain {rec['bf16_chain_ms']:.3f} ms"
        if highest:
            phase("neural_timing", fp32_timing(f"neural_dirs<{model},highest> (N3 planes)", ms,
                                               b, neural_times[key]["library_ms"], smi))
        phase("neural_dirs_main", f"neural_dirs<{model},{tier}> ({desc}), skybox 2048x4096 "
              f"bilinear: render_frame 1 neural_mlp launch; direction planes ({dirs_bar(highest)}"
              f"): {json.dumps(st)}; shaded frame against the all-plain one: {json.dumps(fs)}; "
              f"kernel {ms:.3f} ms (the frame kernel on the same net: "
              f"{neural_times[key]['ms']:.3f} ms), plain {plain_ms:.3f} ms, {chains}, bound "
              f"{b:.3f} ms ({by}); texture "
              f"epilogue {epilogue_ms:.3f} ms, render_frame {frame_ms:.3f} ms (medians of "
              f"{REPEATS}) on {smi}")
        del out, k, p, plain

    # 16. row bands and the mesh (parallel/mesh.py) on the one card named
    # SP times: (a) the main path in both tiers and BASELINE config 4's exact
    # (staged) frame, each band one launch, the frame bit-equal to the
    # whole frame's kernel frame on every pixel
    band_mesh = pm.make_mesh(devices=["cuda:0"] * SP, shape=(1, SP))
    for name, kw, cam, fast in (("main path", {}, default_cam, True),
                                ("main path", {}, default_cam, False),
                                ("BASELINE config 4", cfg4, side, False)):
        tier = "fast" if fast else "exact"
        r = bt.BlackHoleRenderer(W, H, fast_math=fast, device="cuda", **kw)
        plan = r._frame_plan(full_scene)
        mono = plan.route == "mono"
        whole = r.render_frame(cam, full_scene)
        shard = lambda: pm.render_frame_sharded(
            cam, full_scene, None, band_mesh, config=r.config, fast_math=fast,
            disk_params=plan.disk_params, lut=plan.lut)
        reset()
        frame = shard()
        torch.cuda.synchronize()
        want = (SP, 0) if mono else (0, SP)
        if (C[N_MONO], C[N_TRACE]) != want:
            raise AssertionError(f"{name} {tier} bands launched {C[N_MONO]}, {C[N_TRACE]}")
        kernel = "render_mono" if mono else "trace_planes"
        var.launched(kernel, fast, r.config.integrator, SP)
        same = (frame == whole).all(-1).float().mean().item()
        if same != 1.0:
            raise AssertionError(f"{name} {tier}: the bands equal the whole frame on {same}")
        sharded_ms = cuda_ms(shard, 1, REPEATS)
        whole_ms = cuda_ms(lambda: r.render_frame(cam, full_scene), 1, REPEATS)
        phase("bands", f"{W}x{H}x{STEPS} {name} {tier}: render_frame_sharded on {SP} bands of "
              f"{H // SP} rows of the one card, {SP} {kernel} launches, bit-equal to the whole "
              f"frame on {same:.6f} of the pixels; sharded frame {sharded_ms:.3f} ms, whole "
              f"frame {whole_ms:.3f} ms (medians of {REPEATS}) on {smi}")

    # (b) a height that does not divide over SP_ODD bands: the last band is
    # padded past the image and its padded rows sliced off
    odd_mesh = pm.make_mesh(devices=["cuda:0"] * SP_ODD, shape=(1, SP_ODD))
    r = records["fast"]["renderer"]
    whole = r.render_frame(default_cam, full_scene)
    reset()
    frame = pm.render_frame_sharded(default_cam, full_scene, None, odd_mesh, fast_math=True)
    torch.cuda.synchronize()
    band_h = -(-H // SP_ODD)
    if C[N_MONO] != SP_ODD or frame.shape != (H, W, 4) or not torch.equal(frame, whole):
        raise AssertionError(f"{SP_ODD} bands of {band_h} rows: {C[N_MONO]} launches, "
                             f"{tuple(frame.shape)}, equal {torch.equal(frame, whole)}")
    var.launched("render_mono", True, "euler", SP_ODD)
    phase("bands_padded", f"{W}x{H}x{STEPS} main path fast on {SP_ODD} bands of {band_h} rows "
          f"({SP_ODD * band_h - H} padded rows sliced off): {SP_ODD} render_mono launches, the "
          f"frame bit-equal to the whole frame")

    # (c) render_animation_sharded: 4 orbit frames on a (2, 2) mesh of the
    # card, frames equal to OrbitAnimator's and the luminance their mean green
    anim_mesh = pm.make_mesh(devices=["cuda:0"] * 4, shape=ANIM_MESH)
    n_anim = 2 * ANIM_MESH[0]
    anim = bt.OrbitAnimator(r)
    times = anim.frame_times(n_anim)
    reset()
    frames, lums = pm.render_animation_sharded(times, full_scene, None, anim_mesh, fast_math=True)
    torch.cuda.synchronize()
    n = n_anim * ANIM_MESH[1]
    if C[N_MONO] != n:
        raise AssertionError(f"sharded animation launched {C[N_MONO]}, not {n}")
    var.launched("render_mono", True, "euler", n)
    want = anim.render_frames(n_anim)
    g_mean = want[..., 1].float().mean(dim=(1, 2))
    lum_err = ((lums - g_mean).abs() / g_mean).max().item()
    if not torch.equal(frames, want) or lum_err > 1e-5:
        raise AssertionError(f"sharded animation differs: equal {torch.equal(frames, want)}, "
                             f"luminance rel. error {lum_err}")
    phase("bands_animation", f"{n_anim} orbit frames {W}x{H}x{STEPS} fast on a "
          f"{ANIM_MESH[0]}x{ANIM_MESH[1]} (dp x sp) mesh of the card: {n} render_mono launches, "
          f"every frame equal to OrbitAnimator's, luminance (the bands' partial sums) "
          f"{[round(x, 6) for x in lums.tolist()]} within {lum_err:.2e} of the frames' mean green")
    del frames, want

    # 17. N4: the neural kernel's band, N1 and N2 (spin 0.9) in both kernel
    # tiers at sp = SP through render_frame_sharded, bit-equal to
    # neural_render_packed's whole frame; one band against its plain
    # version; the band's time beside the whole frame's; then the same
    # frames with the texture, bit-equal to render_frame's
    band_rows = H // SP
    for key, kw, spin, cam in main:
        model = NEURAL_ASSETS[key][0]
        r = bt.BlackHoleRenderer(W, H, "neural", model=model, device="cuda", **kw)
        tier = r.neural_precision
        highest = tier == "highest"
        scene = full_neural.replace(spin=spin)
        whole = nk.neural_render_packed(r.neural_params, cam, scene, precision=tier, device="cuda")
        rec = var.other(f"neural_band<{model},{tier}>", "neural_mlp", REPLACES["band"])
        reset()
        frame = pm.render_frame_sharded(cam, scene, None, band_mesh, config=r.config,
                                        neural_params=r.neural_params, neural_precision=tier)
        torch.cuda.synchronize()
        if (C[N_NEURAL], C[N_BAND]) != (SP, SP):
            raise AssertionError(f"neural bands {key} launched {C[N_NEURAL]}, "
                                 f"{C[N_BAND]}")
        rec["launches"] += SP
        same = (frame.view(torch.int32).view(H, W) == whole).float().mean().item()
        if same != 1.0:
            raise AssertionError(f"neural bands {key}: equal to the whole frame on {same}")
        row0 = band_rows  # the second band
        out = torch.empty((band_rows, W), dtype=torch.int32, device="cuda")
        band = nk.neural_render_packed_band(r.neural_params, cam, scene, row0, band_rows,
                                            precision=tier, device="cuda")
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        plain = nk.neural_render_packed_reference(r.neural_params, cam, scene, precision=tier,
                                                  device="cuda", row0=row0,
                                                  local_shape=(band_rows, W))
        t1.record()
        torch.cuda.synchronize()
        plain_ms = t0.elapsed_time(t1)
        st = neural_compare(band, plain, highest)
        # a band's kernel is shorter than the host's issue of it: queued
        # behind a spin kernel, its time is the card's
        ms = device_time_ms(lambda: nk.neural_render_packed(
            r.neural_params, cam, scene, precision=tier, device="cuda", out=out, row0=row0,
            local_shape=(band_rows, W)), repeats=REPEATS, device="cuda")
        feats = torch.randn((W * band_rows, r.neural_params[0][0].shape[0]), generator=gen,
                            device="cuda")
        tn.mlp_apply(r.neural_params, feats, precision=tier)  # warm-up
        library_ms = cuda_ms(lambda: tn.mlp_apply(r.neural_params, feats, precision=tier), 1,
                             REPEATS)
        chains = f"cuBLAS MLP chain {library_ms:.3f} ms"
        if not highest:
            layers = [(w.to(torch.bfloat16), bias.to(torch.bfloat16))
                      for w, bias in r.neural_params]
            xb = feats.to(torch.bfloat16)
            nf.bf16_chain(layers, xb)  # warm-up
            rec["bf16_chain_ms"] = cuda_ms(lambda: nf.bf16_chain(layers, xb), 1, REPEATS)
            chains += f", bf16 tensor-core chain {rec['bf16_chain_ms']:.3f} ms"
            del layers, xb
        b, by = neural_bound(r.neural_params, model, highest, W * band_rows)
        desc = (f"{NEURAL_ASSETS[key][1]} (hidden {r.neural_params.widths}), {tier}, spin {spin}, "
                f"camera {cam.position.tolist()}, rows {row0}-{row0 + band_rows - 1} of {W}x{H}")
        rec.update(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=library_ms,
                   config=desc, max_abs_err=max(rec["max_abs_err"], st["max_abs_err"]))
        if highest:
            phase("neural_timing", fp32_timing(f"neural_band<{model},highest> (N4, {band_rows} "
                                               "rows)", ms, b, library_ms, smi))
        phase("neural_band", f"neural_band<{model},{tier}> ({desc}): render_frame_sharded {SP} "
              f"neural_mlp band launches, bit-equal to the whole frame on {same:.6f}; one band "
              f"against its plain version ({neural_bar(highest)}): {json.dumps(st)}; band kernel "
              f"{ms:.3f} ms (the whole frame's kernel {neural_times[key]['ms']:.3f} ms), plain "
              f"{plain_ms:.3f} ms, {chains}, bound {b:.3f} ms ({by}) on {smi}")
        del feats, out, band, plain, whole, frame
        # with the texture a band takes the route its whole frame takes: the
        # direction planes of its rows (N3's band) and the texture epilogue
        r = bt.BlackHoleRenderer(W, H, "neural", model=model, device="cuda", skybox=big_tex,
                                 **kw)
        whole = r.render_frame(cam, scene)
        reset()
        frame = pm.render_frame_sharded(cam, scene, r.skybox, band_mesh, config=r.config,
                                        neural_params=r.neural_params, neural_precision=tier,
                                        texture_filter=r.texture_filter)
        torch.cuda.synchronize()
        if all_counts() != (0, 0, 0, 0, 0, SP):
            raise AssertionError(f"textured neural bands {key} launched {all_counts()}")
        var.other(f"neural_dirs<{model},{tier}>", "neural_mlp", REPLACES["dirs"])["launches"] += SP
        same = (frame == whole).all(-1).float().mean().item()
        if same != 1.0:
            raise AssertionError(f"textured neural bands {key}: equal to the whole frame on {same}")
        phase("neural_band", f"neural_dirs<{model},{tier}> with the 2048x4096 texture, bilinear: "
              f"render_frame_sharded {SP} neural_mlp direction-plane band launches, the frame "
              f"bit-equal to render_frame's on {same:.6f} of the pixels")
        del whole, frame

    # 18. multires bands at divisor BAND_DIVISOR: Euler fast and config 4
    # exact, star field and texture, through render_frame_sharded(multires=)
    # at sp = SP (2 launches a band), each frame bit-equal to
    # render_frame_multires on every pixel
    for integ, kw, cam, fast in (("euler", {}, default_cam, True), ("rk4", cfg4, side, False)):
        tier = "fast" if fast else "exact"
        for sky in (None, big_tex):
            r = bt.BlackHoleRenderer(W, H, fast_math=fast, device="cuda", skybox=sky, **kw)
            whole = r.render_frame_multires(cam, full_scene, divisor=BAND_DIVISOR)
            reset()
            frame = pm.render_frame_sharded(cam, full_scene, r.skybox, band_mesh, config=r.config,
                                            fast_math=fast, disk_params=r.disk_params(full_scene),
                                            multires=BAND_DIVISOR)
            torch.cuda.synchronize()
            if all_counts() != (0, 2 * SP, SP, SP, 0, 0):
                raise AssertionError(f"multires bands launched {all_counts()}")
            for what in ("strided", "masked"):
                var.other(f"trace_planes[{what}]<{tier},{integ}>", "trace_planes",
                          REPLACES[what])["launches"] += SP
            same = (frame == whole).all(-1).float().mean().item()
            if same != 1.0:
                raise AssertionError(f"multires bands {integ} {tier}: equal on {same}")
            phase("multires_band", f"{W}x{H}x{STEPS} {integ}{' adaptive disk' if kw else ''} "
                  f"{tier}, {'skybox bilinear' if sky is not None else 'star field'}, divisor "
                  f"{BAND_DIVISOR}: {SP} bands of render_multires_band (a strided and a masked "
                  f"trace_planes launch each), the frame bit-equal to render_frame_multires on "
                  f"{same:.6f} of the pixels")

    # 19. plugin physics: paczynski_wiita.py through
    # BlackHoleRenderer(custom_physics=) at full width, every integrator and
    # tier: one trace_planes launch a frame with the plugin's build; the
    # planes against the plain trace, the frame against the all-plain frame,
    # and the kernel's time beside the plain version's
    accel_ops = plugin_program.varying_ops
    for integ in ("euler", "rk4", "leapfrog"):
        for fast in (True, False):
            tier = "fast" if fast else "exact"
            r = bt.BlackHoleRenderer(W, H, integ, custom_physics=PLUGIN, fast_math=fast,
                                     device="cuda")
            if r.config.custom_accel is not plugin_accel:
                raise AssertionError("the renderer loaded another plugin function")
            reset()
            frame = r.render_frame(default_cam, full_scene)
            torch.cuda.synchronize()
            if (C[N_MONO], C[N_TRACE], C[N_CUSTOM]) != (0, 1, 1):
                raise AssertionError(f"custom {integ} {tier} launched {C[N_MONO]}, "
                                     f"{C[N_TRACE]}, {C[N_CUSTOM]}")
            rec = var.other(f"trace_planes[custom]<{tier},{integ}>", "trace_planes",
                            REPLACES["custom"])
            rec["launches"] += 1
            k_res = tk.trace_image(default_cam, full_scene, r.config, fast_math=fast,
                                   device="cuda", out=planes)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            p_res = tk.trace_image_reference(default_cam, full_scene, r.config, fast_math=fast,
                                             device="cuda")
            t1.record()
            torch.cuda.synchronize()
            plain_ms = t0.elapsed_time(t1)
            st = trace_compare(k_res, p_res, fast)
            if not fast:
                hold_bits(f"trace_planes[custom]<exact,{integ}> planes", k_res, p_res)
            plain = shade_image_reference(p_res, default_cam, full_scene, None, None,
                                          tonemap="passthrough")
            fs = compare(frame.view(torch.int32).view(H, W), plain, fast, k_res.status,
                         p_res.status)
            ms = cuda_ms(lambda: [tk.trace_image(default_cam, full_scene, r.config,
                                                 fast_math=fast, device="cuda", out=planes)
                                  for _ in range(3)], 3, REPEATS)
            ray_steps = int(p_res.steps.sum().item())
            b, by = bound("trace_planes", "custom", fast, integ, ray_steps, W * H, adaptive=False,
                          disk=False, accel_ops=accel_ops)
            desc = (f"{PLUGIN} (capture {plugin_cap} rs; {accel_ops} ray-varying operations a "
                    f"call), {integ}, fixed dt, no disk, camera {default_cam.position.tolist()}, "
                    f"{W}x{H}x{STEPS}")
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by, config=desc,
                       ray_steps=ray_steps,
                       max_abs_err=max(rec["max_abs_err"], st["max_abs_err"]))
            builtin = (f" (the built-in Schwarzschild trace of the same rays, timed above: "
                       f"{var.get('trace_planes', fast, 'euler')['ms']:.3f} ms)"
                       if integ == "euler" else "")
            phase("custom", f"trace_planes[custom]<{tier},{integ}> ({desc}): render_frame 1 "
                  f"trace_planes launch with the plugin's build; planes against the plain trace "
                  f"{json.dumps(st)}; frame against the all-plain frame ({bar(fast)}): "
                  f"{json.dumps(fs)}; kernel {ms:.3f} ms{builtin}, plain {plain_ms:.3f} ms, "
                  f"{ray_steps} ray-steps, bound {b:.3f} ms ({by}) on {smi}")
            del k_res, p_res, plain

    # 19'. plugin physics at 4K through the orbit loop (bench_torch's
    # pw4k.orbit_exact): PW4K_FRAMES OrbitAnimator frames of the exact tier
    # with no host sync, each one trace_planes launch of the plugin's build
    # and one shade_planes launch, no render_mono; each frame's planes by
    # the kernel bit-equal to the plain trace and the frame to the plain
    # staged frame; the plugin recorded once in the process; the
    # instantiation the launch runs, by the profiler's kernel name
    r_pw = bt.BlackHoleRenderer(W5, H5, custom_physics=PLUGIN, device="cuda")
    if r_pw.config.custom_accel is not plugin_accel or r_pw.fast_math:
        raise AssertionError("the 4K plugin renderer is not the exact tier of PLUGIN")
    r_pw.scene = bt.SceneParams(screen_width=W5, screen_height=H5)  # max_steps 500
    bt.OrbitAnimator(r_pw).render_frames(1, packed=True)  # warm-up
    torch.cuda.synchronize()
    reset()
    n = PW4K_FRAMES
    frames, pw_ms, anim = animate(r_pw, n)
    if (counts() != (0, n, 0) or (C[N_CUSTOM], C[N_SHADE], C[N_PLAIN]) != (n, n, 0)
            or frames.shape != (n, H5, W5)):
        raise AssertionError(f"4K plugin animation launched {counts()}, {C[N_CUSTOM]} custom, "
                             f"{C[N_SHADE]} shade_planes, {C[N_PLAIN]} plain epilogues: "
                             f"{tuple(frames.shape)}")
    if C[N_RECORDS] != 1:
        raise AssertionError(f"{PLUGIN} was recorded {C[N_RECORDS]} times in the process")
    rec = var.other("trace_planes[custom]<exact,euler>", "trace_planes", REPLACES["custom"])
    rec["launches"] += n
    shade_rec()["launches"] += n
    pw_stats = []
    for k, t in enumerate(anim.frame_times(n)):
        cam = bt.orbit_camera(t)
        plain, p_res = plain_staged(cam, r_pw.scene, r_pw.config, False, r_pw)
        k_res = tk.trace_image(cam, r_pw.scene, r_pw.config, device="cuda")
        st = compare(frames[k], plain, False, k_res.status, p_res.status)
        hold_bits(f"trace_planes[custom]<exact,euler> 4K orbit frame {k}", frames[k], plain)
        hold_bits(f"trace_planes[custom]<exact,euler> 4K orbit planes {k}", k_res, p_res)
        rec["max_abs_err"] = max(rec["max_abs_err"], st["max_abs_err"])
        st["ray_steps"] = int(p_res.steps.sum().item())
        pw_stats.append({key: st[key] for key in ("bit_same", "status_agree", "captured_frac",
                                                 "ray_steps")})
        del plain, p_res, k_res
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        anim.render_frames(1, packed=True)
        torch.cuda.synchronize()
    pw_kernels = sorted({e.key for e in prof.key_averages() if "trace_planes_kernel" in e.key})
    if len(pw_kernels) != 1:
        raise AssertionError(f"the 4K plugin frame ran the trace kernels {pw_kernels}")
    phase("custom_4k", f"{n} frames {W5}x{H5}x{r_pw.scene.max_steps} {PLUGIN} euler exact: "
          f"OrbitAnimator {pw_ms:.3f} ms/frame with no host sync (CUDA events, sync debug "
          f"mode 'error'); {N_TRACE}={n}, {N_CUSTOM}={n}, {N_SHADE}={n}, {N_MONO}=0, "
          f"{N_RECORDS}={C[N_RECORDS]} in the process; each frame and its kernel planes "
          f"bit-equal to the plain versions: {json.dumps(pw_stats)}; the profiler's kernel "
          f"{pw_kernels[0]!r} on {smi}")
    del frames, r_pw, anim

    # 20. every exact plane and frame held above, bit-equal to its plain
    # version on 100% of its pixels (the exact tier's bar is the oracle's bits;
    # the phases above hold the looser EXACT_SAME_MIN)
    short = {k: v for k, v in exact_bits.items() if v != 1.0}
    if short or len(exact_bits) < 20:
        raise AssertionError(f"exact outputs not bit-equal on every pixel: {short} "
                             f"({len(exact_bits)} held)")
    phase("exact_bits", f"{len(exact_bits)} exact planes and frames bit-equal to their plain "
          f"versions on 100% of pixels: {json.dumps(sorted(exact_bits))}")

    # 21. the probes (tools/hopper_probe.py): every check and answer line,
    # each probe kernel's launches, time, plain and library time and bound
    C.clear()
    t0 = time.perf_counter()
    run = hp.run_probes("cuda", texture=textured["nearest"].skybox,
                        emit=lambda line: phase("probes", line))
    if run.failed:
        raise AssertionError(f"probe checks failed: {run.failed}")
    for name, rec in sorted(run.kernels.items()):
        r = var.other(name, "probes", REPLACES[name.split("<")[0]])
        r.update(rec, launches=C[f"launch.{name}"])
    phase("probes", f"{len(run.checks)} checks passed, {len(run.answers)} answers, in "
          f"{time.perf_counter() - t0:.1f} s; launches {json.dumps(dict(C))} on {smi}")

    # 22. output
    renderer = records["exact"]["renderer"]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "frame.png")
        renderer.save_image(path)
        back = bt.io.image.read_png(path)
    if not (back == renderer.get_image_data()).all():
        raise AssertionError("PNG read back differs from the frame")
    phase("output", f"saved and read back a {back.shape} PNG")

    kernels = []
    for key, r in sorted(var.rec.items()):
        if r["launches"] == 0:
            raise AssertionError(f"{key} was launched no time on the paths driven")
        if any(r[k] is None for k in ("ms", "plain_ms", "bound_ms", "bound_by")):
            raise AssertionError(f"{key} was not timed at full width: {r}")
        kernels.append({"name": key, "route": "cuda",
                        "source": f"bhr_tpu_torch/csrc/{r['kernel']}.cu",
                        "replaces": r.get("replaces") or REPLACES[(r["kernel"], r["model"])],
                        "launches": r["launches"], "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
                        "config": r["config"]})
        if "bf16_chain_ms" in r:  # the default tier's nearest library call, beside cuBLAS
            kernels[-1]["bf16_chain_ms"] = r["bf16_chain_ms"]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
