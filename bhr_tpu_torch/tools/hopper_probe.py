"""What bhr_tpu's probe scripts asked of the TPU, asked of this card.

    python -m bhr_tpu_torch.tools.hopper_probe [--device cuda|cpu] [--small] [--out FILE]

Six scripts of bhr_tpu ran Pallas kernels to learn what the TPU's kernels
could rely on: scripts/ieee_probe.py (how accurate are an in-kernel divide,
sqrt, rsqrt, approximate reciprocal and their Newton/Markstein
refinements?), scripts/gather_probe2.py, scripts/lut_butterfly_probe.py and
scripts/pallas_gather_bench.py (can a kernel look up a table at a per-pixel
index, and at what cost?), scripts/neural_precision_probe.py and
scripts/neural_kernel_probe.py (which precision does an in-kernel product
have, and which shapes does a kernel take?). The port's kernels depend on
the same questions (the exact tier on correctly rounded __fdiv_rn,
__fsqrt_rn and __frsqrt_rn; the fast tier on rsqrtf and rcp.approx; K3's
blackbody table in __constant__ memory; the neural kernel's bf16 mma.sync
and fp32 tiers), and the kernels of csrc/probes.cu answer them here:

* `ieee` (probe_ieee<OP>): each operation over 4M (4096 x 1024) inputs made
  as ieee_probe.py makes them (log-uniform magnitudes in [1e-6, 1e6],
  random signs, numpy seed 7), against numpy's float64 result rounded to
  float32 and against PyTorch's a / b, torch.sqrt and torch.rsqrt; and the
  exact tier's quotients by a shared denominator (csrc/common.cuh
  div_shared, four numerators a denominator) bit for bit against __fdiv_rn,
  sign of zero included, over those inputs, every mantissa of a
  denominator in [1, 2), the geodesic loop's ranges and an edge set; and
  the exact Kerr-Schild loop's reciprocals and roots behind its group
  guard (rcp_group, root_group) against __fdiv_rn(1, x) and __fsqrt_rn on
  every non-negative float32, and its escape threshold (esc_threshold)
  against the root's test on every float32; and the staged epilogue's
  x^-3/4 (disk_power, csrc/common.cuh disk_temperature_power, the power of
  csrc/shade_planes.cu's disk emission) bit for bit against torch.pow(x,
  -0.75) on every float32 in [1e-6, 4];
* `gather` (probe_gather<SRC>): exact lookups from __constant__, shared and
  device memory and by warp shuffles, on the probes' (8, 128) and (8, W)
  shapes, then 1920 x 1080 lookups, hashed (pallas_gather_bench.py's index)
  and coherent, from tables of 8, 512, 640, 2048 and 2048 x 128 entries and
  from the 2048 x 4096 packed texture of io/skybox.load_skybox(None);
* `dot` (probe_dot<PREC, TANH>): (128, 256) @ (256, 256) at the bf16,
  bf16x3 and fp32 tiers against a float64 product (neural_precision_probe.py),
  and neural_kernel_probe.py's shapes (the bf16 chain with its sums rounded
  to bf16), ending with the Kerr net of neural_kerr.npz through
  csrc/neural_mlp.cu against its plain version;
* `concat` (probe_concat<fp32|bf16>): neural_kernel_probe.py's sublane
  concatenations, an (n_rows, P) feature matrix from (1, P) slices of an
  (8, P) plane, for 16, 22, 24 and 32 rows.

It prints one JSON line per check (`{"probe": ..., "check": ..., "ok": ...}`,
with the numbers), one line per question answered (`{"answer": ...}`), then
one line per kernel variant (`{"kernel": ..., "launches": ...}`, with its
times and bound), and exits non-zero if a check failed. Each wrapper below runs its kernel for
a CUDA tensor (or raises) and its plain version for a CPU tensor; on the CPU
(`--device cpu`) the checks compare plain versions and nothing is timed.
Times are device times by CUDA events with the host's issue hidden
(utils/timing.device_time_ms), and the first line names the card.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import subprocess
import sys

import numpy as np
import torch

from ..utils import build, tracing
from ..utils.timing import device_time_ms

IEEE_OPS = {"div": 0, "fdiv_rn": 1, "fsqrt_rn": 2, "sqrtf": 3, "frsqrt_rn": 4, "rsqrtf": 5,
            "rcp_approx": 6, "markstein": 7, "sqrt_seq": 8, "shared_div": 9, "rcp_group": 10,
            "root_group": 11, "esc_threshold": 12, "disk_power": 13}
BINARY_OPS = ("div", "fdiv_rn", "markstein", "shared_div")
# operands a group of the exact Kerr-Schild loop's group guard probes
# (csrc/common.cuh rcp_guard, root_guard): a takes (n, width)
GROUP_WIDTH = {"rcp_group": 3, "root_group": 2}
# csrc/common.cuh positive_window: the positive floats [2^-32, 2^32), as bits
POSITIVE_WINDOW = (0x2F800000, 0x4F800000)
# csrc/common.cuh div_shared: the window of magnitudes [2^-32, 2^32) in which
# numerators and denominator take the shared reciprocal (bits of 2^-32 and
# 2^32), and the mantissa bits of a denominator that never does
SHARED_DIV_WINDOW = (0x2F800000, 0x4F800000)
MANTISSA = 0x7FFFFF
# Largest error in ulp each operation may have: correctly rounded for the
# _rn intrinsics and nvcc's default divide and sqrtf; rsqrtf 2 ulp (CUDA C++
# Programming Guide, single-precision functions); rcp.approx 1 ulp (PTX ISA,
# rcp.approx.f32).
IEEE_MAX_ULP = {"div": 0, "fdiv_rn": 0, "fsqrt_rn": 0, "sqrtf": 0, "frsqrt_rn": 0, "rsqrtf": 2,
                "rcp_approx": 1}
GATHER_SRCS = {"const": 0, "shared": 1, "ldg": 2, "shfl": 3}
GATHER_PATTERNS = {"hashed": 0, "coherent": 1}
# table entries each memory space holds (csrc/probes.cu): 64 KB of
# __constant__ memory, 227 KB of shared memory, 20 shuffle rounds
GATHER_CAPACITY = {"const": 16384, "shared": 232448 // 4, "ldg": 2**31 - 1, "shfl": 640}
DOT_PRECS = {"bf16": 0, "bf16x3": 1, "fp32": 2}
# Largest error of a product against float64, over max |C| (the error
# measure of neural_precision_probe.py): bf16 operands lose 2^-9 of each
# factor; bf16x3 drops only lo x lo (2^-16); fp32 sums 256 terms.
DOT_MAX_ERR = {"bf16": 1e-2, "bf16x3": 1e-5, "fp32": 1e-5}
# The kernel against its plain version, over max |C|: the tensor cores sum
# in another order than the plain loop (fp32 rounding of 256 terms); the
# fp32 tier sums in the same order with the same fmaf, so bit for bit.
DOT_KERNEL_ERR = {"bf16": 1e-5, "bf16x3": 1e-5, "fp32": 0.0}
# ... but after a tanh epilogue the kernel's tanhf and the plain version's
# torch.tanh may differ by an ulp of a value below 1
TANH_ULP = 2.0 ** -22
# ... and after a tanh rounded to bf16, that ulp may carry the bf16 rounding
# one bf16 ulp the other way (2^-8 of a value below 1) on a few outputs
BF16_TANH_MISMATCH = 1e-3
CONCAT_ROWS = (16, 22, 24, 32)  # neural_kernel_probe.py's concatenations (and 32)

N_IEEE = 1 << 22  # ieee_probe.py:N
LOOKUPS = (1080, 1920)  # pallas_gather_bench.py:tal0_timing's 2,073,600 lookups
LUT_SIZES = (8, 512, 640, 2048)
PEAK_BYTES = 3.35e12  # H100 SXM memory rate
PEAK_FP32 = 67e12  # H100 SXM fp32 outside the tensor cores
PEAK_BF16 = 989e12  # H100 SXM dense bf16 on the tensor cores


# ---- arithmetic helpers ---------------------------------------------------------


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fp32 a * b + c rounded once, as __fmaf_rn: the product is exact in
    float64, the float64 sum is made round-to-odd from its exact error
    (TwoSum), and one rounding to float32 is then correct (53 >= 24 + 2)."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    inexact_even = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, torch.full_like(s, math.inf), torch.full_like(s, -math.inf))
    return torch.where(inexact_even, torch.nextafter(s, toward), s).float()


def rand_fp32(rng, n, lo=1e-6, hi=1e6) -> np.ndarray:
    """Log-uniform magnitudes in [lo, hi] with random signs
    (ieee_probe.py:rand_fp32)."""
    m = rng.uniform(np.log(lo), np.log(hi), n).astype(np.float32)
    s = rng.choice([-1.0, 1.0], n).astype(np.float32)
    return (np.exp(m) * s).astype(np.float32)


def ulp_diff(a, b) -> np.ndarray:
    """|a - b| in float32 ulps, through the ordered integer view
    (ieee_probe.py:ulp_diff)."""
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ai = np.where(ai < 0, np.int64(-0x80000000) - ai, ai)
    bi = np.where(bi < 0, np.int64(-0x80000000) - bi, bi)
    return np.abs(ai - bi)


def _stream_and_device(t: torch.Tensor):
    return t.device.index, torch.cuda.current_stream(t.device).cuda_stream


def _raise(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({lib.bhr_error_string(rc).decode()})")


def _check(t: torch.Tensor, dtype, what: str, device) -> None:
    if t.dtype != dtype or t.device != device or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {dtype} tensor on {device}; got "
                         f"{t.dtype} on {t.device}")


# ---- probe_ieee -----------------------------------------------------------------


def ieee_reference(op: str, a: torch.Tensor, b: torch.Tensor | None = None, *,
                   y0: torch.Tensor | None = None, n_refine: int = 1, fixup: bool = False,
                   fma: bool = False) -> torch.Tensor:
    """probe_ieee's plain version. The divides, roots and estimates are the
    correctly rounded results (float64, rounded once more to float32: exact
    for / and sqrt, since 53 >= 2 * 24 + 2). The Markstein and sqrt
    sequences repeat the kernel's operations from the estimate `y0` (the
    kernel's rcp_approx(b) or rsqrtf(a); without it, the correctly rounded
    one), each correctly rounded: `fma` contracts as __fmaf_rn does, else
    every product and sum rounds on its own. `shared_div` takes a (n, 4)
    and b (n,): where `shared_div_guard` lets a row through, the sequence of
    csrc/common.cuh div_shared from `y0`; elsewhere the correctly rounded
    quotient, as the kernel's __fdiv_rn gives it. `rcp_group` and
    `root_group` (a (n, 3), (n, 2)) and `esc_threshold` likewise
    (rcp_group_reference, root_group_reference,
    escape_threshold_reference). `disk_power` is torch.pow(a, -0.75),
    which the kernel's power must equal on the card."""
    if op in ("div", "fdiv_rn"):
        return (a.double() / b.double()).float()
    if op == "shared_div":
        return shared_div_reference(a, b, y0)
    if op == "rcp_group":
        return rcp_group_reference(a, y0)
    if op == "root_group":
        return root_group_reference(a, y0)
    if op == "esc_threshold":
        return escape_threshold_reference(a)
    if op == "disk_power":
        return torch.pow(a, -0.75)
    if op in ("fsqrt_rn", "sqrtf"):
        return a.double().sqrt().float()
    if op in ("frsqrt_rn", "rsqrtf"):
        return (1.0 / a.double().sqrt()).float()
    if op == "rcp_approx":
        return (1.0 / a.double()).float()
    one = torch.ones_like(a)
    if op == "markstein":
        y = y0 if y0 is not None else (1.0 / b.double()).float()
        for _ in range(n_refine):
            e = fma32(-b, y, one) if fma else 1.0 - b * y
            y = fma32(y, e, y) if fma else y + y * e
        q = a * y
        if fixup:
            r = fma32(-b, q, a) if fma else a - b * q
            q = fma32(r, y, q) if fma else q + r * y
        return q
    if op == "sqrt_seq":
        y = y0 if y0 is not None else (1.0 / a.double().sqrt()).float()
        for _ in range(n_refine):
            t = (0.5 * a) * y
            y = y * (fma32(-t, y, 1.5 * one) if fma else 1.5 - t * y)
        s = a * y
        if fixup:
            r = fma32(-s, s, a) if fma else a - s * s
            h = 0.5 * y
            s = fma32(r, h, s) if fma else s + r * h
        return s
    raise ValueError(f"unknown probe_ieee op {op!r}; have {sorted(IEEE_OPS)}")


def shared_div_guard(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Which rows (a (n, 4) numerators over b (n,)) csrc/common.cuh
    div_shared takes through the shared reciprocal: every numerator and the
    denominator within [2^-32, 2^32) in magnitude, and the denominator's
    mantissa not all ones. The others go to __fdiv_rn."""
    lo, hi = SHARED_DIV_WINDOW

    def inside(x):
        m = x.contiguous().view(torch.int32) & 0x7FFFFFFF
        return (m >= lo) & (m < hi)

    bits = b.contiguous().view(torch.int32)
    return inside(a).all(-1) & inside(b) & ((bits & MANTISSA) != MANTISSA)


def shared_div_reference(a: torch.Tensor, b: torch.Tensor,
                         y0: torch.Tensor | None = None) -> torch.Tensor:
    """div_shared's plain version: a (n, 4) / b (n,). Rows the guard takes:
    y = fma(y0, fma(-b, y0, 1), y0) from the estimate y0 (default RN(1/b)),
    then each quotient q = RN(a y), q = fma(fma(-b, q, a), y, q); the other
    rows the correctly rounded quotient."""
    bc = b[:, None].expand_as(a)
    y = (1.0 / b.double()).float() if y0 is None else y0
    y = fma32(y, fma32(-b, y, torch.ones_like(b)), y)[:, None].expand_as(a)
    q = a * y
    q = fma32(fma32(-bc, q, a), y, q)
    exact = (a.double() / bc.double()).float()
    return torch.where(shared_div_guard(a, b)[:, None], q, exact)


def positive_window(x: torch.Tensor) -> torch.Tensor:
    """csrc/common.cuh positive_window: x within [2^-32, 2^32), positive (a
    negative x, +-0, a subnormal, an infinity or NaN never is)."""
    bits = x.contiguous().view(torch.int32)  # negative floats are negative ints
    return (bits >= POSITIVE_WINDOW[0]) & (bits < POSITIVE_WINDOW[1])


def rcp_group_guard(a: torch.Tensor) -> torch.Tensor:
    """Which groups (rows of a) the exact Kerr-Schild loop takes through
    rcp_rn_shared (csrc/common.cuh rcp_guard): every operand in the positive
    window and none with an all-ones mantissa. The others go to
    __fdiv_rn(1, x)."""
    bits = a.contiguous().view(torch.int32)
    return (positive_window(a) & ((bits & MANTISSA) != MANTISSA)).all(-1)


def root_group_guard(a: torch.Tensor) -> torch.Tensor:
    """Which groups (rows of a) the loop takes through sqrt_rn_seq
    (csrc/common.cuh root_guard): every operand in the positive window. The
    others go to __fsqrt_rn."""
    return positive_window(a).all(-1)


def rcp_group_reference(a: torch.Tensor, y0: torch.Tensor | None = None) -> torch.Tensor:
    """The rcp_group probe's plain version: for the rows rcp_group_guard
    takes, y = fma(y0, fma(-a, y0, 1), y0) from the estimate y0 (default
    RN(1/a)); elsewhere RN(1/a), as __fdiv_rn(1, a) gives it."""
    exact = (1.0 / a.double()).float()
    y = exact if y0 is None else y0
    y = fma32(y, fma32(-a, y, torch.ones_like(a)), y)
    return torch.where(rcp_group_guard(a)[:, None], y, exact)


def root_group_reference(a: torch.Tensor, y0: torch.Tensor | None = None) -> torch.Tensor:
    """The root_group probe's plain version: for the rows root_group_guard
    takes, s = RN(a y0), then fma(fma(-s, s, a), y0 / 2, s) from the rsqrt
    estimate y0 (default RN(1/sqrt(a))); elsewhere RN(sqrt(a)), as
    __fsqrt_rn gives it."""
    exact = a.double().sqrt().float()
    y = (1.0 / a.double().sqrt()).float() if y0 is None else y0
    s = a * y
    seq = fma32(fma32(-s, s, a), y * 0.5, s)
    return torch.where(root_group_guard(a)[:, None], seq, exact)


def escape_threshold_reference(esc: torch.Tensor) -> torch.Tensor:
    """csrc/common.cuh escape_threshold, elementwise: the largest float32 T
    with RN(sqrt(T)) <= esc, stepped to from RN(esc^2) one float at a time
    (roots correctly rounded through float64); esc NaN or +inf gives esc,
    +-0 gives 0, and a negative esc the negative float next to -0."""
    esc = esc.float()
    inf = torch.tensor(math.inf)

    def root(t):
        return t.double().sqrt().float()

    def nudge(t, k):  # k floats up (positive t)
        return (t.view(torch.int32) + k).view(torch.float32)

    ok = (esc > 0) & (esc != inf)
    t = torch.where(ok, esc * esc, torch.ones_like(esc))
    for k, move in ((-1, lambda t: root(t) > esc), (1, lambda t: root(nudge(t, 1)) <= esc)):
        for _ in range(1 << 10):
            step = ok & move(t)
            if not bool(step.any()):
                break
            t = torch.where(step, nudge(t, k), t)
        else:
            raise RuntimeError("escape_threshold_reference did not settle")
    tiny = torch.tensor(-(2.0 ** -149), dtype=torch.float32)
    special = torch.where(esc.isnan() | (esc == inf), esc,
                          torch.where(esc < 0, tiny, torch.zeros_like(esc)))
    return torch.where(ok, t, special)


def ieee(op: str, a: torch.Tensor, b: torch.Tensor | None = None, *, n_refine: int = 1,
         fixup: bool = False, fma: bool = False) -> torch.Tensor:
    """probe_ieee<op> over the elements of `a` (and `b` for the divides):
    one launch of csrc/probes.cu for a CUDA tensor, the plain version for a
    CPU one."""
    if op not in IEEE_OPS:
        raise ValueError(f"unknown probe_ieee op {op!r}; have {sorted(IEEE_OPS)}")
    if (op in BINARY_OPS) != (b is not None):
        raise ValueError(f"probe_ieee<{op}> takes {'a and b' if op in BINARY_OPS else 'a only'}")
    if op == "shared_div" and (a.dim() != 2 or a.shape[1] != 4 or b.shape != a.shape[:1]):
        raise ValueError(f"probe_ieee<shared_div> takes a (n, 4) and b (n,); got a "
                         f"{tuple(a.shape)}, b {tuple(b.shape)}")
    if op in GROUP_WIDTH and (a.dim() != 2 or a.shape[1] != GROUP_WIDTH[op]):
        raise ValueError(f"probe_ieee<{op}> takes a (n, {GROUP_WIDTH[op]}); got "
                         f"{tuple(a.shape)}")
    if a.device.type == "cpu":
        return ieee_reference(op, a, b, n_refine=n_refine, fixup=fixup, fma=fma)
    _check(a, torch.float32, "a", a.device)
    if b is not None:
        _check(b, torch.float32, "b", a.device)
        if op != "shared_div" and b.shape != a.shape:
            raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} differ in shape")
    lib = build.load_probes()
    out = torch.empty_like(a)
    device, stream = _stream_and_device(a)
    # rows of four numerators, or groups
    n = b.numel() if op == "shared_div" else a.shape[0] if op in GROUP_WIDTH else a.numel()
    rc = lib.bhr_probe_ieee(IEEE_OPS[op], a.data_ptr(), b.data_ptr() if b is not None else None,
                            out.data_ptr(), n, int(n_refine), int(fixup), int(fma), device,
                            stream)
    _raise(lib, rc, f"probe_ieee<{op}>")
    tracing.COUNTS[f"launch.probe_ieee<{op}>"] += 1
    return out


# ---- probe_gather ---------------------------------------------------------------


def pattern_indices(shape, table_shape, pattern: str, seed: int = 0, device="cpu") -> torch.Tensor:
    """Flat table indices (int64, `shape`) of a grid of lookups into a
    (th, tw) table, as probe_gather computes them: `hashed` is
    pallas_gather_bench.py:tal0_timing's ((row 1619 + col 31337 + seed) &
    0x7fffffff mod th, col mod tw); `coherent` stretches a 2-D table over
    the grid (row th / H, col tw / W) and ramps a 1-D one along (row + col)."""
    h, w = shape
    th, tw = table_shape
    row = torch.arange(h, dtype=torch.int64, device=device)[:, None]
    col = torch.arange(w, dtype=torch.int64, device=device)[None, :]
    if pattern == "hashed":
        hsh = (row * 1619 + col * 31337 + seed) & 0x7FFFFFFF
        r, c = hsh % th, col % tw
    elif pattern == "coherent":
        if tw == 1:
            r, c = (row + col) * th // (h + w), torch.zeros_like(col)
        else:
            r, c = row * th // h, col * tw // w
    else:
        raise ValueError(f"unknown gather pattern {pattern!r}; have {sorted(GATHER_PATTERNS)}")
    return (r * tw + c).expand(h, w)


def gather_reference(src: str, table: torch.Tensor, idx: torch.Tensor | None = None, *,
                     shape=None, pattern: str = "hashed", seed: int = 0) -> torch.Tensor:
    """probe_gather's plain version: the kernel's index (`idx`, or
    `pattern_indices`), then the entry. For the shuffle the lookup goes as
    the kernel's rounds do: round k brings entry (j mod 32) + 32 k from its
    lane, and the lookup keeps round j / 32."""
    table_shape = tuple(table.shape) if table.dim() == 2 else (table.shape[0], 1)
    flat = table.reshape(-1)
    j = (idx.to(torch.int64) if idx is not None
         else pattern_indices(shape, table_shape, pattern, seed, table.device))
    if src != "shfl":
        return torch.take(flat, j)
    lane, slot = j & 31, j >> 5
    out = torch.zeros(j.shape, dtype=flat.dtype, device=flat.device)
    for k in range((flat.numel() + 31) // 32):
        held = lane + 32 * k
        got = torch.take(flat, held.clamp(max=flat.numel() - 1))
        out = torch.where(slot == k, got, out)
    return out


def upload_const(table: torch.Tensor) -> None:
    """Copy a CUDA int32 table into probe_gather's __constant__ table, on the
    current stream (a copy, not a kernel launch)."""
    if table.device.type != "cuda":
        raise ValueError(f"upload_const takes a CUDA table, not one on {table.device}")
    _check(table, torch.int32, "table", table.device)
    if table.numel() > GATHER_CAPACITY["const"]:
        raise ValueError(f"a table of {table.numel()} entries does not fit __constant__ memory "
                         f"(at most {GATHER_CAPACITY['const']})")
    lib = build.load_probes()
    device, stream = _stream_and_device(table)
    _raise(lib, lib.bhr_probe_const_upload(table.data_ptr(), table.numel(), device, stream),
           "probe_gather<const> upload")


def gather(src: str, table: torch.Tensor, idx: torch.Tensor | None = None, *, shape=None,
           pattern: str = "hashed", seed: int = 0, upload: bool = True) -> torch.Tensor:
    """probe_gather<src>: int32 words of the (th,) or (th, tw) int32 table
    at `idx` (int32 flat indices, checked to lie in the table), or at the
    `pattern` indices of a grid of `shape` lookups. One launch of
    csrc/probes.cu for a CUDA table, the plain version for a CPU one. The
    `const` source first copies `table` into __constant__ memory
    (`upload_const`); with `upload=False` it reads what the last upload left
    there, so that a timed call is the lookups alone."""
    if src not in GATHER_SRCS:
        raise ValueError(f"unknown gather source {src!r}; have {sorted(GATHER_SRCS)}")
    if (idx is None) == (shape is None):
        raise ValueError("give the lookups' indices `idx` or their grid `shape`, not both")
    if table.dim() not in (1, 2):
        raise ValueError(f"the table must be (th,) or (th, tw), not {tuple(table.shape)}")
    if table.numel() > GATHER_CAPACITY[src]:
        raise ValueError(f"a table of {table.numel()} entries does not fit probe_gather<{src}> "
                         f"(at most {GATHER_CAPACITY[src]})")
    if table.device.type == "cpu":
        return gather_reference(src, table, idx, shape=shape, pattern=pattern, seed=seed)
    _check(table, torch.int32, "table", table.device)
    th, tw = tuple(table.shape) if table.dim() == 2 else (table.shape[0], 1)
    if idx is not None:
        _check(idx, torch.int32, "idx", table.device)
        if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= table.numel()):
            raise ValueError(f"indices outside the table of {table.numel()} entries")
        h, w = idx.numel(), 1
        out_shape = idx.shape
    else:
        h, w = shape
        out_shape = (h, w)
        if pattern not in GATHER_PATTERNS:
            raise ValueError(f"unknown gather pattern {pattern!r}; have {sorted(GATHER_PATTERNS)}")
    if src == "const" and upload:
        upload_const(table)
    lib = build.load_probes()
    out = torch.empty(out_shape, dtype=torch.int32, device=table.device)
    device, stream = _stream_and_device(table)
    rc = lib.bhr_probe_gather(GATHER_SRCS[src], table.data_ptr(), th, tw,
                              idx.data_ptr() if idx is not None else None,
                              GATHER_PATTERNS[pattern], seed & 0xFFFFFFFF, h, w, out.data_ptr(),
                              device, stream)
    _raise(lib, rc, f"probe_gather<{src}>")
    tracing.COUNTS[f"launch.probe_gather<{src}>"] += 1
    return out


# ---- probe_dot ------------------------------------------------------------------


def _bf16_split(x: torch.Tensor):
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def dot_reference(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor | None = None, *,
                  prec: str = "bf16", tanh: bool = False,
                  round_bf16: bool = False) -> torch.Tensor:
    """probe_dot's plain version, summed over k in order with no matrix
    product: fp32 as the kernel's fmaf chain (bit for bit); bf16 the
    bf16-rounded operands' products (exact in fp32) added one by one;
    bf16x3 adds lo hi, hi lo and hi hi a k. With `round_bf16` the sum, the
    biased sum and the result each round to bf16."""
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32, device=a.device)
    if prec == "fp32":
        for k in range(a.shape[1]):
            acc = fma32(a[:, k:k + 1], b[k:k + 1, :], acc)
    elif prec in ("bf16", "bf16x3"):
        (ah, al), (bh, bl) = _bf16_split(a), _bf16_split(b)
        for k in range(a.shape[1]):
            if prec == "bf16x3":
                acc = acc + al[:, k:k + 1] * bh[k:k + 1, :]
                acc = acc + ah[:, k:k + 1] * bl[k:k + 1, :]
            acc = acc + ah[:, k:k + 1] * bh[k:k + 1, :]
    else:
        raise ValueError(f"unknown probe_dot precision {prec!r}; have {sorted(DOT_PRECS)}")
    rnd = _bf16 if round_bf16 else (lambda x: x)
    acc = rnd(acc)
    if bias is not None:
        acc = rnd(acc + bias)
    return rnd(torch.tanh(acc)) if tanh else acc


def dot(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor | None = None, *,
        prec: str = "bf16", tanh: bool = False, round_bf16: bool = False) -> torch.Tensor:
    """probe_dot<prec, tanh>: fp32 (M, K) @ (K, N) (+ bias (N,)), then tanh
    where asked; with `round_bf16` every value after the sum is rounded to
    bf16 (a product with preferred_element_type bfloat16). One launch of
    csrc/probes.cu for CUDA tensors, the plain version for CPU ones."""
    if prec not in DOT_PRECS:
        raise ValueError(f"unknown probe_dot precision {prec!r}; have {sorted(DOT_PRECS)}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"cannot multiply {tuple(a.shape)} by {tuple(b.shape)}")
    if bias is not None and tuple(bias.shape) != (b.shape[1],):
        raise ValueError(f"bias must be ({b.shape[1]},), not {tuple(bias.shape)}")
    if a.device.type == "cpu":
        return dot_reference(a, b, bias, prec=prec, tanh=tanh, round_bf16=round_bf16)
    for t, what in ((a, "a"), (b, "b"), (bias, "bias")):
        if t is not None:
            _check(t, torch.float32, what, a.device)
    lib = build.load_probes()
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    device, stream = _stream_and_device(a)
    rc = lib.bhr_probe_dot(DOT_PRECS[prec], int(tanh), int(round_bf16), a.data_ptr(), b.data_ptr(),
                           bias.data_ptr() if bias is not None else None, out.data_ptr(), m, k,
                           n, device, stream)
    _raise(lib, rc, f"probe_dot<{prec}>")
    tracing.COUNTS[f"launch.probe_dot<{prec}>"] += 1
    return out


# ---- probe_concat ---------------------------------------------------------------


def concat_reference(plane: torch.Tensor, n_rows: int, period: int | None = None, *,
                     bf16: bool = False) -> torch.Tensor:
    """probe_concat's plain version: row r is plane[r % 8] ((r % period) +
    1), the product correctly rounded in fp32, then to bf16 where asked."""
    rows = torch.arange(n_rows, device=plane.device)
    scale = (rows % (period or max(n_rows, 1)) + 1).to(torch.float32)
    out = plane[rows % 8] * scale[:, None]
    return out.to(torch.bfloat16) if bf16 else out


def concat(plane: torch.Tensor, n_rows: int, period: int | None = None, *,
           bf16: bool = False) -> torch.Tensor:
    """probe_concat<fp32|bf16>: the (n_rows, P) matrix whose row r is the
    (8, P) fp32 plane's row r % 8 times (r % period) + 1 (period: n_rows
    unless given), fp32 or bf16. One launch of csrc/probes.cu for a CUDA
    plane, the plain version for a CPU one."""
    if plane.dim() != 2 or plane.shape[0] != 8:
        raise ValueError(f"the plane must be (8, P), not {tuple(plane.shape)}")
    if n_rows < 0 or (period is not None and period <= 0):
        raise ValueError(f"n_rows {n_rows} and period {period} must be positive")
    if plane.device.type == "cpu":
        return concat_reference(plane, n_rows, period, bf16=bf16)
    _check(plane, torch.float32, "plane", plane.device)
    lib = build.load_probes()
    out = torch.empty((n_rows, plane.shape[1]), dtype=torch.bfloat16 if bf16 else torch.float32,
                      device=plane.device)
    device, stream = _stream_and_device(plane)
    rc = lib.bhr_probe_concat(int(bf16), plane.data_ptr(), out.data_ptr(), n_rows,
                              plane.shape[1], period or n_rows, device, stream)
    name = f"probe_concat<{'bf16' if bf16 else 'fp32'}>"
    _raise(lib, rc, name)
    tracing.COUNTS[f"launch.{name}"] += 1
    return out


# ---- the probe run ----------------------------------------------------------------


class Run:
    """Collects the check lines, the answers and each kernel variant's
    record for chip_smoke.py's `kernels` line (time, plain time, library
    time, bound, largest error against the plain version)."""

    def __init__(self, device: torch.device, emit):
        self.device = device
        self.timed = device.type == "cuda"
        self.emit = emit
        self.checks = []
        self.answers = []
        self.kernels = {}
        self.failed = []

    def check(self, probe: str, name: str, ok: bool, **numbers) -> None:
        rec = {"probe": probe, "check": name, "ok": bool(ok), **numbers}
        self.checks.append(rec)
        if not ok:
            self.failed.append(name)
        self.emit(json.dumps(rec))

    def answer(self, name: str, **fields) -> None:
        rec = {"answer": name, **fields}
        self.answers.append(rec)
        self.emit(json.dumps(rec))

    def ms(self, fn) -> float | None:
        """Device ms of one fn() (utils/timing.device_time_ms: the host's
        issue hidden behind a spin kernel, since a probe kernel takes a few
        µs and its Python wrapper longer); None on the CPU, where nothing
        is timed."""
        return device_time_ms(fn, device=self.device) if self.timed else None

    def kernel(self, name: str, **fields) -> dict:
        rec = self.kernels.setdefault(name, {"max_abs_err": 0.0})
        for k, v in fields.items():
            rec[k] = max(rec[k], v) if k == "max_abs_err" else v
        return rec


def _bound(bytes_moved: float, ops: float, peak_ops: float):
    t_bytes, t_ops = bytes_moved / PEAK_BYTES * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _ulp_stats(got, want) -> dict:
    ud = ulp_diff(got, want)
    return {"mismatch_frac": float((ud != 0).mean()), "max_ulp": int(ud.max())}


def probe_ieee(run: Run, small: bool) -> None:
    """ieee_probe.py on the card: every operation against the correctly
    rounded result; the sequences against their plain versions bit for bit."""
    n = 1 << 12 if small else N_IEEE
    rng = np.random.default_rng(7)
    a_np, b_np = rand_fp32(rng, n), rand_fp32(rng, n)
    absa_np = np.abs(a_np)
    want = {"div": (a_np.astype(np.float64) / b_np).astype(np.float32),
            "sqrt": np.sqrt(absa_np.astype(np.float64)).astype(np.float32),
            "rsqrt": (1.0 / np.sqrt(absa_np.astype(np.float64))).astype(np.float32),
            "rcp": (1.0 / b_np.astype(np.float64)).astype(np.float32)}
    dev = run.device
    a, b, absa = (torch.from_numpy(x).to(dev) for x in (a_np, b_np, absa_np))
    library = {"div": lambda: a / b, "sqrt": lambda: torch.sqrt(absa),
               "rsqrt": lambda: torch.rsqrt(absa), "rcp": lambda: torch.reciprocal(b)}
    lib_out = {k: f().cpu().numpy() for k, f in library.items()}
    for k in library:
        run.check("ieee", f"torch_{k}_vs_host", True, library=True,
                  **_ulp_stats(lib_out[k], want[k]))
    kinds = {"div": "div", "fdiv_rn": "div", "fsqrt_rn": "sqrt", "sqrtf": "sqrt",
             "frsqrt_rn": "rsqrt", "rsqrtf": "rsqrt", "rcp_approx": "rcp"}
    outs = {}
    for op, kind in kinds.items():
        args = (a, b) if op in BINARY_OPS else ((b,) if kind == "rcp" else (absa,))
        got = ieee(op, *args)
        outs[op] = got
        got_np = got.cpu().numpy()
        st = _ulp_stats(got_np, want[kind])
        run.check("ieee", f"{op}_vs_host", st["max_ulp"] <= IEEE_MAX_ULP[op],
                  bar_max_ulp=IEEE_MAX_ULP[op], **st,
                  vs_torch=_ulp_stats(got_np, lib_out[kind]))
        plain = lambda: ieee_reference(op, *args)  # noqa: E731
        nbytes = 4 * n * (len(args) + 1)
        bound_ms, by = _bound(nbytes, n, PEAK_FP32)
        run.kernel(f"probe_ieee<{op}>", ms=run.ms(lambda: ieee(op, *args)), plain_ms=run.ms(plain),
                   library_ms=run.ms(library[kind]), bound_ms=bound_ms, bound_by=by,
                   config=f"{n} elements, {'a / b' if len(args) == 2 else 'one input'}, "
                          f"ieee_probe.py's inputs (seed 7)")
    # the sequences, each from the kernel's own estimate, both forms
    seq_results = {}
    for op, est, args, n_refines in (("markstein", outs["rcp_approx"], (a, b), (1, 2)),
                                     ("sqrt_seq", outs["rsqrtf"], (absa,), (0, 1, 2))):
        kind = "div" if op == "markstein" else "sqrt"
        for n_refine in n_refines:
            for fixup in (False, True):
                for fma in (False, True):
                    name = f"{op}_r{n_refine}_f{int(fixup)}_{'fma' if fma else 'unc'}"
                    got = ieee(op, *args, n_refine=n_refine, fixup=fixup, fma=fma)
                    plain = ieee_reference(op, *args, y0=est, n_refine=n_refine, fixup=fixup,
                                           fma=fma)
                    got_np = got.cpu().numpy()
                    vs_plain = _ulp_stats(got_np, plain.cpu().numpy())
                    vs_host = _ulp_stats(got_np, want[kind])
                    seq_results[name] = vs_host
                    run.check("ieee", name, vs_plain["max_ulp"] == 0, vs_plain=vs_plain,
                              vs_host=vs_host)
                    run.kernel(f"probe_ieee<{op}>", max_abs_err=float(
                        (got - plain).abs().max().item()))
        n_refine, fixup, fma = (1, True, True)
        timed_args = dict(n_refine=n_refine, fixup=fixup, fma=fma)
        nbytes = 4 * n * (len(args) + 1)
        bound_ms, by = _bound(nbytes, n, PEAK_FP32)
        run.kernel(f"probe_ieee<{op}>",
                   ms=run.ms(lambda: ieee(op, *args, **timed_args)),
                   plain_ms=run.ms(lambda: ieee_reference(op, *args, y0=est, **timed_args)),
                   library_ms=run.ms(library[kind]), bound_ms=bound_ms, bound_by=by,
                   config=f"{n} elements, n_refine 1, fixup, the FMA form")
    for op in kinds:  # the kernel against the plain version it is timed beside
        args = (a, b) if op in BINARY_OPS else ((b,) if kinds[op] == "rcp" else (absa,))
        run.kernel(f"probe_ieee<{op}>", max_abs_err=float(
            (outs[op] - ieee_reference(op, *args)).abs().max().item()))
    rn = {op: next(c for c in run.checks if c["check"] == f"{op}_vs_host")
          for op in ("div", "fdiv_rn", "fsqrt_rn", "sqrtf", "frsqrt_rn")}
    run.answer("ieee_correctly_rounded",
               question="do a / b, __fdiv_rn, __fsqrt_rn, sqrtf and __frsqrt_rn round "
                        "correctly (the exact tier's assumption, csrc/common.cuh)?",
               yes=all(c["max_ulp"] == 0 for c in rn.values()),
               mismatch_frac={op: c["mismatch_frac"] for op, c in rn.items()})
    est = {op: next(c for c in run.checks if c["check"] == f"{op}_vs_host")
           for op in ("rsqrtf", "rcp_approx")}
    run.answer("ieee_estimates",
               question="how far are the fast tier's rsqrtf and rcp.approx.ftz.f32 from the "
                        "correctly rounded result?",
               **{op: {"mismatch_frac": c["mismatch_frac"], "max_ulp": c["max_ulp"]}
                  for op, c in est.items()})
    exact = sorted(k for k, v in seq_results.items() if v["max_ulp"] == 0)
    shared = [k for k in exact if k.startswith("markstein") and k.endswith("_f1_unc")]
    shared_fma = [k for k in exact if k.startswith("markstein") and k.endswith("_f1_fma")]
    run.answer("ieee_sequences",
               question="which refinement, in which form, reaches the correctly rounded "
                        "quotient or root, and could one reciprocal per shared denominator "
                        "(x/r, y/r, z/r, rs/r) give the exact tier's bits?",
               correctly_rounded=exact,
               shared_reciprocal_uncontracted=bool(shared),
               shared_reciprocal_with_fmaf=bool(shared_fma),
               per_sequence={k: v for k, v in sorted(seq_results.items())})
    probe_shared_div(run, small, a_np, b_np)
    probe_group_guard(run, small)
    probe_disk_power(run, small)


def _f32(*xs) -> np.ndarray:
    return np.array(xs, dtype=np.float64).astype(np.float32)


def shared_div_inputs(small: bool, a_p1: np.ndarray, b_p1: np.ndarray) -> dict:
    """The shared_div probe's input sets, each (a (n, 4), b (n,)) float32:
    `p1`, ieee_probe.py's inputs (its b the denominators, its a and three
    more draws the numerators); `mantissas`, every denominator in [1, 2)
    (every 2048th and the all-ones mantissa when small) with 1.0 and three
    draws over it -- a reciprocal one ulp low misrounds 1.0 / b for b of
    the all-ones mantissa; `loop_r` and `loop_v`, the geodesic loop's
    quotients (rel and rs over r = |rel| in [1.05 rs, 100], v over |v| for
    |v| within about 1e-3 of 1; 1% of the components +-0, a ray in a
    coordinate plane); `edge`, each of +-0, subnormals, tiny and huge
    numerators, the window's edges, powers of two, all-ones mantissas,
    infinities and NaN beside three ordinary numerators, over powers of two,
    all-ones mantissas, the window's edges, 0 and infinity."""
    rng = np.random.default_rng(8)
    sets = {}
    n = b_p1.size
    sets["p1"] = (np.stack([a_p1, *rand_fp32(rng, 3 * n).reshape(3, n)], 1), b_p1)
    bits = np.arange(0x3F800000, 0x40000000, dtype=np.uint32)
    if small:
        bits = np.concatenate([bits[::2048], np.array([0x3FFFFFFF], np.uint32)])
    bm = bits.view(np.float32)
    m = bm.size
    sets["mantissas"] = (np.stack([np.ones(m, np.float32),
                                   *rand_fp32(rng, 3 * m).reshape(3, m)], 1), bm)
    k = 1 << 12 if small else 1 << 20

    def unit(k):
        d = rng.standard_normal((k, 3))
        return d / np.linalg.norm(d, axis=1, keepdims=True)

    def planes(x):  # 1% of the components +0 or -0
        hit = rng.random(x.shape) < 0.01
        return np.where(hit, np.where(rng.random(x.shape) < 0.5, -0.0, 0.0), x).astype(np.float32)

    def norm32(x):  # the kernel's |x|: ((x x + y y) + z z), then the root, each in fp32
        return np.sqrt((x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1]) + x[:, 2] * x[:, 2])

    rs = np.exp(rng.uniform(np.log(0.5), np.log(4.0), k)).astype(np.float32)
    r = np.exp(rng.uniform(np.log(1.05 * rs), np.log(100.0)))
    rel = planes(unit(k) * r[:, None])
    sets["loop_r"] = (np.concatenate([rel, rs[:, None]], 1), norm32(rel))
    v = planes(unit(k) * (1.0 + 1e-3 * rng.standard_normal((k, 1))))
    sets["loop_v"] = (np.concatenate([v, -v[:, :1]], 1), norm32(v))
    two = np.float32(2.0)
    pows = np.arange(-40, 41, 4)
    ones = np.float32(2.0 - 2.0 ** -23) * two ** pows  # all-ones mantissas
    edge_num = _f32(0.0, 2.0 ** -149, 2.0 ** -126 - 2.0 ** -149, 2.0 ** -126, 2.0 ** -100,
                    2.0 ** -64, 2.0 ** -33, 2.0 ** -32 * (1 - 2.0 ** -24), 2.0 ** -32,
                    2.0 ** 32 * (1 - 2.0 ** -24), 2.0 ** 32, 2.0 ** 40, 2.0 ** 100,
                    np.finfo(np.float32).max, np.inf, np.nan)
    edge_num = np.concatenate([edge_num, -edge_num, two ** pows, -(two ** pows), ones, -ones,
                               rand_fp32(rng, 8)]).astype(np.float32)
    edge_den = _f32(1.0 + 2.0 ** -23, 2.0 - 2.0 ** -22, 2.1, 100.0, 2.0 ** -32,
                    2.0 ** -32 * (1 - 2.0 ** -24), 2.0 ** 32 * (1 - 2.0 ** -24), 2.0 ** 32,
                    2.0 ** -100, 0.0, np.inf)
    edge_den = np.concatenate([edge_den, -edge_den[:4], two ** pows, ones]).astype(np.float32)
    benign = _f32(1.0, 0.7, 3.0)
    rows, dens = [], []
    for j, e in enumerate(edge_num):
        row = list(benign)
        row.insert(j % 4, e)
        rows.append(row)
    pad = (-edge_num.size) % 4  # and the edge numerators four to a row
    rows += np.concatenate([edge_num, np.ones(pad, np.float32)]).reshape(-1, 4).tolist()
    rows = np.array(rows, np.float32)
    sets["edge"] = (np.tile(rows, (edge_den.size, 1)), np.repeat(edge_den, rows.shape[0]))
    return sets


def probe_shared_div(run: Run, small: bool, a_p1: np.ndarray, b_p1: np.ndarray) -> None:
    """csrc/common.cuh div_shared on the card: four numerators over one
    denominator, bit for bit against the kernel's __fdiv_rn (probe_ieee<
    fdiv_rn> on the same pairs), the correctly rounded quotient and the
    plain version from the card's own rcp.approx, sign of zero included."""
    dev = run.device
    results, total = {}, 0

    def same(x, y):  # the same bits, or both NaN
        return (x.view(torch.int32) == y.view(torch.int32)) | (x.isnan() & y.isnan())

    for name, (a_np, b_np) in shared_div_inputs(small, a_p1, b_p1).items():
        a, b = torch.from_numpy(a_np).to(dev), torch.from_numpy(b_np).to(dev)
        got = ieee("shared_div", a, b)
        fdiv = ieee("fdiv_rn", a.reshape(-1), b.repeat_interleave(4)).reshape(a.shape)
        host = (a.double() / b.double()[:, None]).float()
        y0 = ieee("rcp_approx", b)
        plain = ieee_reference("shared_div", a, b, y0=y0)
        guard = shared_div_guard(a, b)
        neg_zero = (host == 0) & (host.view(torch.int32) < 0)
        rec = {"quotients": a.numel(),
               "vs_fdiv_rn_mismatches": int((got.view(torch.int32) != fdiv.view(torch.int32))
                                            .sum().item()),
               "vs_host_mismatches": int((~same(got, host)).sum().item()),
               "vs_plain_mismatches": int((~same(got, plain)).sum().item()),
               "fdiv_rn_rows": float(1.0 - guard.float().mean().item()),
               "negative_zeros": int(neg_zero.sum().item()),
               "negative_zeros_kept": int((neg_zero & same(got, host)).sum().item())}
        total += rec["quotients"]
        results[name] = rec
        ok = rec["vs_fdiv_rn_mismatches"] + rec["vs_host_mismatches"] \
            + rec["vs_plain_mismatches"] == 0
        run.check("ieee", f"shared_div_{name}", ok, **rec)
        finite = got.isfinite() & plain.isfinite()
        run.kernel("probe_ieee<shared_div>", max_abs_err=float(
            (got - plain)[finite].abs().max().item()) if bool(finite.any()) else 0.0)
        if name == "p1":
            n = b.numel()
            bound_ms, by = _bound(4 * 9 * n, 4 * n, PEAK_FP32)
            run.kernel("probe_ieee<shared_div>",
                       ms=run.ms(lambda: ieee("shared_div", a, b)),
                       plain_ms=run.ms(lambda: ieee_reference("shared_div", a, b, y0=y0)),
                       library_ms=run.ms(lambda: a / b[:, None]), bound_ms=bound_ms,
                       bound_by=by, config=f"{n} denominators x 4 numerators, ieee_probe.py's "
                                           f"inputs (seed 7) and three more draws (seed 8)")
        del a, b, got, fdiv, host, plain
    run.answer("shared_quotient",
               question="do the exact tier's quotients by a shared denominator "
                        "(csrc/common.cuh div_shared: one reciprocal, then a mul and two "
                        "__fmaf_rn a quotient; __fdiv_rn for what its guard turns away) give "
                        "__fdiv_rn's bits, sign of zero included?",
               yes=all(r["vs_fdiv_rn_mismatches"] == 0 and r["vs_host_mismatches"] == 0
                       for r in results.values()),
               quotients=total, per_set=results)


def _same_bits(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The same bits, or both NaN."""
    return (x.view(torch.int32) == y.view(torch.int32)) | (x.isnan() & y.isnan())


def _float_chunks(lo: int, hi: int, small: bool, device):
    """The float32 bit patterns lo..hi-1 as floats, in chunks of 2^26 (every
    65537th pattern when small)."""
    step, chunk = (65537, 1 << 14) if small else (1, 1 << 26)
    for start in range(lo, hi, step * chunk):
        stop = min(start + step * chunk, hi)
        bits = torch.arange(start, stop, step, dtype=torch.int64, device=device)
        yield torch.where(bits >= 1 << 31, bits - (1 << 32), bits).to(torch.int32).view(
            torch.float32)


# the escape radii the threshold is held at: the port's (core/scene.py), a
# seeded log-uniform draw, and the edges
ESC_EDGES = (100.0, 0.0, -0.0, -1.0, math.inf, -math.inf, math.nan, 1e-40, 1e-20, 1.0, 2.0,
             1e19, 3e38, float(np.finfo(np.float32).max))


def probe_group_guard(run: Run, small: bool) -> None:
    """The exact Kerr-Schild loop's roots and reciprocals behind its group
    guard (csrc/common.cuh rcp_rn_shared, sqrt_rn_seq, rcp_guard,
    root_guard) over every non-negative float32 -- each operand beside two
    (reciprocals) or one (roots) others of its chunk, so that groups mix --
    bit for bit against the kernel's __fdiv_rn(1, x) and __fsqrt_rn and
    against the correctly rounded result; then escape_threshold against its
    plain version, and its test rho2 > T against __fsqrt_rn(rho2) > esc
    over every float32 for each escape radius of ESC_EDGES and 16 seeded
    ones."""
    dev = run.device
    for op, width in GROUP_WIDTH.items():
        counts = collections.Counter()
        for x in _float_chunks(0, 1 << 31, small, dev):
            a = torch.stack([x, x.flip(0), x.roll(1)][:width], 1).contiguous()
            got = ieee(op, a)
            if op == "rcp_group":
                intr = ieee("fdiv_rn", torch.ones_like(a).reshape(-1), a.reshape(-1))
                host = (1.0 / a.double()).float()
            else:
                intr = ieee("fsqrt_rn", a.reshape(-1))
                host = a.double().sqrt().float()
            intr = intr.reshape(a.shape)
            guard = rcp_group_guard(a) if op == "rcp_group" else root_group_guard(a)
            counts["operands"] += a.numel()
            counts["vs_intrinsic_mismatches"] += int((~_same_bits(got, intr)).sum().item())
            counts["vs_host_mismatches"] += int((~_same_bits(got, host)).sum().item())
            counts["through_sequence"] += int(guard.sum().item()) * width
            if op == "rcp_group":
                y0 = ieee("rcp_approx", a.reshape(-1)).reshape(a.shape)
            else:
                y0 = ieee("rsqrtf", a.reshape(-1)).reshape(a.shape)
            plain = ieee_reference(op, a, y0=y0)
            counts["vs_plain_mismatches"] += int((~_same_bits(got, plain)).sum().item())
            finite = got.isfinite() & plain.isfinite()
            if bool(finite.any()):
                run.kernel(f"probe_ieee<{op}>", max_abs_err=float(
                    (got - plain)[finite].abs().max().item()))
            del a, got, intr, host, y0, plain
        rec = dict(counts)
        ok = rec["vs_intrinsic_mismatches"] + rec["vs_host_mismatches"] == 0
        run.check("ieee", f"{op}_every_nonnegative_float", ok, small=small, **rec)
    # the escape threshold
    rng = np.random.default_rng(9)
    esc_np = np.concatenate([_f32(*ESC_EDGES),
                             np.exp(rng.uniform(np.log(1e-4), np.log(1e8), 16)).astype(np.float32)])
    esc = torch.from_numpy(esc_np).to(dev)
    t = ieee("esc_threshold", esc)
    plain = escape_threshold_reference(esc)
    floats, mismatches = 0, torch.zeros((), dtype=torch.int64, device=dev)
    for x in _float_chunks(0, 1 << 32, small, dev):
        root = ieee("fsqrt_rn", x)
        floats += x.numel()
        for j in range(esc.numel()):
            mismatches += ((x > t[j]) != (root > esc[j])).sum()
    rec = {"radii": esc_np.size, "floats": floats, "mismatches": int(mismatches.item()),
           "vs_plain_mismatches": int((~_same_bits(t, plain)).sum().item()),
           "threshold_at_100": float(t[0].item())}
    run.check("ieee", "escape_threshold_every_float", rec["mismatches"] == 0
              and rec["vs_plain_mismatches"] == 0, small=small, **rec)
    run.kernel("probe_ieee<esc_threshold>", max_abs_err=float(
        (t - plain)[t.isfinite()].abs().max().item()))
    # the timings, at ieee_probe.py's size (4,194,304 groups or radii)
    n = 1 << 12 if small else N_IEEE
    g = torch.Generator(device="cpu").manual_seed(10)
    ops = {"rcp_group": (torch.rand(n, 3, generator=g) * 99 + 1,
                         lambda a: torch.reciprocal(a), 24, 3),
           "root_group": (torch.rand(n, 2, generator=g) * 1e4 + 1e-3,
                          lambda a: torch.sqrt(a), 16, 2),
           "esc_threshold": (torch.rand(n, generator=g) * 199 + 1, None, 8, 3)}
    for op, (a, library, nbytes, n_ops) in ops.items():
        a = a.to(dev)
        bound_ms, by = _bound(nbytes * n, n_ops * n, PEAK_FP32)
        run.kernel(f"probe_ieee<{op}>", ms=run.ms(lambda: ieee(op, a)),
                   plain_ms=run.ms(lambda: ieee_reference(op, a)),
                   library_ms=run.ms(lambda: library(a)) if library else None,
                   bound_ms=bound_ms, bound_by=by,
                   config=f"{n} {'radii' if op == 'esc_threshold' else 'groups'} "
                          f"(torch seed 10)")
    done = [c for c in run.checks if c["check"].endswith(("_every_nonnegative_float",
                                                          "_every_float"))]
    run.answer("ks_group_guard",
               question="do the exact Kerr-Schild loop's reciprocals and roots by their common "
                        "paths behind one group guard (csrc/common.cuh) give __fdiv_rn(1, x)'s "
                        "and __fsqrt_rn's bits on every non-negative float32, and does "
                        "|q|^2 > escape_threshold(esc) decide escape as __fsqrt_rn(|q|^2) > esc "
                        "does on every float32?",
               yes=all(c["ok"] for c in done), small=small,
               per_check={c["check"]: {k: v for k, v in c.items()
                                       if k not in ("probe", "check", "small")} for c in done})


# the staged epilogue's r / r_isco, clamped below at 1e-6, lies in [1, 10 / 3]:
# its power is held on every float32 in [1e-6, 4]
DISK_POWER_RANGE = (1e-6, 4.0)


def disk_power_bits() -> tuple:
    """The float32 bit patterns of DISK_POWER_RANGE's ends, both included:
    (lo, hi + 1)."""
    lo, hi = (int(np.array(x, dtype=np.float32).view(np.int32)) for x in DISK_POWER_RANGE)
    return lo, hi + 1


def probe_disk_power(run: Run, small: bool) -> None:
    """The staged epilogue's x^-3/4 (csrc/common.cuh disk_temperature_power)
    bit for bit against torch.pow(x, -0.75) on the same device, on every
    float32 in DISK_POWER_RANGE; then its time over 4M ratios in [1, 4)."""
    dev = run.device
    floats, mismatches = 0, 0
    for x in _float_chunks(*disk_power_bits(), small, dev):
        got, want = ieee("disk_power", x), ieee_reference("disk_power", x)
        floats += x.numel()
        mismatches += int((~_same_bits(got, want)).sum().item())
        run.kernel("probe_ieee<disk_power>", max_abs_err=float((got - want).abs().max().item()))
    run.check("ieee", "disk_power_every_float_in_range", mismatches == 0, small=small,
              floats=floats, mismatches=mismatches, range=list(DISK_POWER_RANGE))
    n = 1 << 12 if small else N_IEEE
    g = torch.Generator(device="cpu").manual_seed(11)
    a = (torch.rand(n, generator=g) * 3 + 1).to(dev)
    bound_ms, by = _bound(8 * n, 0, PEAK_FP32)
    run.kernel("probe_ieee<disk_power>", ms=run.ms(lambda: ieee("disk_power", a)),
               plain_ms=run.ms(lambda: ieee_reference("disk_power", a)), bound_ms=bound_ms,
               bound_by=by,
               config=f"{n} ratios in [1, 4) (torch seed 11)")


def probe_gather(run: Run, small: bool, texture: torch.Tensor | None) -> None:
    """gather_probe2.py, lut_butterfly_probe.py and pallas_gather_bench.py
    on the card: exact lookups on the probes' shapes, then ns a lookup at
    1920 x 1080 for each memory space, table and index pattern."""
    dev = run.device
    rng = np.random.default_rng(1)

    def fits(src, n):
        return n <= GATHER_CAPACITY[src]

    # exactness on the probes' shapes: (8, 128) lookups (tal0, take1d), (8, W)
    # for the 512- and 640-wide rows (butterfly_512, butterfly_640, tal1)
    cases = [(n, (8, n if n in (512, 640) else 128)) for n in LUT_SIZES] + [((2048, 128), (8, 128))]
    for tshape, ishape in cases:
        tbl_np = rng.integers(-2**31, 2**31, tshape if isinstance(tshape, tuple) else (tshape,),
                              dtype=np.int64).astype(np.int32)
        idx_np = rng.integers(0, tbl_np.size, ishape, dtype=np.int64).astype(np.int32)
        want = tbl_np.reshape(-1)[idx_np]
        tbl, idx = torch.from_numpy(tbl_np).to(dev), torch.from_numpy(idx_np).to(dev)
        for src in GATHER_SRCS:
            if not fits(src, tbl_np.size):
                continue
            got = gather(src, tbl, idx).cpu().numpy()
            run.check("gather", f"{src}_{'x'.join(map(str, tbl_np.shape))}_idx{ishape[0]}x"
                      f"{ishape[1]}", bool(np.array_equal(got, want)),
                      agreement=float((got == want).mean()))
    # cost a lookup at 1920 x 1080: every table in every space that holds it
    shape = (8, 128) if small else LOOKUPS
    n_look = shape[0] * shape[1]
    tables = {str(n): rng.integers(-2**31, 2**31, (n,), dtype=np.int64).astype(np.int32)
              for n in LUT_SIZES}
    tables["2048x128"] = rng.integers(-2**31, 2**31, (2048, 128), dtype=np.int64).astype(np.int32)
    tables = {k: torch.from_numpy(v).to(dev) for k, v in tables.items()}
    if texture is not None:
        tables["texture2048x4096"] = texture
    ns, times, upload_ms = {}, {}, {}
    for tname, tbl in tables.items():
        for pattern in GATHER_PATTERNS:
            j = pattern_indices(shape, tuple(tbl.shape) if tbl.dim() == 2 else (tbl.shape[0], 1),
                                pattern, 0, dev)
            flat = tbl.reshape(-1)
            touched = int(torch.unique(j).numel())
            bound_ms, by = _bound(4 * n_look + 4 * touched, 0, PEAK_FP32)
            library_ms = run.ms(lambda: flat[j])
            for src in GATHER_SRCS:
                if not fits(src, tbl.numel()):
                    continue
                got = gather(src, tbl, shape=shape, pattern=pattern)
                plain = gather_reference(src, tbl, shape=shape, pattern=pattern)
                same = float((got == plain).float().mean().item())
                run.check("gather", f"{src}_{tname}_{pattern}_{shape[0]}x{shape[1]}", same == 1.0,
                          agreement=same)
                if not run.timed:
                    continue
                key = f"{src}/{tname}/{pattern}"
                # `got` uploaded this table to __constant__: the timed calls
                # are the lookups alone
                times[key] = rec = dict(
                    ms=run.ms(lambda: gather(src, tbl, shape=shape, pattern=pattern,
                                             upload=False)),
                    plain_ms=run.ms(lambda: gather_reference(src, tbl, shape=shape,
                                                             pattern=pattern)),
                    library_ms=library_ms, bound_ms=bound_ms, entries_read=touched)
                ns[key] = rec["ms"] * 1e6 / n_look
                if src == "const" and pattern == "hashed":
                    upload_ms[tname] = run.ms(lambda: upload_const(tbl))
                if tname == "512" and pattern == "hashed":  # the variant of the kernels line
                    run.kernel(f"probe_gather<{src}>", **{k: rec[k] for k in (
                                   "ms", "plain_ms", "library_ms", "bound_ms")},
                               bound_by=by,
                               max_abs_err=float((got.long() - plain.long()).abs().max()),
                               config=f"{n_look} hashed lookups (pallas_gather_bench.py's "
                                      f"index) into a 512-entry table")
    if run.timed:
        def ratio(x, y):
            return ns[x] / ns[y] if x in ns and y in ns else None

        run.answer("gather_ns_per_lookup",
                   question="what does an in-kernel table lookup cost per index, in each memory "
                            "space, for each table and index pattern?",
                   lookups=n_look, ns=ns, ms=times)
        run.answer("gather_constant_hashed",
                   question="how much slower is __constant__ memory under hashed indices (a "
                            "warp's lanes on different addresses) than coherent ones, and than "
                            "shared memory? K3's blackbody LUT (csrc/render_mono.cu kDiskLut, "
                            "3 x 128 floats) is read from __constant__ at a per-pixel index",
                   const_hashed_over_coherent_512=ratio("const/512/hashed", "const/512/coherent"),
                   const_over_shared_hashed_512=ratio("const/512/hashed", "shared/512/hashed"),
                   const_over_shared_coherent_512=ratio("const/512/coherent",
                                                        "shared/512/coherent"),
                   note="the lookups alone: each table is copied into __constant__ memory "
                        "once before its timed calls (upload_const, timed apart as "
                        "const_upload_ms)",
                   const_upload_ms=upload_ms)


def probe_dot(run: Run, small: bool) -> None:
    """neural_precision_probe.py and neural_kernel_probe.py on the card."""
    dev = run.device
    rng = np.random.default_rng(0)  # neural_precision_probe.py's inputs
    m = 16 if small else 128
    a_np = (rng.standard_normal((m, 256)) * (1 + 1e-4)).astype(np.float32)
    b_np = rng.standard_normal((256, 256)).astype(np.float32)
    ref = a_np.astype(np.float64) @ b_np.astype(np.float64)
    scale = float(np.abs(ref).max())
    a, b = torch.from_numpy(a_np).to(dev), torch.from_numpy(b_np).to(dev)
    errs = {}
    for prec in DOT_PRECS:
        got = dot(a, b, prec=prec)
        plain = dot_reference(a, b, prec=prec)
        err = float(np.abs(got.cpu().numpy() - ref).max() / scale)
        k_err = float((got - plain).abs().max().item()) / scale
        errs[prec] = err
        run.check("dot", f"precision_{prec}_{m}x256x256",
                  err <= DOT_MAX_ERR[prec] and k_err <= DOT_KERNEL_ERR[prec], max_rel_err=err,
                  bar=DOT_MAX_ERR[prec], kernel_vs_plain=k_err, kernel_bar=DOT_KERNEL_ERR[prec])
        flops = 2.0 * m * 256 * 256 * (3 if prec == "bf16x3" else 1)
        bound_ms, by = _bound(4 * (m * 256 + 256 * 256 + m * 256), flops,
                              PEAK_FP32 if prec == "fp32" else PEAK_BF16)
        if prec == "bf16":
            a16, b16 = a.bfloat16(), b.bfloat16()
            library = lambda: a16 @ b16  # noqa: E731
        else:
            library = lambda: a @ b  # noqa: E731
        run.kernel(f"probe_dot<{prec}>", ms=run.ms(lambda: dot(a, b, prec=prec)),
                   plain_ms=run.ms(lambda: dot_reference(a, b, prec=prec)),
                   library_ms=run.ms(library), bound_ms=bound_ms, bound_by=by,
                   max_abs_err=float((got - plain).abs().max().item()),
                   config=f"({m}, 256) @ (256, 256), neural_precision_probe.py's inputs")
    lib_fp32 = float(np.abs((a @ b).cpu().numpy() - ref).max() / scale)
    lib_bf16 = float(np.abs((a.bfloat16() @ b.bfloat16()).float().cpu().numpy() - ref).max()
                     / scale)
    run.answer("dot_precision",
               question="which precision does an in-kernel product have? (max error over "
                        "max |C| against float64; high_honored as neural_precision_probe.py "
                        "defines it: bf16x3 beats bf16 by 50x)",
               max_rel_err=errs, high_honored=errs["bf16x3"] < errs["bf16"] / 50.0,
               torch_matmul_fp32_no_tf32=lib_fp32, torch_matmul_bf16=lib_bf16)

    # neural_kernel_probe.py's shapes, pixels as M
    p = 64 if small else 512
    rng = np.random.default_rng(5)

    def mat(*shape, s=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * s).astype(np.float32)).to(dev)

    shapes, shape_ms = [], {}

    def held(name, prec, got, plain, tanh=False, operands=None):
        scale = max(float(plain.abs().max().item()), 1e-30)
        e = float((got - plain).abs().max().item()) / scale
        bar = max(DOT_KERNEL_ERR[prec], TANH_ULP) if tanh else DOT_KERNEL_ERR[prec]
        ok = e <= bar and bool(torch.isfinite(got).all())
        run.check("dot", name, ok, kernel_vs_plain=e, kernel_bar=bar, shape=list(got.shape))
        run.kernel(f"probe_dot<{prec}>", max_abs_err=float((got - plain).abs().max().item()))
        shapes.append(name)
        if operands is not None and run.timed:  # time the layer: kernel, plain, torch.matmul
            x, w, bias = operands
            m_, k_ = x.shape
            flops = 2.0 * m_ * k_ * w.shape[1]
            bound_ms, by = _bound(4 * (x.numel() + w.numel() + m_ * w.shape[1]), flops,
                                  PEAK_FP32 if prec == "fp32" else PEAK_BF16)
            xl, wl = (x.bfloat16(), w.bfloat16()) if prec == "bf16" else (x, w)

            def library():
                y = xl @ wl
                y = y + bias if bias is not None else y
                return torch.tanh(y) if tanh else y

            shape_ms[name] = dict(
                ms=run.ms(lambda: dot(x, w, bias, prec=prec, tanh=tanh)),
                plain_ms=run.ms(lambda: dot_reference(x, w, bias, prec=prec, tanh=tanh)),
                library_ms=run.ms(library), bound_ms=bound_ms, bound_by=by)

    feats, w1, w2, head = mat(p, 16), mat(16, 128, s=0.25), mat(128, 128, s=0.1), mat(128, 8)
    b1, b2 = mat(128, s=0.1), mat(128, s=0.1)
    for prec in ("bf16", "fp32"):
        held(f"k16_dot_{prec}", prec, dot(feats, w1, prec=prec),
             dot_reference(feats, w1, prec=prec), operands=(feats, w1, None))
        h1 = dot(feats, w1, b1, prec=prec, tanh=True)
        h2 = dot(h1, w2, b2, prec=prec, tanh=True)
        p1 = dot_reference(feats, w1, b1, prec=prec, tanh=True)
        held(f"hidden_chain_{prec}", prec, h2, dot_reference(h1, w2, b2, prec=prec, tanh=True),
             tanh=True, operands=(h1, w2, b2))
        held(f"hidden_chain_layer1_{prec}", prec, h1, p1, tanh=True)
        held(f"head_{prec}", prec, dot(h2, head, prec=prec), dot_reference(h2, head, prec=prec),
             operands=(h2, head, None))
    # probe_bf16_chain: the first sum and its tanh rounded to bf16
    # (preferred_element_type bfloat16), the second product summed in fp32
    hb = dot(feats, w1, prec="bf16", tanh=True, round_bf16=True)
    hb_plain = dot_reference(feats, w1, prec="bf16", tanh=True, round_bf16=True)
    diff = (hb - hb_plain).abs()
    mismatch = float((diff != 0).float().mean().item())
    ok = mismatch <= BF16_TANH_MISMATCH and float(diff.max().item()) <= 2.0 ** -8
    run.check("dot", "bf16_chain_layer1_bf16", ok, mismatch_frac=mismatch,
              max_abs_diff=float(diff.max().item()), bar_mismatch=BF16_TANH_MISMATCH,
              bar_max=2.0 ** -8)
    run.kernel("probe_dot<bf16>", max_abs_err=float(diff.max().item()))
    held("bf16_chain_bf16", "bf16", dot(hb, w2, prec="bf16"), dot_reference(hb, w2, prec="bf16"))
    kerr = {}
    for k in (22, 24, 32):
        f = mat(p, k)
        w = mat(k, 256, s=0.2)
        got = dot(f, w, prec="bf16")
        held(f"kerr_dot_k{k}_bf16", "bf16", got, dot_reference(f, w, prec="bf16"),
             operands=(f, w, None))
        if k == 22:
            kerr["f"], kerr["w"], kerr["got"] = f, w, got
    f32 = torch.zeros(p, 32, device=dev)
    f32[:, :22] = kerr["f"]
    w32 = torch.zeros(32, 256, device=dev)
    w32[:22] = kerr["w"]
    padded = dot(f32, w32, prec="bf16")
    run.check("dot", "kerr_dot_k22_equals_zero_padded_k32", bool(torch.equal(padded, kerr["got"])))
    # the sublane concatenations: 16 rows (8 scaled rows twice, fp32) and
    # the Kerr feature matrix (rows scaled by r + 1, bf16), and each in the
    # other type
    plane = mat(8, p, s=3.0)
    concats = {}
    for n_rows in CONCAT_ROWS:
        period = 8 if n_rows == 16 else None
        for bf16 in (False, True):
            name = f"concat_{n_rows}x{p}_{'bf16' if bf16 else 'fp32'}"
            got = concat(plane, n_rows, period, bf16=bf16)
            plain = concat_reference(plane, n_rows, period, bf16=bf16)
            run.check("concat", name, bool(torch.equal(got, plain)), shape=list(got.shape),
                      dtype=str(got.dtype).split(".")[-1])
            kname = f"probe_concat<{'bf16' if bf16 else 'fp32'}>"
            run.kernel(kname, max_abs_err=float((got.float() - plain.float()).abs().max().item()))
            concats[name] = got.dtype
            # the variants of the kernels line: neural_kernel_probe.py's own
            # types, the 16-row fp32 concatenation and the 22-row bf16 one
            if (n_rows, bf16) in ((16, False), (22, True)):
                nbytes = 4 * min(n_rows, 8) * p + got.element_size() * n_rows * p
                bound_ms, by = _bound(nbytes, n_rows * p, PEAK_FP32)
                run.kernel(kname, ms=run.ms(lambda: concat(plane, n_rows, period, bf16=bf16)),
                           plain_ms=run.ms(lambda: concat_reference(plane, n_rows, period,
                                                                    bf16=bf16)),
                           library_ms=None, bound_ms=bound_ms, bound_by=by,
                           config=f"({n_rows}, {p}) from an (8, {p}) plane, "
                                  f"{'bf16' if bf16 else 'fp32'} (neural_kernel_probe.py)")
    run.answer("dot_shapes",
               question="which shapes does the kernel take (neural_kernel_probe.py)?",
               ran=shapes, ms=shape_ms, concatenations=sorted(concats),
               note="K = 16, 22 (zeros to the next 16 in the fragment loads, bit-equal to "
                    "explicit padding), 24 and 32; the (P, 128) tanh chain, its bf16 form and "
                    "the 8-wide head; the (n_rows, P) feature matrix from (1, P) slices for "
                    "16, 22, 24 and 32 rows, fp32 and bf16.")


def probe_kerr_end_to_end(run: Run, small: bool) -> None:
    """neural_kernel_probe.py:probe_kerr_end_to_end: the committed Kerr net
    through csrc/neural_mlp.cu (frame and direction planes, both kernel
    tiers) against its plain version, at 128 x 96."""
    import bhr_tpu_torch as bt
    from ..ops import neural_kernel as nk

    w, h = (32, 24) if small else (128, 96)
    scene = bt.SceneParams(screen_width=w, screen_height=h, max_steps=500, spin=0.9)
    cam = bt.Camera.default()
    for tier in ("default", "highest"):
        r = bt.BlackHoleRenderer(w, h, "neural", model="kerr", neural_precision=tier,
                                 device=run.device)
        frame = nk.neural_render_packed(r.neural_params, cam, scene, precision=tier,
                                        device=run.device)
        plain = nk.neural_render_packed_reference(r.neural_params, cam, scene, precision=tier,
                                                  device=run.device)
        same = float((frame == plain).float().mean().item())
        dirs = nk.neural_trace_dirs(r.neural_params, cam, scene, precision=tier,
                                    device=run.device)
        pdirs = nk.neural_trace_dirs_reference(r.neural_params, cam, scene, precision=tier,
                                               device=run.device)
        status = float((dirs.status == pdirs.status).float().mean().item())
        bar = 0.99 if tier == "default" else 0.999  # chip_smoke.py's neural bars
        run.check("dot", f"kerr_end_to_end_{tier}_{w}x{h}", same >= bar and status >= 0.999,
                  frame_bit_equal=same, bar=bar, dirs_status_equal=status)


def run_probes(device="cuda", *, small: bool = False, texture: torch.Tensor | None = None,
               emit=print) -> Run:
    """Every probe on `device`; returns the Run (its checks, answers and
    kernel records). `texture` is the packed int32 texture for the gather's
    texture lookups (default: io/skybox.load_skybox(None) packed, unless
    `small`)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    run = Run(device, emit)
    if texture is None and not small:
        from ..io.skybox import load_skybox
        from ..ops.sampling import pack_texture_rgba8

        texture = pack_texture_rgba8(load_skybox(None), device=device)
    probe_ieee(run, small)
    probe_gather(run, small, texture)
    probe_dot(run, small)
    probe_kerr_end_to_end(run, small)
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--small", action="store_true", help="tiny sizes (a check of the script)")
    ap.add_argument("--out", help="also write every line to this file")
    args = ap.parse_args(argv)
    lines = []

    def emit(line):
        print(line, flush=True)
        lines.append(line)

    if torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            print("hopper_probe: no CUDA device (use --device cpu for the plain versions)",
                  file=sys.stderr)
            return 2
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip()
        emit(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                         "torch": torch.__version__, "cuda": torch.version.cuda}))
    run = run_probes(args.device, small=args.small, emit=emit)
    for name, rec in sorted(run.kernels.items()):
        emit(json.dumps({"kernel": name, "launches": tracing.COUNTS[f"launch.{name}"], **rec}))
    emit(json.dumps({"failed": run.failed}))
    if args.out:
        with open(args.out, "w") as fh:
            fh.write("\n".join(lines) + "\n")
    return 1 if run.failed else 0


if __name__ == "__main__":
    sys.exit(main())
