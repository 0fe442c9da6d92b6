"""The neural kernel's default-tier floor and plans, on the CPU.

* tools/neural_floor.py's counts against the figures worked out by hand
  for 1920x1080: 35.25 M mma.sync for N1 (16 -> 128 -> 128 -> 128 -> 2) and
  141 M for N2 (22, padded to 32, -> 256 -> 256 -> 256 -> 3); 796 M and
  1.59 G hidden outputs; 1.13 GB and 4.51 GB of weights copied from L2 a
  frame at the chunked plan of 128 pixels a block, and what the fused plans
  copy (N1's held once a block, N2's streamed once a round of 256 pixels);
  the streamed layout's 4.41 M / 17.6 M wgmma.m64n64k16 for N2 at 1080p
  and 4K.
* the floor's terms, the shortest and longest SASS paths of a hand-made
  listing, and the issue term's per-pixel and per-output counts.
* ops/neural_kernel.kernel_plan for every net chip_smoke.py drives, and the
  kernels line's name of each instantiation (chip_smoke.neural_variant).
* the bf16 chain, tools/time_neural.py's variant rewrites against this
  checkout's source, and tools/tanh_sensitivity.py's frame statistics.
"""

import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import bhr_tpu_torch as T
from bhr_tpu_torch.models import neural as tn
from bhr_tpu_torch.models import neural_kerr as tnk
from bhr_tpu_torch.ops import neural_kernel as nk
from bhr_tpu_torch.tools import neural_floor as nf
from bhr_tpu_torch.tools import sass_walk as sw
from bhr_tpu_torch.tools import tanh_sensitivity, time_neural

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

FRAME = 1920 * 1080
N1, N2 = [16, 128, 128, 128, 2], [32, 256, 256, 256, 3]
CSRC = Path(nk.__file__).resolve().parents[1] / "csrc" / "neural_mlp.cu"


def _net(dims):
    return T.NeuralSurrogate((np.zeros((a, b)), np.zeros(b)) for a, b in zip(dims, dims[1:]))


@pytest.mark.parametrize("dims,mma,tanh,chunked,fused,plan", [
    (N1, 35_251_200, 796_262_400, 1_128_038_400, 132 * 69_632, (384, 0, 0, 128)),
    (N2, 141_004_800, 1_592_524_800, 4_512_153_600, 8100 * 278_528, (256, 64, 4, 256))],
    ids=["n1", "n2"])
def test_floor_counts_at_1080p(dims, mma, tanh, chunked, fused, plan):
    """The counts of a 1920x1080 frame: 272 (N1) or 1088 (N2) mma.sync a
    tile of 16 pixels; 384 or 768 hidden outputs a pixel; the chunked plan
    copies every hidden layer (69,632 or 278,528 bf16 bytes) into each of
    its 16,200 blocks, the fused plans into each of 132 persistent blocks
    (weights held) or each of 8,100 rounds of 256 pixels (streamed)."""
    assert nf.mma_count(dims, 16) == {16: 272, 32: 1088}[dims[0]]
    assert nf.mma_count(dims, FRAME) == mma
    assert nf.tanh_count(dims, FRAME) == tanh
    assert nf.weight_bytes(dims, (128, 64, 2), FRAME) == chunked
    assert nf.weight_bytes(dims, (128, 64, 2, 0), FRAME) == chunked
    assert nf.weight_bytes(dims, plan, FRAME) == fused
    assert nk.kernel_plan(_net([dims[0] if dims[0] == 16 else 22] + dims[1:]), "default") == plan
    assert round(mma / 1e6, 2) == {16: 35.25, 32: 141.0}[dims[0]]
    assert round(chunked / 1e9, 2) == {16: 1.13, 32: 4.51}[dims[0]]


@pytest.mark.parametrize("pixels,wgmma", [(1920 * 1080, 4_406_400), (3840 * 2160, 17_625_600),
                                          (97 * 61, 24 * 4 * 136)], ids=["1080p", "4k", "ragged"])
def test_wgmma_count_of_the_streamed_plan(pixels, wgmma):
    """N2's wgmma.m64n64k16 a frame at the streamed plan: a tile of 64
    pixels takes 2 x 4 + 16 x 4 + 16 x 4 = 136 (k-steps x chunks of 64
    channels a layer), four tiles a round of 256 pixels, 8,100 rounds at
    1080p and 32,400 at 4K, the last round's missing pixels computed too."""
    assert nf.wgmma_count(N2, 64) == 4 * 136
    assert nf.wgmma_count(N2, pixels) == wgmma
    assert nf.wgmma_count(N2, pixels) * 64 * 64 * 16 >= nf.mma_count(N2, pixels) * 16 * 8 * 16
    assert nf.streamed((256, 64, 4, 256)) and not nf.streamed((384, 0, 0, 128))
    assert not nf.streamed((256, 64, 2, 256))  # its mma.sync predecessor
    assert not nf.streamed((128, 64, 2))


def test_floor_terms_of_the_streamed_plan():
    """The streamed plan's tensor term counts wgmma at their own rate, and
    its issue term leaves the products out; the weights are copied once a
    round of 256 pixels."""
    plan = (256, 64, 4, 256)
    t = nf.floor_terms(N2, plan, 3840 * 2160, cycles_per_mma=1.5, cycles_per_wgmma=40.0,
                       issue_pixel=1400, issue_output=17.5, l2_bytes_per_s=1e13, clock_mhz=1980)
    hz = 1980e6
    assert t["mma"] == 17_625_600 and t["instruction"] == "wgmma.m64n64k16"
    assert t["tensor_ms"] == pytest.approx(17_625_600 * 40.0 / (132 * hz) * 1e3)
    warp_ins = (3840 * 2160 * 1400 + 6_370_099_200 * 17.5) / 32
    assert t["warp_instructions"] == pytest.approx(warp_ins)
    assert t["weight_bytes"] == 32400 * 278_528
    held = nf.floor_terms(N2, (128, 64, 2), 3840 * 2160, cycles_per_mma=1.5, issue_pixel=1400,
                          issue_output=17.5, l2_bytes_per_s=1e13, clock_mhz=1980)
    assert held["instruction"] == "mma.sync.m16n8k16"
    assert held["warp_instructions"] == pytest.approx(warp_ins + nf.mma_count(N2, 3840 * 2160))


def test_mlp_dims_pads_the_inputs():
    kp, _ = tnk.load_params(tn.ASSETS_DIR / "neural_kerr.npz")
    assert nf.mlp_dims(kp, nk.padded_inputs) == N2 == nk.mlp_dims(kp)
    sp, _ = tn.load_params(tn.ASSETS_DIR / "neural_schwarzschild.npz")
    assert nf.mlp_dims(sp, nk.padded_inputs) == N1 == nk.mlp_dims(sp)
    assert nf.hidden_weight_bytes(N1) == 69_632 and nf.hidden_weight_bytes(N2) == 278_528
    assert nf.head_ops(N1) == 256 and nf.head_ops(N2) == 768


def test_floor_terms_take_the_largest():
    """Each term from its inputs, at 132 SMs x 4 schedulers and 1980 MHz."""
    t = nf.floor_terms(N1, (128, 64, 2), FRAME, cycles_per_mma=1.5, issue_pixel=1400,
                       issue_output=17.5, l2_bytes_per_s=1e13, clock_mhz=1980)
    hz = 1980e6
    assert t["tensor_ms"] == pytest.approx(35_251_200 * 1.5 / (132 * hz) * 1e3)
    warp_ins = (FRAME * 1400 + 796_262_400 * 17.5) / 32 + 35_251_200
    assert t["warp_instructions"] == pytest.approx(warp_ins)
    assert t["issue_ms"] == pytest.approx(warp_ins / (132 * 4 * hz) * 1e3)
    assert t["l2_ms"] == pytest.approx(1_128_038_400 / 1e13 * 1e3)
    assert t["floor_ms"] == max(t["tensor_ms"], t["issue_ms"], t["l2_ms"]) == t["issue_ms"]
    assert t["bound_by"] == "issue"
    assert t["sum_ms"] == pytest.approx(t["tensor_ms"] + t["issue_ms"] + t["l2_ms"])
    slow_l2 = nf.floor_terms(N1, (128, 64, 2), FRAME, cycles_per_mma=1.5, issue_pixel=1400,
                             issue_output=17.5, l2_bytes_per_s=1e11, clock_mhz=1980)
    assert slow_l2["bound_by"] == "l2" and slow_l2["floor_ms"] == slow_l2["l2_ms"]


# A function with a forward conditional branch, a predicated EXIT, an
# unconditional jump over a dead instruction, a CALL and a back edge: from
# 0x00, taking the branch at 0x10 reaches 0x40 (3 instructions, the EXIT
# taken) or 0x50, 0x60, 0xa0 (6); falling through adds 0x20, 0x30 (5 or 8).
HAND = """
        Function : _ZN3bhr6nf_epiEPKfS1_P14__nv_bfloat162
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/              @P0 BRA `(.L_x_1) ;
        /*0020*/                   FADD R2, R2, R3 ;
        /*0030*/                   CALL.REL.NOINC `(.L_x_3) ;
.L_x_1:
        /*0040*/              @P1 EXIT ;
        /*0050*/                   FMUL R2, R2, R2 ;
        /*0060*/                   BRA `(.L_x_2) ;
        /*0070*/                   FFMA R2, R2, R2, R2 ;
        /*0080*/              @P2 BRA `(.L_x_1) ;
        /*0090*/                   FFMA R2, R2, R2, R2 ;
.L_x_2:
        /*00a0*/                   EXIT ;
.L_x_3:
        /*00b0*/                   MUFU.RCP R4, R4 ;
        /*00c0*/                   RET.REL.NODEC R20 `(_ZN3bhr6nf_epiEPKfS1_P14__nv_bfloat162) ;
"""


def test_path_lengths_of_a_hand_made_listing():
    funcs = sw.parse_sass(HAND)
    (ins,) = funcs.values()
    assert [x.op for x in ins][:5] == ["MOV", "BRA", "FADD", "CALL.REL.NOINC", "EXIT"]
    assert nf.path_lengths(ins) == (3, 8)
    assert nf.path_lengths(ins[10:]) == (1, 1)  # the lone EXIT
    assert nf.path_lengths(ins[7:]) == (4, 4)  # FFMA, @P2 BRA (a back edge: not followed), ...


def test_phase_counts_and_issue_per_pixel():
    """phase_counts finds each phase kernel by its mangled name; a pixel
    issues the shade kernel's shortest path and the head's fmaf, a hidden
    output half the epilogue pair's shortest path less its frame, plus its
    bias add and half a pack."""
    def straight(n):  # n instructions, the last an EXIT
        return [sw.Ins(16 * i, None, "FADD", None, ()) for i in range(n - 1)] + [
            sw.Ins(16 * (n - 1), None, "EXIT", None, ())]

    names = ["_ZN3bhr11nf_featuresILb0EEEvNS_6ParamsEPKfPf",
             "_ZN3bhr11nf_featuresILb1EEEvNS_6ParamsEPKfPf",
             "_ZN3bhr8nf_shadeILb0EEEvNS_6ParamsEPKfS3_Pj",
             "_ZN3bhr8nf_shadeILb1EEEvNS_6ParamsEPKfS3_Pj",
             "_ZN3bhr11nf_epi_baseEPKfS1_P14__nv_bfloat162",
             "_ZN3bhr6nf_epiEPKfS1_P14__nv_bfloat162"]
    funcs = {n: straight(k + 2) for k, n in enumerate(names)}
    counts = nf.phase_counts(funcs)
    assert counts["nf_epi"][0] == 2 + 5 and counts["nf_epi_base"][0] == 2 + 4
    assert counts["nf_shade<kerr>"][0] == 2 + 3
    pixel, output = nf.issue_per_pixel(counts, N2, kerr=True)
    assert pixel == counts["nf_shade<kerr>"][0] + 768
    assert output == (7 - 6) / 2 + 1.5


# Every net chip_smoke.py renders through the kernel, and its plan: the
# committed nets (the 128-wide Schwarzschild nets' weights held, the
# 256-wide ones streamed) at the default tier, the fp32-trained Kerr net at
# the highest, and PLAN_NETS (seeded random nets, hidden (w, 128, w)).
COMMITTED = {"neural_schwarzschild.npz": (384, 0, 0, 128),
             "neural_schwarzschild_orbit.npz": (384, 0, 0, 128),
             "neural_schwarzschild_orbit_xl.npz": (256, 64, 4, 256),
             "neural_kerr.npz": (256, 64, 4, 256)}
PLANS = {("default", "kerr", 128): (384, 0, 0, 128), ("default", "kerr", 256): (256, 64, 4, 256),
         ("default", "kerr", 384): (64, 64, 2, 0),
         ("default", "schwarzschild", 512): (64, 64, 1, 0),
         ("default", "kerr", 640): (32, 64, 1, 0),
         ("default", "schwarzschild", 1152): (16, 64, 1, 0),
         ("highest", "schwarzschild", 384): (64, 32, 2, 0),
         ("highest", "kerr", 512): (64, 16, 2, 0),
         ("highest", "schwarzschild", 640): (32, 16, 2, 0),
         ("highest", "kerr", 768): (32, 16, 2, 0),
         ("highest", "schwarzschild", 1024): (32, 16, 1, 0)}


@pytest.mark.parametrize("asset", sorted(COMMITTED))
def test_kernel_plan_of_the_committed_nets(asset):
    load = tnk.load_params if "kerr" in asset else tn.load_params
    params, _ = load(tn.ASSETS_DIR / asset)
    plan = nk.kernel_plan(params, "default")
    assert plan == COMMITTED[asset]
    assert nk.smem_bytes(nk.mlp_dims(params), plan, "default") <= nk.SMEM_LIMIT
    model = "kerr" if "kerr" in asset else "schwarzschild"
    main = asset in ("neural_schwarzschild.npz", "neural_schwarzschild_orbit.npz",
                     "neural_kerr.npz")
    assert (chip_smoke.neural_variant(model, False, plan)
            == (f"neural_mlp<{model},default>" if main else "neural_mlp[fused]<schwarzschild,256>"))
    fp32, _ = tnk.load_params(tn.ASSETS_DIR / "neural_kerr_default.npz")
    assert nk.kernel_plan(fp32, "highest") == (128, 32, 2, 0)
    assert chip_smoke.neural_variant("kerr", True, (128, 32, 2, 0)) == "neural_mlp<kerr,highest>"


@pytest.mark.parametrize("case", chip_smoke.PLAN_NETS,
                         ids=[f"{t}-{m}-{w}" for t, m, w, _ in chip_smoke.PLAN_NETS])
def test_kernel_plan_of_every_plan_net(case):
    """chip_smoke's PLAN_NETS, and the TIMED_PLAN_NETS it times at full
    width, at the plans and names the kernels line gives them."""
    tier, model, width, seed = case
    net = T.NeuralSurrogate(chip_smoke.random_net(model, width, seed))
    plan = nk.kernel_plan(net, tier)
    assert plan == PLANS[(tier, model, width)]
    assert nk.smem_bytes(nk.mlp_dims(net), plan, tier) <= nk.SMEM_LIMIT
    name = chip_smoke.neural_variant(model, tier == "highest", plan)
    timed = {(m, w, s) for m, w, s in chip_smoke.TIMED_PLAN_NETS.values()}
    if (model, width, seed) in timed:
        assert chip_smoke.TIMED_PLAN_NETS[name] == (model, width, seed)


@pytest.mark.parametrize("hidden", range(1, 8))
def test_kernel_plan_by_layer_count(hidden):
    """Up to 8 layers: a 128-wide net holds its weights while they fit
    beside the 12 warps' staging rows (4 hidden layers), then streams; a
    256-wide net always streams."""
    narrow = nk.kernel_plan(_net([16] + [128] * hidden + [2]), "default")
    assert narrow == ((384, 0, 0, 128) if hidden <= 4 else (256, 64, 4, 256))
    assert nk.kernel_plan(_net([22] + [256] * hidden + [3]), "default") == (256, 64, 4, 256)
    for dims, plan in (([16] + [128] * hidden + [2], narrow),):
        assert nk.smem_bytes(dims, plan, "default") <= nk.SMEM_LIMIT


def test_bf16_chain_on_the_cpu():
    """bf16 operands and every intermediate in bf16: the sum of each layer
    rounded before its bias, tanh on the hidden layers only."""
    rng = np.random.default_rng(0)
    dims = [16, 32, 32, 2]
    layers = [(torch.from_numpy(rng.standard_normal((a, b))).to(torch.bfloat16),
               torch.from_numpy(rng.standard_normal(b)).to(torch.bfloat16))
              for a, b in zip(dims, dims[1:])]
    x = torch.from_numpy(rng.standard_normal((64, 16))).to(torch.bfloat16)
    got = nf.bf16_chain(layers, x)
    want = x
    for i, (w, b) in enumerate(layers):
        want = (want @ w) + b
        if i < 2:
            want = torch.tanh(want)
    assert got.dtype == torch.bfloat16 and got.shape == (64, 2)
    assert torch.equal(got, want)


@pytest.mark.parametrize("variant", sorted(time_neural.VARIANTS))
def test_time_neural_variants_rewrite_this_source(variant):
    """Each variant build of tools/time_neural.py finds the text it rewrites
    in this checkout's csrc/neural_mlp.cu, so that it times this kernel."""
    src = CSRC.read_text()
    for old, new in time_neural.VARIANTS[variant]:
        assert old in src and old != new


def test_phase_source_names_the_kernel_functions():
    """PHASE_SOURCE calls the kernel's own per-pixel functions, so they
    must keep these names and fields."""
    src = CSRC.read_text()
    for name in ("Geo pixel_geometry(", "void shade_pixel(", "Frame frame_constants(",
                 "float c, s, whx, why, whz, nyp, t_env;", "float rs, r0, ux, uy, uz, spin;"):
        assert name in src
    assert time_neural._plan4((128, 64, 2)) == [128, 64, 2, 0]
    assert time_neural._plan4((384, 0, 0, 128)) == [384, 0, 0, 128]


def test_tanh_sensitivity_frame_stats():
    want = torch.zeros((2, 4), dtype=torch.int32)
    rgba = want.view(torch.uint8).view(2, 4, 4)
    rgba[..., 3] = 255
    rgba[0, 0, :3] = 10
    got = want.clone()
    g = got.view(torch.uint8).view(2, 4, 4)
    g[0, 0, 0] = 13  # off by 3
    g[1, 1, :3] = 1  # off by 1, and no longer black
    stats = tanh_sensitivity.frame_stats(got, want)
    assert stats == {"bit_same": 6 / 8, "off_by_more_than_2": 1 / 8, "black_agree": 7 / 8}
