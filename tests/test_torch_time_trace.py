"""tools/sass_walk.py's reading of compiled code and tools/time_trace.py's
sweep and waves, on the CPU.

* parse_sass and walk_step on a hand-written listing whose counts are
  worked out below, and on two listings nvcc built for sm_90a (tests/data):
  render_mono_kernel<true, kEuler, false>, whose flags were read at run
  time, and tools/time_trace.py's step_walk<true, kEuler, 0>, the same loop
  with the flags fixed. The walk along a launch's flags counts what the
  launch really issues a step: 68 SASS for the main path (flags 0) in the
  first, against the 52 of the second.
* The sweep's rewrite of render_mono.cu, the whole-wave cut, the issue
  floor, the mangled names of the instantiations, and which of them the
  route walk takes for every configuration chip_smoke.py drives.
* trace_planes.cu's fixed-flag launches read from its source, the route
  walked for config 4's exact cases (trace_planes<exact,rk4,flags=6>) and
  config 5's (trace_planes<exact,euler,ks,flags=20>), and
  launch.trace_planes.fixed against the instantiation each launch's own
  arguments select, on a stubbed library.
"""

from pathlib import Path

import re
import subprocess
import sys
import types

import pytest
import torch

import bhr_tpu_torch as bt
from bhr_tpu_torch.ops import trace_kernel
from bhr_tpu_torch.tools import sass_walk as sw
from bhr_tpu_torch.tools import time_trace as tt
from bhr_tpu_torch.utils.tracing import COUNTS

DATA = Path(__file__).resolve().parent / "data"

# A loop with a flag test (flags & 4, c[0x0][0x294] as in render_mono_kernel),
# a cold slow path (a CALL skipped by a branch) and a loop exit. With flags
# 0 a step is 0x40 .. 0x90 (the exit not taken, the CALL skipped), 0xb0
# (the flag test, taken), 0xe0 .. 0x100: 10 instructions, 1 MUFU; with
# flags 4 the two instructions at 0xc0 and 0xd0 run too: 12 and 2.
HAND = """
        Function : _Z4stepPf
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   LDC R2, c[0x0][0x294] ;
        /*0020*/                   LOP3.LUT P1, RZ, R2, 0x4, RZ, 0xc0, !PT ;
        /*0030*/                   MOV R0, RZ ;
.L_x_0:
        /*0040*/                   FMUL R3, R4, R4 ;
        /*0050*/                   FSETP.GT.AND P0, PT, R3, 100, PT ;
        /*0060*/              @P0  BRA `(.L_x_2) ;
        /*0070*/                   MUFU.RSQ R5, R3 ;
        /*0080*/                   FCHK P2, R5, R3 ;
        /*0090*/              @!P2 BRA `(.L_x_1) ;
        /*00a0*/                   CALL.REL.NOINC `(.L_x_3) ;
.L_x_1:
        /*00b0*/              @!P1 BRA `(.L_x_4) ;
        /*00c0*/                   FADD R6, R5, 1 ;
        /*00d0*/                   MUFU.RCP R6, R6 ;
.L_x_4:
        /*00e0*/                   IADD3 R0, R0, 0x1, RZ ;
        /*00f0*/                   ISETP.GE.AND P3, PT, R0, c[0x0][0x2a0], PT ;
        /*0100*/              @!P3 BRA `(.L_x_0) ;
.L_x_2:
        /*0110*/                   EXIT ;
.L_x_3:
        /*0120*/                   RET.REL.NODEC R8 `(_Z4stepPf) ;
"""
MONO = "render_mono_fast_euler.sass"
WALK = "step_walk_fast_euler.sass"


def _one(text: str):
    (name, ins), = sw.parse_sass(text).items()
    return name, ins


def _data(name: str):
    return _one((DATA / name).read_text())


def test_parse_sass_reads_labels_predicates_and_operands():
    name, ins = _one(HAND)
    assert name == "_Z4stepPf" and len(ins) == 19
    by_addr = {x.addr: x for x in ins}
    assert by_addr[0x60] == sw.Ins(0x60, "@P0", "BRA", 0x110, ("`(.L_x_2)",))
    assert by_addr[0xB0].target == 0xE0 and by_addr[0x100].target == 0x40
    assert by_addr[0xA0].target == 0x120  # a CALL's target
    assert by_addr[0x20].args == ("P1", "RZ", "R2", "0x4", "RZ", "0xc0", "!PT")


def test_parse_sass_of_a_built_kernel():
    name, ins = _data(MONO)
    assert sw.kernel_tag(name) == ("render_mono", True, "euler", False, None)
    assert len(ins) == 376 and ins[-1].addr == 0x1770
    assert sum(x.op.startswith("MUFU") for x in ins) == 12  # ray-gen 4, each loop 4
    loops = sorted((x.target, x.addr) for x in ins
                   if x.op == "BRA" and x.target is not None and x.target < x.addr)
    assert loops == [(0x820, 0xF90), (0x1020, 0x1740)]  # unswitched on adaptive dt


@pytest.mark.parametrize("flags,step,mufu", [(0, 10, 1), (4, 12, 2)])
def test_walk_step_resolves_the_flag_test(flags, step, mufu):
    _name, ins = _one(HAND)
    got = sw.walk_step(ins, {0x294: flags})
    assert (got["step_instructions"], got["step_mufu"]) == (step, mufu)
    assert (got["loop_instructions"], got["loop_mufu"]) == (13, 2)


def test_walk_step_takes_the_cold_path_and_not_an_unknown_test():
    # with no flag known, the forward branch over 0xc0-0xd0 (no slow path in
    # it) is not taken, the one over the CALL is
    _name, ins = _one(HAND)
    got = sw.walk_step(ins)
    assert (got["step_instructions"], got["step_mufu"]) == (12, 2)


def test_the_walked_kernel_gives_the_separate_kernels_52():
    _name, ins = _data(WALK)
    want = {"step_instructions": 52, "step_mufu": 3, "loop_instructions": 52, "loop_mufu": 3}
    assert sw.walk_step(ins) == want


# (flags, SASS, MUFU, the loop's SASS): the main path (0), flat, adaptive
# dt (the other unswitched loop), the disk, kerr_lt, adaptive + disk
ROUTES = [(0, 68, 3, 115), (1, 37, 1, 115), (2, 73, 3, 120), (4, 93, 4, 115), (8, 90, 3, 115),
          (6, 98, 4, 120)]


@pytest.mark.parametrize("flags,step,mufu,loop", ROUTES)
def test_walk_step_of_the_built_kernel(flags, step, mufu, loop):
    _name, ins = _data(MONO)
    got = sw.walk_step(ins, {sw.FLAGS_OFFSET["render_mono"]: flags})
    assert got == {"step_instructions": step, "step_mufu": mufu, "loop_instructions": loop,
                   "loop_mufu": 4}


def test_the_main_paths_real_step_is_68_not_52():
    funcs = sw.parse_sass((DATA / MONO).read_text())
    route = sw.route_step(funcs, "render_mono", True, "euler", 0)
    assert route["function"] == "render_mono<fast,euler>"
    assert (route["step_instructions"], route["step_mufu"]) == (68, 3)
    assert sw.route_step(funcs, "render_mono", False, "euler", 0) == {}  # no exact one here


def test_walk_step_leaves_the_kernel_only_after_a_step():
    _name, ins = _one(HAND)
    no_loop = [x for x in ins if x.addr != 0x100]
    assert sw.walk_step(no_loop) == {}
    exits = [sw.Ins(0x0, None, "EXIT", None, ())] + ins[1:]
    with pytest.raises(RuntimeError, match="left the kernel"):
        sw.walk_step(exits)


# ---- names, the launch's choice, the sweep, the floor --------------------------------

MANGLED = ("_ZN3bhr47_GLOBAL__N__0_14_render_mono_cu_0818render_mono_kernelIL{}"
           "EEEvNS_6ParamsEjiiiiPj")


@pytest.mark.parametrize("args,tag", [
    ("b1ELi0ELb0E", ("render_mono", True, "euler", False, None)),
    ("b0ELi1ELb1E", ("render_mono", False, "rk4", True, None)),
    ("b1ELi0ELb0ELin1E", ("render_mono", True, "euler", False, None)),
    ("b0ELi0ELb0ELi0E", ("render_mono", False, "euler", False, 0)),
    ("b1ELi0ELb1ELi20E", ("render_mono", True, "euler", True, 20)),
])
def test_kernel_tag(args, tag):
    assert sw.kernel_tag(MANGLED.format(args)) == tag
    if tag[4] == 20:
        assert sw.tag_text(tag) == "render_mono<fast,euler,ks,flags=20>"


def test_launched_function_prefers_the_fixed_instantiation():
    runtime, fixed = MANGLED.format("b1ELi0ELb0ELin1E"), MANGLED.format("b1ELi0ELb0ELi0E")
    ks = MANGLED.format("b1ELi0ELb1ELin1E")
    funcs = {runtime: [], fixed: [], ks: []}
    assert sw.launched_function(funcs, "render_mono", True, "euler", 0)[0] == fixed
    assert sw.launched_function(funcs, "render_mono", True, "euler", 2)[0] == runtime
    assert sw.launched_function(funcs, "render_mono", True, "euler", 16)[0] == ks
    assert sw.tag_text(sw.kernel_tag(fixed)) == "render_mono<fast,euler,flags=0>"
    # a build without it (the parent's) runs the one that reads the flags
    assert sw.launched_function({runtime: []}, "render_mono", True, "euler", 0)[0] == runtime
    assert sw.launched_function({runtime: []}, "render_mono", False, "euler", 0) is None


def test_ptxas_summary_names_the_fixed_instantiation():
    log = ("ptxas info    : Compiling entry function '" + MANGLED.format("b1ELi0ELb0ELi0E")
           + "' for 'sm_90a'\nptxas info    : Used 32 registers, used 0 barriers\n")
    assert sw.ptxas_summary(log) == "fast,euler,flags=0: 32 registers"


def test_sweep_source_routes_every_launch():
    text = (Path(tt.__file__).resolve().parents[1] / "csrc" / "render_mono.cu").read_text()
    out = tt.sweep_source(text)
    assert text.count("<<<") == out.count("<<<grid, block, tt_smem, s>>>") >= 4
    assert out.count("tt_prep(") == text.count("<<<") + 1
    assert out.index("static int tt_smem") > out.index('#include "trace_ray.cuh"')
    assert out.rstrip().endswith("int tt_blocks_per_sm() { return tt_blocks; }")
    with pytest.raises(RuntimeError, match="no launch"):
        tt.sweep_source("#include <x>\nint main() {}\n")


@pytest.mark.parametrize("slots,rows", [(792, 66), (1056, 44), (660, 66), (128 * 132, 0)])
def test_whole_waves(slots, rows):
    # 120 x 68 blocks of 16 x 16 at 1920x1080; 132 SMs at 6, 8 or 5 blocks
    assert tt.whole_waves(120, 68, slots) == rows
    if rows:
        assert 120 * rows % slots == 0 and all(120 * r % slots for r in range(rows + 1, 69))


def test_issue_floor_of_the_parents_step():
    # 52 SASS a step over the main path's 30,102,153 warp-steps at 1980 MHz
    assert sw.issue_floor_ms(52, 30_102_153, 132, 1980.0) == pytest.approx(1.4973, abs=1e-4)
    assert sw.issue_floor_ms(68, 30_102_153, 132, 1980.0) == pytest.approx(1.9580, abs=1e-4)


def test_warp_steps_take_each_warps_longest_ray():
    steps = torch.zeros((3, 20), dtype=torch.int32)
    steps[0, 0], steps[1, 5], steps[2, 17] = 7, 9, 4
    # warps: rows 0-1 x cols 0-15 (max 9), rows 0-1 x 16-31 (0), rows 2-3 x 0-15 (0),
    # rows 2-3 x 16-31 (4)
    assert sw.warp_steps(torch, steps) == 13


# ---- which instantiation the route walk takes for each driven configuration -------

PLUGIN_CONFIG = dict(model="custom", custom_accel=lambda *a: a[:3])
# every configuration chip_smoke.py traces, with the flags fixed in the
# render_mono instantiation its launch runs in the fast and in the exact tier
# (None: the one that reads them at run time). The C entries launch the one
# fixed at 0 for an Euler frame with no flag set (the main path, the debug
# heatmap, textures and multires at Euler, the plugin at Euler), and
# render_mono.cu the one fixed at 20 for a fast Euler Kerr-Schild frame with
# the disk alone (config 5). trace_planes.cu launches, in the exact tier
# alone, the one fixed at 6 for an rk4 frame with adaptive dt and the disk
# alone (config 4) and the one fixed at 20 for an Euler Kerr-Schild frame
# with the disk alone (config 5): DRIVEN_PLANES.
MAIN, RUNTIME, CONFIG5 = (0, 0), (None, None), (20, None)
DRIVEN = (
    [(dict(integrator=i, model=m, adaptive=a),
      MAIN if i == "euler" and m == "schwarzschild" and not a else RUNTIME)
     for i in ("euler", "rk4", "leapfrog") for a in (False, True)
     for m in ("schwarzschild", "flat", "kerr", "kerr_lt")]  # the 160x96 matrix
    + [(dict(), MAIN),  # the main path, its front end, debug, textures, multires, bands
       (dict(integrator="rk4", adaptive=True, disk=True), RUNTIME),  # config 4
       (dict(model="kerr", disk=True), CONFIG5),  # config 5
       (dict(model="kerr_lt"), RUNTIME),
       (dict(disk=True), RUNTIME)]
    + [(dict(integrator=i, **PLUGIN_CONFIG), MAIN if i == "euler" else RUNTIME)
       for i in ("euler", "rk4", "leapfrog")]
)
# every instantiation render_mono.cu builds: the 12 that read their flags at
# run time, the 2 Euler ones with the flags fixed at 0 and the fast Euler
# Kerr-Schild one with the flags fixed at 20
BUILT = {MANGLED.format(f"b{fast}ELi{i}ELb{ks}E{fl}"): []
         for fast in (0, 1) for i in range(3) for ks in (0, 1)
         for fl in (("Lin1E", "Li0E") if i == 0 and not ks else
                    ("Lin1E", "Li20E") if i == 0 and fast else ("Lin1E",))}


# the trace_planes instantiation the same configurations launch in the fast
# and in the exact tier
CONFIG4_KW, CONFIG5_KW = dict(integrator="rk4", adaptive=True, disk=True), dict(model="kerr",
                                                                              disk=True)
DRIVEN_PLANES = [(kw, (None, 6) if kw == CONFIG4_KW else (None, 20) if kw == CONFIG5_KW
                  else fixed if fixed == MAIN else RUNTIME) for kw, fixed in DRIVEN]


def _launched(config, fast=True):
    return sw.launched_function(BUILT, "render_mono", fast, config.integrator,
                                trace_kernel.trace_flags(config))


@pytest.mark.parametrize("kw,fixed", DRIVEN, ids=[str(i) for i in range(len(DRIVEN))])
def test_launched_function_for_every_driven_configuration(kw, fixed):
    cfg = bt.TraceConfig(**kw)
    for fast, want in zip((True, False), fixed):
        _name, tag = _launched(cfg, fast)
        assert tag[:4] == ("render_mono", fast, cfg.integrator, cfg.model == "kerr")
        assert tag[4] == want
        if want is not None:
            assert trace_kernel.trace_flags(cfg) == want and cfg.integrator == "euler"


@pytest.mark.parametrize("kw,fixed", DRIVEN_PLANES,
                         ids=[str(i) for i in range(len(DRIVEN_PLANES))])
def test_planes_launched_function_for_every_driven_configuration(kw, fixed):
    cfg = bt.TraceConfig(**kw)
    flags = trace_kernel.trace_flags(cfg)
    for fast, want in zip((True, False), fixed):
        _name, tag = sw.launched_function(BUILT_PLANES, "trace_planes", fast, cfg.integrator,
                                          flags)
        assert tag[:4] == ("trace_planes", fast, cfg.integrator, cfg.model == "kerr")
        assert tag[4] == want
        assert (want is not None) == trace_kernel.planes_flags_fixed(cfg.integrator, flags, fast)
        if want is not None:
            assert flags == want


def test_the_renderer_main_path_is_the_fixed_one():
    r = bt.BlackHoleRenderer(16, 8, device="cpu")
    assert _launched(r.config)[1][4] == 0
    assert _launched(bt.BlackHoleRenderer(16, 8, "rk4", device="cpu").config)[1][4] is None


def test_cpu_wrappers_count_no_launch():
    before = (COUNTS["launch.render_mono"], COUNTS["launch.trace_planes"])
    scene = bt.SceneParams(screen_width=8, screen_height=4, max_steps=5)
    trace_kernel.render_packed(bt.Camera.default(), scene, device="cpu")
    trace_kernel.trace_image(bt.Camera.default(), scene, device="cpu")
    assert (COUNTS["launch.render_mono"], COUNTS["launch.trace_planes"]) == before


def test_time_trace_runs_as_a_script_without_the_package():
    """Run as a script, the tool reads sass_walk beside it and imports no
    bhr_tpu_torch: each ROOT's measuring process imports ROOT's own."""
    tools = Path(tt.__file__).resolve().parent
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import time_trace; "
            "print('bhr_tpu_torch' in sys.modules, time_trace.sw.__name__)")
    out = subprocess.run([sys.executable, "-c", code, str(tools)], capture_output=True,
                         text=True, check=True, cwd=tools)
    assert out.stdout.split() == ["False", "sass_walk"]


# ---- trace_planes.cu: the launch rule, the fixed count and the route walked --------

PLANES_MANGLED = ("_ZN3bhr48_GLOBAL__N__0_15_trace_planes_cu_0818trace_planes_kernelIL{}"
                  "EEEvNS_6ParamsEiiiiPKfPfS4_PiS5_")
# every instantiation trace_planes.cu builds: the 12 that read their flags at
# run time, the 2 Euler ones with the flags fixed at 0, the exact rk4 one
# with the flags fixed at adaptive | disk (6), BASELINE config 4's, and the
# exact Euler Kerr-Schild one with the flags fixed at Kerr-Schild | disk
# (20), BASELINE config 5's
BUILT_PLANES = {PLANES_MANGLED.format(f"b{fast}ELi{i}ELb{ks}E{fl}"): []
                for fast in (0, 1) for i in range(3) for ks in (0, 1)
                for fl in (("Lin1E", "Li0E") if i == 0 and not ks else
                           ("Lin1E", "Li6E") if i == 1 and not ks and not fast else
                           ("Lin1E", "Li20E") if i == 0 and ks and not fast else ("Lin1E",))}
TEMPLATE_ARGS = {"FAST": (True, False), "false": (False,), "true": (True,)}


def _fixed_launches_in_source() -> set:
    """(fast, integrator, flags) of every launch of trace_planes.cu whose
    instantiation fixes its flags, read from its source."""
    text = (Path(tt.__file__).resolve().parents[1] / "csrc" / "trace_planes.cu").read_text()
    consts = {"kExactRk4Disk": 2 | 4, "kExactKsDisk": 16 | 4}
    found = set()
    for args in re.findall(r"trace_planes_kernel<([^<>]+)><<<", text):
        parts = [a.strip() for a in args.split(",")]
        if len(parts) == 4:
            integ = ("kEuler", "kRk4", "kLeapfrog").index(parts[1])
            flags = consts.get(parts[3]) if parts[3] in consts else int(parts[3])
            found |= {(fast, sw.INTEGRATORS[integ], flags) for fast in TEMPLATE_ARGS[parts[0]]}
    return found


def test_the_source_fixes_the_flags_of_these_launches():
    assert _fixed_launches_in_source() == {(True, "euler", 0), (False, "euler", 0),
                                           (False, "rk4", 6), (False, "euler", 20)}
    assert {sw.kernel_tag(n)[4] for n in BUILT_PLANES} == {None, 0, 6, 20}
    assert {(t[1], t[2], t[4]) for t in map(sw.kernel_tag, BUILT_PLANES)
            if t[4] is not None} == _fixed_launches_in_source()


@pytest.mark.parametrize("case", ["config4_exact", "strided_config4_exact",
                                  "masked_config4_exact"])
def test_the_config4_route_walks_the_fixed_instantiation(case):
    fast, integ, flags = tt.FLAGS_OF_CASE[case]
    _name, tag = sw.launched_function(BUILT_PLANES, "trace_planes", fast, integ, flags)
    assert sw.tag_text(tag) == "trace_planes<exact,rk4,flags=6>"
    # the parent's build, without it, runs the one that reads the flags
    runtime = {n: [] for n in BUILT_PLANES if "Li6E" not in n}
    assert sw.tag_text(sw.launched_function(runtime, "trace_planes", fast, integ, flags)[1]) \
        == "trace_planes<exact,rk4>"


def test_the_config5_route_walks_the_fixed_instantiation():
    fast, integ, flags = tt.FLAGS_OF_CASE["config5_exact"]
    _name, tag = sw.launched_function(BUILT_PLANES, "trace_planes", fast, integ, flags)
    assert sw.tag_text(tag) == "trace_planes<exact,euler,ks,flags=20>"
    # the parent's build, without it, runs the one that reads the flags
    runtime = {n: [] for n in BUILT_PLANES if "Li20E" not in n}
    assert sw.tag_text(sw.launched_function(runtime, "trace_planes", fast, integ, flags)[1]) \
        == "trace_planes<exact,euler,ks>"
    # and the fast tier's Kerr-Schild Euler trace with the disk reads them still
    fast, integ, flags = tt.FLAGS_OF_CASE["ks_planes_euler_fast"]
    _name, tag = sw.launched_function(BUILT_PLANES, "trace_planes", fast, integ, flags)
    assert sw.tag_text(tag) == "trace_planes<fast,euler,ks>"


CONFIG4 = dict(integrator="rk4", adaptive=True, disk=True)
CONFIG5 = dict(model="kerr", disk=True)
# (configuration keywords, fast_math, multires pass): the fixed instantiations'
# launches, then their neighbours, which read their flags; then config 5's
# exact launches, whole and in either pass, and their neighbours
PLANES_LAUNCHES = [
    (dict(), False, None), (dict(), True, None), (dict(), False, "strided"),
    (CONFIG4, False, None), (CONFIG4, False, "strided"), (CONFIG4, False, "masked"),
    (dict(CONFIG4, model="custom"), False, None),
    (CONFIG4, True, None), (dict(CONFIG4, integrator="leapfrog"), False, None),
    (dict(CONFIG4, model="kerr_lt"), False, None), (dict(CONFIG4, model="flat"), False, None),
    (dict(CONFIG4, model="kerr"), False, None), (dict(integrator="rk4", adaptive=True), False,
                                                 None),
    (dict(integrator="rk4", disk=True), False, None),
    (CONFIG5, False, None), (CONFIG5, False, "strided"), (CONFIG5, False, "masked"),
    (CONFIG5, True, None), (dict(model="kerr"), False, None),
    (dict(CONFIG5, adaptive=True), False, None), (dict(CONFIG5, integrator="leapfrog"), False,
                                                  None),
]


@pytest.mark.parametrize("kw,fast,multires", PLANES_LAUNCHES,
                         ids=[str(i) for i in range(len(PLANES_LAUNCHES))])
def test_the_fixed_count_follows_the_launch_rule(monkeypatch, kw, fast, multires):
    """On a stubbed library: launch.trace_planes.fixed counts a launch
    exactly when the instantiation the launch's own arguments select in
    trace_planes.cu (sass_walk.launched_function over its instantiations)
    fixes its flags."""
    from bhr_tpu_torch.utils import build

    launched = []
    lib = types.SimpleNamespace(bhr_trace_planes=lambda *a: launched.append(a) or 0)
    monkeypatch.setattr(trace_kernel, "_kernel_device",
                        lambda device, name: torch.device("cuda", 0))
    monkeypatch.setattr(trace_kernel, "_check_out", lambda *a: None)
    monkeypatch.setattr(trace_kernel, "_check_mask", lambda *a: None)
    monkeypatch.setattr(trace_kernel, "cuda_source", lambda accel: "")
    for name in ("load_trace_planes", "load_trace_planes_custom"):
        monkeypatch.setattr(build, name, lambda *a: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    if kw.get("model") == "custom":
        kw = dict(kw, custom_accel=PLUGIN_CONFIG["custom_accel"], custom_capture_factor=1.05)
    extra = (dict(stride=2, local_shape=(3, 4)) if multires == "strided" else
             dict(mask=torch.ones((6, 8))) if multires == "masked" else {})
    scene = bt.SceneParams(screen_width=8, screen_height=6, max_steps=4)
    before = COUNTS["launch.trace_planes.fixed"]
    trace_kernel.trace_image(bt.Camera.default(), scene, bt.TraceConfig(**kw), fast_math=fast,
                             device="cuda", out=trace_kernel.empty_trace_result(6, 8, "cpu"),
                             **extra)
    (args,) = launched
    fast_arg, integ, flags = bool(args[1]), sw.INTEGRATORS[args[2]], args[3]
    _name, tag = sw.launched_function(BUILT_PLANES, "trace_planes", fast_arg, integ, flags)
    fixed = tag[4] is not None
    assert COUNTS["launch.trace_planes.fixed"] - before == int(fixed)
    assert fixed == trace_kernel.planes_flags_fixed(integ, flags, fast_arg)
    want = (integ == "euler" and not kw) or (kw.get("model") in (None, "custom") and not fast
                                             and kw.get("disk") and kw.get("adaptive")
                                             and integ == "rk4") or (
        kw.get("model") == "kerr" and not fast and kw.get("disk") and not kw.get("adaptive")
        and integ == "euler")
    assert fixed == bool(want)
