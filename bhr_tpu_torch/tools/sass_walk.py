"""Read the geodesic kernels' compiled code: the loop step a launch
really issues, and its issue floor.

* ptxas_summary: registers and spills of every instantiation, from nvcc
  -Xptxas -v.
* parse_sass: the functions of a `cuobjdump -sass` listing, as Ins tuples.
* walk_step: one pass of the loop that a launch with some parameters known
  (its flags) runs along its common path, counted in SASS and SFU (MUFU)
  instructions; route_step picks the instantiation a launch of
  render_mono.cu or trace_planes.cu runs and walks it.
* warp_steps, issue_floor_ms, sm_clock_under_load: the warp-steps of a
  trace's step counts, the least time of that many steps at one warp
  instruction per scheduler per clock, and the SM clock read under load.

chip_smoke.py and tools/time_trace.py both use these; nothing here
imports either.
"""

from __future__ import annotations

import collections
import os
import re
import shutil
import subprocess
from pathlib import Path

INTEGRATORS = ("euler", "rk4", "leapfrog")
FLAG_KS = 16  # trace_ray.cuh TraceFlags: the Kerr-Schild loop
SCHEDULERS = 4  # warp schedulers an SM (Hopper)
BLOCK = (16, 16)  # the kernels' blocks: a warp is 2 rows x 16 columns


def run(cmd, **kw) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True, check=True, **kw)


def ptxas_summary(log: str) -> str:
    """'<kernel>: <registers and spills>' per instantiation, from nvcc
    -Xptxas -v (template arguments: tier ILb1 fast / ILb0 exact, the
    integrator Li0 euler / Li1 rk4 / Li2 leapfrog, then Lb1 for the
    Kerr-Schild loop, then flags=N for an instantiation whose flags are
    fixed at compile time; the neural kernel's model, tier and, at the
    default tier, its layout: chunked, fused with its register width, or
    streamed)."""
    out, tag = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"ILb([01])ELi([0-2])ELb([01])E(?:Li(\d+)E)?", line)
            n = re.search(r"neural_render_kernelILb([01])ELb([01])E", line)
            f = re.search(r"neural_fused_kernelILb([01])ELi(\d+)E", line)
            w = re.search(r"neural_fused_kernel_wsILb([01])E", line)
            tag = (f"{'fast' if m[1] == '1' else 'exact'},"
                   f"{('euler', 'rk4', 'leapfrog')[int(m[2])]}{',ks' if m[3] == '1' else ''}"
                   f"{f',flags={m[4]}' if m[4] else ''}"
                   if m else f"{'kerr' if n[1] == '1' else 'schwarzschild'},"
                   f"{'highest' if n[2] == '1' else 'default,chunked'}" if n else
                   f"{'kerr' if f[1] == '1' else 'schwarzschild'},default,fused{f[2]}" if f else
                   f"{'kerr' if w[1] == '1' else 'schwarzschild'},default,streamed" if w
                   else line.split()[-3])
        elif tag and "Used" in line:
            out.append(f"{tag}: {line.split('Used')[1].split(',')[0].strip()}")
        elif tag and "spill" in line and not line.strip().startswith("0 bytes stack frame, 0 "
                                                                        "bytes spill stores"):
            out.append(f"{tag}: {line.strip()}")
    return " | ".join(out) or "already built"


# ---- the SASS ------------------------------------------------------------------


def cuobjdump_path(nvcc: str) -> str | None:
    """The cuobjdump on PATH or beside nvcc, or None."""
    path = shutil.which("cuobjdump") or str(Path(nvcc).with_name("cuobjdump"))
    return path if os.access(path, os.X_OK) else None


Ins = collections.namedtuple("Ins", "addr pred op target args")


def parse_sass(text: str) -> dict:
    """{function: [Ins(address, predicate, opcode, target address or None,
    operands)]} from cuobjdump -sass."""
    funcs, cur, labels, pending = {}, None, {}, []
    raw = []
    for line in text.splitlines():
        m = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if m:
            cur = m[1]
            funcs[cur] = []
            raw.append((cur, None))
            continue
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab and cur:
            pending.append(lab[1])
            continue
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if ins and cur:
            addr = int(ins[1], 16)
            for name in pending:
                labels[(cur, name)] = addr
            pending = []
            raw.append((cur, (addr, ins[2])))
    for cur, item in raw:
        if item is None:
            continue
        addr, body = item
        toks = body.split(None, 1)
        pred = None
        if toks and toks[0].startswith("@"):
            pred = toks[0]
            toks = toks[1].split(None, 1) if len(toks) > 1 else []
        op = toks[0] if toks else ""
        args = tuple(a.strip() for a in toks[1].split(",")) if len(toks) > 1 else ()
        target = None
        if op.startswith("BRA") or op.startswith("BSSY") or op.startswith("CALL"):
            m = re.search(r"`\((\.L_x_\d+)\)", body)
            if m:
                target = labels.get((cur, m[1]))
            else:
                m = re.search(r"\b0x([0-9a-f]+)\b", body)
                target = int(m[1], 16) if m else None
        funcs[cur].append(Ins(addr, pred, op, target, args))
    return funcs


def _is_jump(x: Ins) -> bool:
    """A branch that may be taken (BRA.DIV, a branch on divergence, is
    taken only when the warp diverges: never on the common path)."""
    return (x.op.startswith("BRA") and not x.op.startswith("BRA.DIV") and x.target is not None
            and x.pred != "@!PT")


# ---- one loop step along the route a launch takes ---------------------------------
#
# walk_step follows the path one launch takes through a kernel as built,
# with some of its parameters known: the kernel parameters sit in constant
# bank 0 from 0x210 on sm_90, so a launch's flags are c[0x0][0x294] in
# render_mono_kernel (after the 128-byte Params and seed_term) and
# c[0x0][0x290] in trace_planes_kernel. It tracks the registers and
# predicates that depend only on known parameters (LDC / ULDC of them, MOV,
# LOP3.LUT, ISETP) and resolves each branch on such a predicate.

FLAGS_OFFSET = {"render_mono": 0x294, "trace_planes": 0x290}
_MASK32 = 0xFFFFFFFF
_CBANK = re.compile(r"c\[0x0\]\[(0x[0-9a-f]+)\]")


def _strip(tok: str) -> str:
    return tok.strip().removesuffix(".reuse")


def _int(tok: str, regs: dict, consts: dict):
    """The known 32-bit value of an operand, or None."""
    tok = _strip(tok)
    if tok in ("RZ", "URZ"):
        return 0
    if re.fullmatch(r"-?(0x[0-9a-f]+|\d+)", tok):
        return int(tok, 0) & _MASK32
    m = _CBANK.fullmatch(tok)
    if m:
        return consts.get(int(m[1], 16))
    return regs.get(tok)


def _bool(tok: str, preds: dict):
    """The known value of a predicate operand (!P0, PT, ...), or None."""
    tok = _strip(tok)
    neg = tok.startswith("!")
    name = tok.lstrip("!")
    v = True if name in ("PT", "UPT") else preds.get(name)
    return None if v is None else v != neg


def _lop3(a: int, b: int, c: int, lut: int) -> int:
    out = 0
    for k in range(8):
        if lut >> k & 1:
            out |= ((a if k & 4 else ~a) & (b if k & 2 else ~b) & (c if k & 1 else ~c))
    return out & _MASK32


def _compare(cond: str, a: int, b: int, unsigned: bool) -> bool:
    if not unsigned:
        a, b = (x - (1 << 32) if x >> 31 else x for x in (a, b))
    return {"EQ": a == b, "NE": a != b, "LT": a < b, "LE": a <= b, "GT": a > b,
            "GE": a >= b}[cond]


def _execute(x: Ins, regs: dict, preds: dict, consts: dict) -> None:
    """The effect of one executed instruction on the known values: computed
    where its inputs are known, else its destinations become unknown."""
    op, args = x.op, x.args
    parts = op.split(".")
    known = {}  # destination -> value, None for unknown
    if parts[0] in ("LDC", "ULDC") and len(args) == 2:
        m = _CBANK.fullmatch(_strip(args[1]))
        off = int(m[1], 16) if m else None
        known[_strip(args[0])] = consts.get(off) if m else None
        if ".64" in op:
            nxt = re.sub(r"\d+$", lambda d: str(int(d[0]) + 1), _strip(args[0]))
            known[nxt] = consts.get(off + 4) if m else None
    elif parts[0] in ("MOV", "UMOV") and len(args) >= 2:
        known[_strip(args[0])] = _int(args[1], regs, consts)
    elif parts[0] in ("LOP3", "ULOP3") and len(args) >= 6:
        pd = _strip(args[0]) if _strip(args[0]).startswith(("P", "UP")) else None
        rest = args[1:] if pd else args
        vals = [_int(t, regs, consts) for t in rest[1:5]]
        res = None if None in vals else _lop3(*vals)
        known[_strip(rest[0])] = res
        if pd:  # P = (result != 0) when the predicate input is !PT
            plain = len(rest) > 5 and _bool(rest[5], preds) is False
            known[pd] = res != 0 if res is not None and plain else None
    elif parts[0] in ("ISETP", "UISETP") and "EX" not in parts and len(args) == 5:
        bop = parts[-1]
        a, b = (_int(t, regs, consts) for t in args[2:4])
        c = _bool(args[4], preds)
        cmp = None if a is None or b is None else _compare(parts[1], a, b, "U32" in parts)
        for dest, v in ((args[0], cmp), (args[1], None if cmp is None else not cmp)):
            known[_strip(dest)] = (None if v is None or c is None
                                   else {"AND": v and c, "OR": v or c, "XOR": v != c}[bop])
    else:
        for t in args[:2]:
            t = _strip(t)
            if re.fullmatch(r"U?[RP]\d+", t):
                known[t] = None
        if (".64" in op or "WIDE" in op) and args and re.fullmatch(r"U?R\d+", _strip(args[0])):
            known[re.sub(r"\d+$", lambda d: str(int(d[0]) + 1), _strip(args[0]))] = None
    for dest, v in known.items():
        if dest in ("RZ", "URZ", "PT", "UPT"):
            continue
        table = preds if re.fullmatch(r"U?P\d+", dest) else regs
        if v is None:
            table.pop(dest, None)
        else:
            table[dest] = v


def walk_step(ins: list, consts: dict | None = None) -> dict:
    """One step of the loop that a launch with the parameters `consts`
    ({constant-bank offset: 32-bit value}) runs, along its common path.
    The walk starts at the kernel's entry and resolves every branch whose
    predicate the known parameters decide. Any other conditional branch:
    a back edge is the loop's (the first one reached of a loop at least
    half the size of the kernel's largest; a smaller loop on the way, such
    as a search before the loop, runs once); a forward branch out of the
    loop, or over code that holds a loop (a loop exit, the zero-steps
    case), is not taken; one over a slow path (CALL, EXIT, RET, or a
    branch out of the loop) is taken; any other is not. The step is
    counted from the loop's head to its back edge on the walk's second
    pass, so it holds every flag test, move and branch the launch issues a
    step (an unrolled loop's pass holds several steps). Returns {} for a
    kernel with no loop."""
    consts = consts or {}
    index = {x.addr: k for k, x in enumerate(ins)}
    spans = [x.addr - x.target for x in ins if _is_jump(x) and x.target <= x.addr]
    if not spans:
        return {}
    min_span = max(spans) / 2
    regs, preds = {}, {}
    head = tail = None
    k, n, mufu, seen = 0, 0, 0, 0

    def back_edge(x):
        return _is_jump(x) and x.target <= x.addr

    def cold(k0, k1):
        for y in ins[k0:k1]:
            if y.op.startswith(("CALL", "EXIT", "RET")):
                return True
            if head is not None and _is_jump(y) and not head <= y.target <= tail:
                return True
        return False

    while seen < 1_000_000:
        seen += 1
        x = ins[k]
        if head is not None:
            n += 1
            mufu += x.op.startswith("MUFU")
        guard = True if x.pred in (None, "@PT") else _bool(x.pred[1:], preds)
        if _is_jump(x):
            if guard is None:
                if back_edge(x):
                    if head is None and x.addr - x.target >= min_span:
                        head, tail = x.target, x.addr  # the loop: count its next pass
                        k = index[head]
                        continue
                    if x.addr == tail:
                        break
                    guard = False  # a smaller loop on the way runs once
                elif head is not None and not head <= x.target <= tail:
                    guard = False  # a loop exit
                else:
                    skipped = range(k + 1, index[x.target])
                    guard = (not any(back_edge(ins[j]) for j in skipped)
                             and cold(k + 1, index[x.target]))
            if x.addr == tail and guard:
                break
            if guard:
                k = index[x.target]
                continue
        elif x.op.startswith(("EXIT", "RET")) and guard:
            raise RuntimeError(f"the route left the kernel at {x.addr:#x} before a step")
        elif not x.op.startswith(("BRA", "CALL", "EXIT", "RET")) and guard is not False:
            if guard is None:  # it may or may not run: its destinations become unknown
                _execute(Ins(x.addr, None, "?", None, x.args), regs, preds, {})
            else:
                _execute(x, regs, preds, consts)
        k += 1
    else:
        raise RuntimeError("the route found no loop step")
    region = [x for x in ins if head <= x.addr <= tail]
    return {"step_instructions": n, "step_mufu": mufu, "loop_instructions": len(region),
            "loop_mufu": sum(x.op.startswith("MUFU") for x in region)}


def kernel_tag(name: str):
    """(kernel, fast, integrator, ks, fixed flags or None) of a mangled
    render_mono_kernel / trace_planes_kernel instantiation, else None."""
    m = re.search(r"(render_mono|trace_planes)_kernelILb([01])ELi([0-2])ELb([01])E"
                  r"(?:Li(n?\d+)E)?", name)
    if not m:
        return None
    fixed = None if m[5] is None or m[5].startswith("n") else int(m[5])
    return m[1], m[2] == "1", INTEGRATORS[int(m[3])], m[4] == "1", fixed


def tag_text(tag) -> str:
    kernel, fast, integ, ks, fixed = tag
    return (f"{kernel}<{'fast' if fast else 'exact'},{integ}{',ks' if ks else ''}"
            f"{'' if fixed is None else f',flags={fixed}'}>")


def launched_function(funcs: dict, kernel: str, fast: bool, integ: str, flags: int):
    """(name, tag) of the instantiation a launch of these arguments runs: the
    one with its flags fixed at `flags` where the build has it (the C
    entries launch one for an Euler frame with no flag set, render_mono.cu
    one for a fast Euler Kerr-Schild frame with the disk alone, and
    trace_planes.cu one for an exact rk4 frame with adaptive dt and the disk
    alone and one for an exact Euler Kerr-Schild frame with the disk alone),
    else the one that reads them at run time."""
    ks = bool(flags & FLAG_KS)
    found = {}
    for name in funcs:
        tag = kernel_tag(name)
        if tag and tag[:4] == (kernel, fast, integ, ks) and tag[4] in (None, flags):
            found[tag[4]] = (name, tag)
    return found.get(flags) or found.get(None)


def route_step(funcs: dict, kernel: str, fast: bool, integ: str, flags: int) -> dict:
    """The walked step of the loop a launch of `kernel` with these arguments
    runs, with the instantiation's name (tag)."""
    hit = launched_function(funcs, kernel, fast, integ, flags)
    if hit is None:
        return {}
    name, tag = hit
    return {"function": tag_text(tag), **walk_step(funcs[name], {FLAGS_OFFSET[kernel]: flags})}


def function_hash(ins) -> str:
    """A function's SASS, its predicates, opcodes and operands in order, as
    16 hex digits: equal where two builds compiled the same code."""
    import hashlib

    text = "\n".join(f"{x.pred} {x.op} {x.args}" for x in ins)
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def sass_of(path, cuobjdump: str) -> str:
    """cuobjdump -sass of a cubin or of a shared library's embedded code."""
    return run([cuobjdump, "-sass", str(path)]).stdout


# ---- the issue floor ----------------------------------------------------------


def warp_steps(torch, steps) -> int:
    """Loop iterations summed over warps: a warp (2 rows x 16 columns of a
    16 x 16 block) steps while any of its rays does."""
    h, w = steps.shape
    pad = torch.zeros((-(-h // BLOCK[1]) * BLOCK[1], -(-w // BLOCK[0]) * BLOCK[0]),
                      dtype=torch.int64, device=steps.device)
    pad[:h, :w] = steps
    return int(pad.view(pad.shape[0] // 2, 2, pad.shape[1] // 16, 16).amax((1, 3)).sum().item())


def issue_floor_ms(step_instructions: int, warp_steps: int, sms: int, clock_mhz: float) -> float:
    """The least time of `warp_steps` loop steps of `step_instructions`
    SASS each at one warp instruction per scheduler per clock."""
    return step_instructions * warp_steps / (sms * SCHEDULERS * clock_mhz * 1e6) * 1e3


def sm_clock_under_load(launch, ms: float) -> str:
    """nvidia-smi's SM clock, maximum SM clock and power draw, read while
    about 0.6 s of launch() (each about `ms`) run, queued beforehand."""
    import torch

    for _ in range(int(600 / ms) + 1):
        launch()
    clocks = run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
                   "--format=csv,noheader,nounits"]).stdout.strip()
    torch.cuda.synchronize()
    return clocks
