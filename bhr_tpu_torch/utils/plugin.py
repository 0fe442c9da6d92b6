"""Runtime-swappable physics plugins, the reference's `--shader` analog
(PyTorch port of bhr_tpu/utils/plugin.py; reference: src/lib.rs:425-429,
src/main.rs:30).

A plugin is a Python file (or a module, or a callable) defining an
acceleration in component-plane form:

    def acceleration(rel, vel, r, r2, rs, spin):
        '''rel/vel: 3-tuples of same-shaped fp32 planes; r/r2/rs/spin
        broadcast over them. Returns (ax, ay, az).'''
        ...

    CAPTURE_FACTOR = 1.10   # optional: the capture radius in units of rs

bhr_tpu traces the one definition into its XLA oracle and its Pallas
kernel. The port does the same with it: the plain version
(ops/trace.custom_accel_arrays) calls it on torch tensors, and `record`
calls it once on recording operands, which turns its arithmetic into the
CUDA source of one `__device__` function that csrc/trace_planes.cu is
built with (ops/trace_kernel.trace_image; utils/build.load_trace_planes_custom).
`examples/plugins/paczynski_wiita.py` is such a plugin.

The kernel takes what a plugin computes with `+`, `-`, `*`, `/` and unary
`-` on its arguments and on Python numbers. Each operation becomes one
correctly rounded, never contracted fp32 operation (`__fadd_rn`,
`__fsub_rn`, `__fmul_rn`, `__fdiv_rn`), so the kernel is bit for bit the
plain version on the card in the exact tier. A Python number is taken at
its fp32 rounding, as PyTorch takes it, and its operations are PyTorch's
on a CUDA tensor: `x / c` is x times the fp32 reciprocal of c (PyTorch's
CUDA kernels multiply by the reciprocal of a host scalar divisor; its CPU
kernels divide, so a plugin that divides by a literal other than a power
of two gives the CPU an ulp more or less there), and `c / x` is
reciprocal(x) times c (PyTorch's `__rtruediv__`, on either device). Any
other use of an argument -- a torch or numpy function, a comparison,
`**`, `abs`, a method, Python control flow on its value -- raises a
ValueError naming it: such a plugin renders with the plain version on a
CPU device only.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import pathlib
import re

import numpy as np

from ..core.scene import CAPTURE_FACTOR
from . import tracing


def load_plugin(source):
    """Resolve a physics plugin to (accel_fn, capture_factor).

    `source` may be a callable (used directly; optional `capture_factor`
    attribute), a module-like object with an `acceleration` function, or a
    path to a Python file defining one. File loads are cached by resolved
    path, so repeated renderer constructions reuse one function object
    (and one kernel build: utils/build keys the build by the recorded
    source).
    """
    if callable(source) and not hasattr(source, "acceleration"):
        return source, float(getattr(source, "capture_factor", CAPTURE_FACTOR))
    if hasattr(source, "acceleration"):
        mod = source
    else:
        mod = _load_module(str(pathlib.Path(source).resolve()))
    accel = getattr(mod, "acceleration", None)
    if not callable(accel):
        raise ValueError(
            f"physics plugin {source!r} must define acceleration(rel, vel, "
            "r, r2, rs, spin) -> (ax, ay, az) on component-plane tuples"
        )
    return accel, float(getattr(mod, "CAPTURE_FACTOR", CAPTURE_FACTOR))


@functools.lru_cache(maxsize=32)
def _load_module(resolved_path: str):
    path = pathlib.Path(resolved_path)
    if not path.exists():
        raise FileNotFoundError(f"physics plugin not found: {resolved_path}")
    spec = importlib.util.spec_from_file_location(f"bhr_plugin_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---- recording a plugin into CUDA source --------------------------------------

INPUTS = ("rel.x", "rel.y", "rel.z", "vel.x", "vel.y", "vel.z", "r", "r2", "rs", "spin")
# inputs that do not vary over a launch (the scene's): an operation on these
# and on constants alone is a constant of the launch
_LAUNCH_CONSTANTS = ("rs", "spin")
_CUDA_OP = {"add": "__fadd_rn", "sub": "__fsub_rn", "mul": "__fmul_rn", "div": "__fdiv_rn"}
_TAKES = ("the kernel takes +, -, * and / on the arguments and Python numbers, and unary -; "
          "render this plugin with the plain version on a CPU device")


@dataclasses.dataclass(frozen=True)
class Program:
    """A recorded plugin: `ops` are SSA lines (dst, op, a, b) with op one of
    add, sub, mul, div (b an operand) or neg (b None); an operand is an
    input name of INPUTS, an earlier dst, or an fp32 constant (a
    np.float32). `outputs` are the three operands returned."""

    ops: tuple
    outputs: tuple
    name: str

    def reads(self) -> set:
        """The input names the program reads."""
        used = {x for _, _, a, b in self.ops for x in (a, b)} | set(self.outputs)
        return {x for x in INPUTS if x in used}

    @property
    def varying_ops(self) -> int:
        """The plugin's part of a ray-step's fp32 operations in the kernel:
        its operations whose value varies from ray to ray (the others
        depend on the launch's constants alone), and the r * r that forms
        r2 where it reads r2."""
        const = set(_LAUNCH_CONSTANTS)
        n = int("r2" in self.reads())
        for dst, _, a, b in self.ops:
            if all(isinstance(x, np.float32) or x in const for x in (a, b) if x is not None):
                const.add(dst)
            else:
                n += 1
        return n

    def cuda_source(self) -> str:
        """The header trace_planes.cu is built with: BHR_CUSTOM_ACCEL and
        `plugin_acceleration`, one line a recorded operation."""
        def operand(x):
            if isinstance(x, np.float32):
                bits = int(np.asarray(x).view(np.uint32))
                return f"__int_as_float(0x{bits:08x})"
            return x.replace(".", "_")

        lines = [
            f"// Generated by bhr_tpu_torch/utils/plugin.py from the physics plugin {self.name};",
            "// compiled into csrc/trace_planes.cu as its acceleration (-include).",
            "#pragma once",
            '#include "common.cuh"',
            "#define BHR_CUSTOM_ACCEL 1",
            "namespace bhr {",
            "__device__ __forceinline__ Vec3 plugin_acceleration(Vec3 rel, Vec3 vel, float r, "
            "float r2, float rs, float spin) {",
        ]
        lines += [f"  const float {operand(x)} = {x};" for x in sorted(self.reads()) if "." in x]
        for dst, op, a, b in self.ops:
            expr = (f"-{operand(a)}" if op == "neg"
                    else f"{_CUDA_OP[op]}({operand(a)}, {operand(b)})")
            lines.append(f"  const float {dst} = {expr};")
        lines.append(f"  return {{{', '.join(operand(x) for x in self.outputs)}}};")
        lines += ["}", "}  // namespace bhr", ""]
        return "\n".join(lines)


class _Operand:
    """A recording stand-in for one plane of a plugin's arguments."""

    __slots__ = ("name", "_tape")

    def __init__(self, name, tape):
        self.name = name
        self._tape = tape

    def _emit(self, op, a, b=None):
        dst = f"t{len(self._tape)}"
        self._tape.append((dst, op, a, b))
        return _Operand(dst, self._tape)

    def _arg(self, other, what):
        if isinstance(other, _Operand):
            return other.name
        if isinstance(other, (int, float, np.floating, np.integer)) and not isinstance(other, bool):
            return np.float32(other)
        raise ValueError(f"physics plugin: {what} with a {type(other).__name__}; {_TAKES}")

    def __add__(self, other):
        return self._emit("add", self.name, self._arg(other, "+"))

    def __radd__(self, other):
        return self._emit("add", self._arg(other, "+"), self.name)

    def __sub__(self, other):
        return self._emit("sub", self.name, self._arg(other, "-"))

    def __rsub__(self, other):
        return self._emit("sub", self._arg(other, "-"), self.name)

    def __mul__(self, other):
        return self._emit("mul", self.name, self._arg(other, "*"))

    def __rmul__(self, other):
        return self._emit("mul", self._arg(other, "*"), self.name)

    def __truediv__(self, other):
        b = self._arg(other, "/")
        if isinstance(b, np.float32):  # PyTorch on CUDA: times the fp32 reciprocal
            return self._emit("mul", self.name, np.float32(1.0) / b)
        return self._emit("div", self.name, b)

    def __rtruediv__(self, other):  # PyTorch: reciprocal(x) * c
        c = self._arg(other, "/")
        rcp = self._emit("div", np.float32(1.0), self.name)
        return rcp._emit("mul", rcp.name, c)

    def __neg__(self):
        return self._emit("neg", self.name)

    def __pos__(self):
        return self

    def _refuse(self, what):
        raise ValueError(f"physics plugin: {what} on an argument; {_TAKES}")

    def __pow__(self, other):
        self._refuse("**")

    __rpow__ = __pow__

    def __abs__(self):
        self._refuse("abs()")

    def __bool__(self):
        self._refuse("Python control flow on a value (bool())")

    def __float__(self):
        self._refuse("float()")

    def __lt__(self, other):
        self._refuse("a comparison")

    __le__ = __gt__ = __ge__ = __eq__ = __ne__ = __lt__
    __hash__ = object.__hash__

    def __floordiv__(self, other):
        self._refuse("//")

    __rfloordiv__ = __mod__ = __rmod__ = __floordiv__

    def __getattr__(self, name):
        if re.fullmatch(r"__\w+__", name):  # a protocol probe (numpy's, copy's): not ours
            raise AttributeError(name)
        self._refuse(f"the attribute or method .{name}")

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        self._refuse(f"the numpy function {ufunc.__name__}")

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        raise ValueError(f"physics plugin: the torch function {getattr(func, '__name__', func)} "
                         f"on an argument; {_TAKES}")


def record(accel, name: str | None = None) -> Program:
    """Call the plugin `accel` once on recording operands -> its Program.
    Raises ValueError for an operation the kernel does not take. Each
    recording counts in tracing.COUNTS["plugin.records"]; the renderer and
    the kernel's wrapper take a plugin's through `program`, once."""
    tape = []
    x = {n: _Operand(n, tape) for n in INPUTS}
    out = accel((x["rel.x"], x["rel.y"], x["rel.z"]), (x["vel.x"], x["vel.y"], x["vel.z"]),
                x["r"], x["r2"], x["rs"], x["spin"])
    if not isinstance(out, (tuple, list)) or len(out) != 3:
        raise ValueError("physics plugin: acceleration must return (ax, ay, az)")
    outputs = []
    for v in out:
        if isinstance(v, _Operand):
            outputs.append(v.name)
        elif isinstance(v, (int, float, np.floating, np.integer)) and not isinstance(v, bool):
            outputs.append(np.float32(v))
        else:
            raise ValueError(f"physics plugin: returned a {type(v).__name__}; {_TAKES}")
    prog = Program(tuple(tape), tuple(outputs),
                   name or getattr(accel, "__module__", None) or repr(accel))
    tracing.COUNTS["plugin.records"] += 1
    return prog


@functools.lru_cache(maxsize=32)
def program(accel) -> Program:
    """`record(accel)`, once per plugin function."""
    return record(accel)


@functools.lru_cache(maxsize=32)
def cuda_source(accel) -> str:
    """`program(accel).cuda_source()`, once per plugin function."""
    return program(accel).cuda_source()
