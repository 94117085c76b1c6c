"""Stateless any-hit predicates compiled into the walks: the compiler from
``torch.fx`` to a CUDA device function that K1's and K2's predicate modes
include.

The JAX package inlines a traced ``pred(u, v, alpha) -> keep`` into its
walk's loop (``stateless_anyhit``; ``trace_packets(anyhit_pred=pred)``,
vortex_rt_tpu/ops/traverse_packet.py:723-761 and :1057-1085), and XLA
compiles it with the walk.  ``compile_predicate`` does the same for the
port's hand-written walks: it traces the predicate with
``torch.fx.symbolic_trace``, types every node with ``ShapeProp`` on
float32 samples (on the meta device: no values, so no data-dependent
error), and emits one function,

    __device__ __forceinline__ bool vrt_pred(float u, float v, float alpha)

as a header (``CompiledPredicate.text``) whose file name carries a hash of
its text.  ``runtime/kernels.load_pred`` builds K1's or K2's source with
``-DVRT_PRED_HEADER`` naming it; the walk calls it on every candidate that
passes Moller-Trumbore, with the (u, v, alpha) that
``csrc/alpha_test.cuh::vrt_candidate_surface`` computes.

Exact ops are emitted to give torch's CPU float32 result to the bit (the
header is built without FMA contraction), as tensor methods, ``torch.*``
functions and operators:

- ``+ - *`` (``add``, ``sub``, ``mul`` without ``alpha``), unary ``-``
  and ``square`` (integers wrap, as torch's do); ``/`` (``div``,
  ``true_divide``) and ``reciprocal`` as a correctly rounded
  ``__fdiv_rn``, never a multiply by the reciprocal (ROADMAP hazard H6:
  torch on a card multiplies by the reciprocal of a Python-scalar
  divisor, so a plain walk on the card may differ there);
  ``div(rounding_mode="trunc" | "floor")``;
- ``abs``, ``sign``, ``floor``, ``ceil``, ``trunc``, ``frac``,
  ``torch.round`` (half to even, ``rintf``); ``%`` and ``//``
  (``torch.remainder``, ``torch.floor_divide``) with torch's floored
  formulas on integers and floats (C's ``%`` truncates, hazard H10);
  ``fmod`` (truncated), ``copysign``;
- ``minimum``, ``maximum`` and ``clamp`` (a NaN operand gives NaN),
  ``where``;
- the six comparisons, ``isnan``, ``isinf``, ``isfinite``, ``signbit``;
  ``& | ^ ~`` and the ``bitwise_*`` functions, ``<<`` and ``>>`` on
  integers (a count past the width gives torch's result: 0 to the
  left, the sign to the right), ``logical_and``, ``logical_or``,
  ``logical_xor``, ``logical_not``;
- ``.to(dtype)``, ``.int()``, ``.long()``, ``.float()`` and ``.bool()``
  to int32, int64, float32 and bool (a float is truncated to an integer;
  NaN and values out of range give the type's minimum, as x86 does).

Correctly rounded ops (ROADMAP hazard H23): ``sqrt``, ``rsqrt``, the
trigonometric, hyperbolic, exponential and logarithmic functions and
their inverses, ``pow`` (``**``) on floats, ``sigmoid``, ``erf``,
``erfc``, ``atan2`` and ``hypot`` (``_CORRECTLY_ROUNDED``).  torch's CPU
float32 results for these are not correctly rounded (hazards H5, H14),
so no CUDA function could match them on every input; each means instead
the float32 rounding of its float64 evaluation on the float32 operands
(integer operands promote to float32 first, as torch promotes them):
``__fsqrt_rn`` for ``sqrt`` (exact), ``__double2float_rn(f((double)x,
...))`` with the CUDA math library's double ``f`` for the others,
``rsqrt`` as ``1/sqrt(x)`` and ``sigmoid`` as ``1/(1 + exp(-x))`` in
float64.  ``pow`` on integers is exact (torch's ``powi``, wrapping).

An operation's compute type is the node's type, and a comparison's is
``torch.result_type`` of its operands; Python scalars follow torch's
promotion (a Python float against float32 or integer operands rounds to
float32) and are emitted as exact hex literals, as is a captured 0-dim
tensor of a supported type (it promotes as torch promotes a 0-dim
tensor).  Refused, each with a ``NotImplementedError`` that names it:
any other op (non-elementwise ones such as ``cumsum``, random ones such
as ``rand_like``), a captured tensor of any other shape, a
value-dependent Python branch (fx cannot trace it) and a result that is
not a bool of the inputs' shape.

The plain version of a compiled predicate (``CompiledPredicate.plain``,
which the plain walks and the suspension shader call on tensors) is the
traced graph with each correctly rounded op replaced by its float64 form
rounded once to float32, in the kernel's order, every operand a full
tensor (so torch takes none of its Python-scalar shortcuts, such as
``x**2`` as ``x*x``).  The kernel and the plain version on a card call
the same CUDA math library function; on the CPU, torch's float64
kernels and the host C library are within about a double ulp, so they
round to different floats only where a float32 rounding midpoint falls
between them (about 1 input in 10^8).  ``CompiledPredicate.fn`` stays
the user's callable.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import operator
import os
import tempfile
import weakref
from pathlib import Path
from typing import Callable, Dict, Tuple

import numpy as np
import torch

_CTYPE = {torch.float32: "float", torch.int32: "int",
          torch.int64: "long long", torch.bool: "bool"}
_UTYPE = {torch.int32: "unsigned int", torch.int64: "unsigned long long"}
_CAST_METHODS = {"int": torch.int32, "long": torch.int64,
                 "float": torch.float32, "bool": torch.bool}

# the correctly rounded ops: kind -> the CUDA math library's double
# function (and its arity); rsqrt and sigmoid are formulas of sqrt and exp
_CORRECTLY_ROUNDED = {
    "sqrt": ("sqrt", 1), "rsqrt": ("sqrt", 1), "sin": ("sin", 1),
    "cos": ("cos", 1), "tan": ("tan", 1), "asin": ("asin", 1),
    "acos": ("acos", 1), "atan": ("atan", 1), "sinh": ("sinh", 1),
    "cosh": ("cosh", 1), "tanh": ("tanh", 1), "asinh": ("asinh", 1),
    "acosh": ("acosh", 1), "atanh": ("atanh", 1), "exp": ("exp", 1),
    "exp2": ("exp2", 1), "expm1": ("expm1", 1), "log": ("log", 1),
    "log2": ("log2", 1), "log10": ("log10", 1), "log1p": ("log1p", 1),
    "sigmoid": ("exp", 1), "erf": ("erf", 1), "erfc": ("erfc", 1),
    "atan2": ("atan2", 2), "hypot": ("hypot", 2), "pow": ("pow", 2),
}
_ALIASES = {"arcsin": "asin", "arccos": "acos", "arctan": "atan",
            "arctan2": "atan2", "arcsinh": "asinh", "arccosh": "acosh",
            "arctanh": "atanh", "absolute": "abs", "negative": "neg",
            "clip": "clamp", "fix": "trunc", "subtract": "sub",
            "multiply": "mul", "divide": "div", "true_divide": "div",
            "less": "lt", "less_equal": "le", "greater": "gt",
            "greater_equal": "ge", "not_equal": "ne", "remainder": "mod",
            "floor_divide": "floordiv", "bitwise_and": "and",
            "bitwise_or": "or", "bitwise_xor": "xor",
            "bitwise_not": "invert", "bitwise_left_shift": "lshift",
            "bitwise_right_shift": "rshift", "expit": "sigmoid"}
_EXACT = ("neg", "abs", "floor", "ceil", "trunc", "round", "minimum",
          "maximum", "clamp", "clamp_min", "clamp_max", "where",
          "logical_and", "logical_or", "logical_xor", "logical_not", "add",
          "sub", "mul", "div", "lt", "le", "gt", "ge", "eq", "ne", "square",
          "reciprocal", "sign", "frac", "fmod", "copysign", "isnan", "isinf",
          "isfinite", "signbit")
# tensor methods and torch functions of these names (and aliases) -> kind
_METHODS = {**{k: k for k in (*_EXACT, *_CORRECTLY_ROUNDED)
               if k != "where"}, **_ALIASES, "to": "to",
            **{k: "to" for k in _CAST_METHODS}}
_FUNCTIONS = {
    operator.add: "add", operator.sub: "sub", operator.mul: "mul",
    operator.truediv: "div", operator.floordiv: "floordiv",
    operator.mod: "mod", operator.neg: "neg", operator.abs: "abs",
    operator.lt: "lt", operator.le: "le", operator.gt: "gt",
    operator.ge: "ge", operator.eq: "eq", operator.ne: "ne",
    operator.and_: "and", operator.or_: "or", operator.xor: "xor",
    operator.invert: "invert", operator.lshift: "lshift",
    operator.rshift: "rshift", operator.pow: "pow",
    torch.where: "where",
    **{getattr(torch, k): v for k, v in _METHODS.items()
       if v != "to" and callable(getattr(torch, k, None))},
    **{getattr(torch.special, k): _ALIASES.get(k, k)
       for k in ("expit", "erf", "erfc", "expm1", "exp2", "log1p")},
}
_COMPARE = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=", "eq": "==",
            "ne": "!="}
_LOGICAL = {"logical_and": "&&", "logical_or": "||", "logical_xor": "!="}
_INF = "__int_as_float(0x7f800000)"

# Helpers the emitted function may call.  Their formulas are torch's CPU
# kernels' (c10 div_floor_floating / div_floor_integer, the remainder
# kernel's fmod form, maximum's NaN propagation, x86's conversion of an
# out-of-range float, the integer div_trunc, fmod, shift and pow
# kernels), so the kernel decides as the user's callable does.
_HELPERS = r"""
__device__ __forceinline__ float vrt_p_fmax(float a, float b) {
    return (a != a) ? a : (b != b) ? b : (a > b ? a : b);
}
__device__ __forceinline__ float vrt_p_fmin(float a, float b) {
    return (a != a) ? a : (b != b) ? b : (a < b ? a : b);
}
template <typename T>
__device__ __forceinline__ T vrt_p_max(T a, T b) { return a > b ? a : b; }
template <typename T>
__device__ __forceinline__ T vrt_p_min(T a, T b) { return a < b ? a : b; }
__device__ __forceinline__ float vrt_p_fmod(float a, float b) {
    float m = fmodf(a, b);
    if ((m != 0.0f) && ((b < 0.0f) != (m < 0.0f))) m += b;
    return m;
}
__device__ __forceinline__ float vrt_p_ffloordiv(float a, float b) {
    if (b == 0.0f) return __fdiv_rn(a, b);
    const float m = fmodf(a, b);
    float q = __fdiv_rn(a - m, b);
    if ((m != 0.0f) && ((b < 0.0f) != (m < 0.0f))) q -= 1.0f;
    if (q == 0.0f) return copysignf(0.0f, __fdiv_rn(a, b));
    float f = floorf(q);
    if (q - f > 0.5f) f += 1.0f;
    return f;
}
// (torch raises on an integer division by zero; the kernel gives 0)
template <typename T>
__device__ __forceinline__ T vrt_p_imod(T a, T b) {
    if (b == 0 || b == -1) return 0;
    T r = a % b;
    if ((r != 0) && ((r < 0) != (b < 0))) r += b;
    return r;
}
template <typename T, typename U>
__device__ __forceinline__ T vrt_p_ifloordiv(T a, T b) {
    if (b == 0) return 0;
    if (b == -1) return (T)((U)0 - (U)a);
    const T q = a / b;
    return ((a % b) != 0 && ((a < 0) != (b < 0))) ? (T)(q - 1) : q;
}
template <typename T, typename U>
__device__ __forceinline__ T vrt_p_iabs(T a) {
    return a < 0 ? (T)((U)0 - (U)a) : a;
}
__device__ __forceinline__ int vrt_p_f2i(float x) {
    return (x >= -2147483648.0f && x < 2147483648.0f) ? (int)x
                                                       : (-2147483647 - 1);
}
__device__ __forceinline__ long long vrt_p_f2l(float x) {
    return (x >= -9223372036854775808.0f && x < 9223372036854775808.0f)
        ? (long long)x : (-9223372036854775807LL - 1);
}
// torch's div_trunc and fmod on integers (they raise on a zero divisor;
// the kernel gives 0) and its shifts: a count below 0 or past the width
// gives 0 to the left and the sign to the right (lshift_kernel,
// rshift_kernel)
template <typename T, typename U>
__device__ __forceinline__ T vrt_p_idiv(T a, T b) {
    if (b == 0) return 0;
    return b == -1 ? (T)((U)0 - (U)a) : (T)(a / b);
}
template <typename T>
__device__ __forceinline__ T vrt_p_ifmod(T a, T b) {
    return (b == 0 || b == -1) ? (T)0 : (T)(a % b);
}
template <typename T, typename U>
__device__ __forceinline__ T vrt_p_shl(T a, T b) {
    return (b < 0 || b >= (T)(8 * sizeof(T))) ? (T)0 : (T)((U)a << b);
}
template <typename T>
__device__ __forceinline__ T vrt_p_shr(T a, T b) {
    const T top = (T)(8 * sizeof(T) - 1);
    return (b < 0 || b >= top) ? (T)(a >> top) : (T)(a >> b);
}
// torch's powi on integers: wrapping products; a negative exponent gives
// 0 but for a base of 1 or -1
template <typename T, typename U>
__device__ __forceinline__ T vrt_p_ipow(T a, T b) {
    if (b < 0) return a == 1 ? (T)1 : a == -1 ? (T)((b % 2) ? -1 : 1) : (T)0;
    U r = 1, x = (U)a;
    while (b) {
        if (b & 1) r *= x;
        b /= 2;
        x *= x;
    }
    return (T)r;
}
"""


@dataclasses.dataclass(frozen=True, eq=False)
class CompiledPredicate:
    """A predicate compiled for the walks' predicate modes.

    ``fn`` is the user's callable, ``plain`` the plain version (the
    traced graph with the correctly rounded ops in float64, rounded
    once; the module docstring), ``text`` the header that defines
    ``vrt_pred``, ``digest`` a hash of the text (the header's name and
    part of its kernels' build key) and ``ops`` the kinds of the emitted
    function's operations in graph order."""

    fn: Callable
    plain: Callable
    text: str
    digest: str
    ops: Tuple[str, ...]

    @property
    def n_ops(self) -> int:
        """The emitted function's operations, one a node of the graph
        (``tools/walk_bounds.pred_ops`` weighs each correctly rounded one
        by its instruction count)."""
        return len(self.ops)

    @property
    def exact(self) -> bool:
        """No correctly rounded op: the kernel gives the user's callable's
        torch CPU result to the bit."""
        return not any(k in _CORRECTLY_ROUNDED for k in self.ops)

    @property
    def header_name(self) -> str:
        return f"vrt_pred_{self.digest}.cuh"

    def write(self, directory: Path) -> Path:
        """The header written into ``directory`` (once: its name is its
        hash), whole or not at all: each writer writes its own temporary
        file and renames it over the header, so writers at once (K1's and
        K2's builds, ranks) never see a part of it."""
        directory = Path(directory)
        path = directory / self.header_name
        if not path.exists():
            directory.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=directory, prefix=path.name,
                                       suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                f.write(self.text)
            os.replace(tmp, path)
        return path


_compiled: "weakref.WeakKeyDictionary[Callable, CompiledPredicate]" = \
    weakref.WeakKeyDictionary()


def compile_predicate(pred) -> CompiledPredicate:
    """``pred(u, v, alpha) -> keep`` compiled (once per callable); a
    ``CompiledPredicate`` is returned as it is.  Raises
    ``NotImplementedError`` naming what the compiler refuses."""
    if isinstance(pred, CompiledPredicate):
        return pred
    try:
        hit = _compiled.get(pred)
    except TypeError:  # (not weakly referable: compiled every call)
        return _compile(pred)
    if hit is None:
        hit = _compiled[pred] = _compile(pred)
    return hit


def _refuse(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"stateless any-hit predicate: {what} is outside the op set the "
        f"walks compile (ops/anyhit_pred.py)")


def _op_name(node) -> str:
    t = node.target
    return t if isinstance(t, str) else getattr(t, "__name__", str(t))


def _kind(node) -> str:
    """The op kind of a call node, or "" for a call outside the set."""
    if node.op == "call_function":
        return _FUNCTIONS.get(node.target, "")
    if node.op == "call_method":
        return _METHODS.get(node.target, "")
    return ""


def _trace(pred):
    import torch.fx
    from torch.fx.passes.shape_prop import ShapeProp

    try:
        gm = torch.fx.symbolic_trace(pred)
    except torch.fx.proxy.TraceError as e:
        raise _refuse(f"a value-dependent Python branch ({e})") from e
    except Exception as e:  # anything else fx cannot trace: report it
        raise _refuse(f"a call fx cannot trace ({type(e).__name__}: {e})"
                      ) from e
    nodes = list(gm.graph.nodes)
    holders = [n for n in nodes if n.op == "placeholder"]
    if len(holders) != 3:
        raise _refuse(f"a predicate of {len(holders)} arguments (it takes "
                      f"u, v, alpha)")
    for n in nodes:
        if n.op == "get_attr":
            t = getattr(gm, n.target, None)
            if not torch.is_tensor(t) or t.dim() != 0 \
                    or t.dtype not in _CTYPE:
                raise _refuse(
                    f"a captured tensor ({n.target}: "
                    f"{tuple(t.shape) if torch.is_tensor(t) else t!r} "
                    f"{getattr(t, 'dtype', '')}; only a 0-dim float32, "
                    f"int32, int64 or bool tensor is a constant)")
        elif n.op == "call_module":
            raise _refuse(f"a module call ({n.target})")
        elif n.op in ("call_function", "call_method") and not _kind(n):
            raise _refuse(_op_name(n))
    samples = [torch.empty(8, dtype=torch.float32, device="meta")
               for _ in range(3)]
    try:
        ShapeProp(gm).propagate(*samples)
    except Exception as e:  # torch refused the types: name the op
        raise _refuse(f"an operand type ({type(e).__name__}: {e})") from e
    out = nodes[-1].args[0]
    meta = getattr(out, "meta", {}).get("tensor_meta")
    if meta is None or meta.dtype != torch.bool \
            or tuple(meta.shape) != (8,):
        raise _refuse(f"a result that is not a bool of the inputs' shape "
                      f"({meta.dtype if meta is not None else out!r})")
    return gm, holders


def _dtype(node) -> torch.dtype:
    dt = node.meta["tensor_meta"].dtype
    if dt not in _CTYPE:
        raise _refuse(f"the type {dt} (of {node.name})")
    return dt


def _zero_dim(a) -> bool:
    """A node whose value is 0-dim (a captured constant, or an operation
    on such constants alone): it promotes as a 0-dim tensor."""
    return isinstance(a, torch.fx.Node) \
        and tuple(a.meta["tensor_meta"].shape) == ()


def _hexf(x: float) -> str:
    f = float(np.float32(x))
    if math.isnan(f):
        return "__int_as_float(0x7fc00000)"
    if math.isinf(f):
        return f"__int_as_float({'0xff800000' if f < 0 else '0x7f800000'})"
    return f"{f.hex()}f"


def _literal(x, dt: torch.dtype) -> str:
    if dt == torch.float32:
        return _hexf(float(x))
    if dt == torch.bool:
        return "true" if bool(x) else "false"
    bits = 32 if dt == torch.int32 else 64
    v = int(x) & ((1 << bits) - 1)
    v = v - (1 << bits) if v >= 1 << (bits - 1) else v
    suffix = "" if bits == 32 else "LL"
    if v == -(1 << (bits - 1)):
        return f"(-{(1 << (bits - 1)) - 1}{suffix} - 1)"
    return f"{v}{suffix}" if v >= 0 else f"({v}{suffix})"


def _cast(expr: str, src: torch.dtype, dst: torch.dtype) -> str:
    """``expr`` of type ``src`` converted as torch converts to ``dst``."""
    if src == dst:
        return expr
    if dst == torch.bool:
        return f"({expr} != 0)"
    if src == torch.float32:
        return f"vrt_p_f2{'i' if dst == torch.int32 else 'l'}({expr})"
    return f"(({_CTYPE[dst]})({expr}))"


def _correctly_rounded(kind: str, ops) -> str:
    """The correctly rounded op ``kind`` on float32 operand expressions:
    its float64 evaluation rounded once to float32."""
    if kind == "sqrt":
        return f"__fsqrt_rn({ops[0]})"
    x = [f"(double)({o})" for o in ops]
    fn = _CORRECTLY_ROUNDED[kind][0]
    if kind == "rsqrt":
        expr = f"1.0 / sqrt({x[0]})"
    elif kind == "sigmoid":
        expr = f"1.0 / (1.0 + exp(-{x[0]}))"
    else:
        expr = f"{fn}({', '.join(x)})"
    return f"__double2float_rn({expr})"


def _compile(pred) -> CompiledPredicate:
    gm, holders = _trace(pred)
    env: Dict[str, Tuple[str, torch.dtype]] = {}
    for node, cname in zip(holders, ("u", "v", "alpha")):
        env[node.name] = (cname, torch.float32)
    lines, kinds, rounded = [], [], {}

    def operand(a, dt: torch.dtype) -> str:
        """Argument ``a`` (a node or a Python scalar) as type ``dt``."""
        if isinstance(a, torch.fx.Node):
            expr, src = env[a.name]
            return _cast(expr, src, dt)
        if isinstance(a, (bool, int, float)):
            return _literal(a, dt)
        raise _refuse(f"the argument {a!r}")

    def result_type(args) -> torch.dtype:
        """torch's promotion of the operands (nodes are (8,) tensors, or
        0-dim ones)."""
        ts = [torch.empty(() if _zero_dim(a) else 1, dtype=env[a.name][1])
              if isinstance(a, torch.fx.Node) else a for a in args]
        if not any(torch.is_tensor(t) for t in ts):
            raise _refuse("an operation on Python scalars alone")
        dt = (torch.result_type(ts[0], ts[1]) if len(ts) == 2
              else ts[0].dtype)
        if dt not in _CTYPE:
            raise _refuse(f"the type {dt}")
        return dt

    for node in gm.graph.nodes:
        if node.op in ("placeholder", "output"):
            continue
        if node.op == "get_attr":  # a captured 0-dim tensor: a literal
            t = getattr(gm, node.target)
            env[node.name] = (_literal(t.item(), t.dtype), t.dtype)
            continue
        name = _op_name(node)
        kind = _kind(node)
        out_dt = _dtype(node)
        args, kw = list(node.args), dict(node.kwargs)
        allowed = {"to": {"dtype"}, "clamp": {"min", "max"},
                   "clamp_min": {"min"}, "clamp_max": {"max"},
                   "div": {"rounding_mode"}}.get(kind, set())
        if set(kw) - allowed:
            raise _refuse(f"{name} with keyword arguments {kw}")
        ct, u_t = _CTYPE[out_dt], _UTYPE.get(out_dt)
        fl = out_dt == torch.float32
        integer = out_dt in (torch.int32, torch.int64)
        if kind == "pow" and not fl:
            if not integer:
                raise _refuse(f"{name} to {out_dt}")
            a, b = (operand(x, out_dt) for x in args)
            expr = f"vrt_p_ipow<{ct}, {u_t}>({a}, {b})"
            kind = "ipow"  # (exact)
        elif kind in _CORRECTLY_ROUNDED:
            if not fl or len(args) != _CORRECTLY_ROUNDED[kind][1]:
                raise _refuse(f"{name} of {len(args)} operands to {out_dt}")
            expr = _correctly_rounded(kind, [operand(x, out_dt)
                                             for x in args])
            rounded[node.name] = kind
        elif kind == "to":
            src = args[0]
            target = (_CAST_METHODS[name] if name in _CAST_METHODS
                      else kw.pop("dtype", args[1] if len(args) > 1 else None))
            if len(args) > (2 if name == "to" else 1) or kw \
                    or target not in _CTYPE:
                raise _refuse(f".{name}({', '.join(map(str, args[1:]))}"
                              f"{', ' if kw else ''}{kw or ''})")
            expr = _cast(*env[src.name], target)
        elif kind in ("add", "sub", "mul", "square"):
            if kind == "square":
                args = [args[0], args[0]]
            op = {"add": "+", "sub": "-"}.get(kind, "*")
            a, b = (operand(x, out_dt) for x in args)
            if out_dt == torch.bool:
                raise _refuse(f"{name} on bool operands")
            expr = (f"({a} {op} {b})" if fl else
                    f"(({ct})(({u_t})({a}) {op} ({u_t})({b})))")
        elif kind == "div" and kw.get("rounding_mode") is not None:
            mode = kw["rounding_mode"]
            a, b = (operand(x, out_dt) for x in args)
            if out_dt == torch.bool or mode not in ("trunc", "floor"):
                raise _refuse(f"{name} with rounding_mode={mode!r} to "
                              f"{out_dt}")
            expr = (f"truncf(__fdiv_rn({a}, {b}))" if fl and mode == "trunc"
                    else f"vrt_p_idiv<{ct}, {u_t}>({a}, {b})"
                    if mode == "trunc" else f"vrt_p_ffloordiv({a}, {b})"
                    if fl else f"vrt_p_ifloordiv<{ct}, {u_t}>({a}, {b})")
        elif kind in ("div", "reciprocal"):
            if not fl:
                raise _refuse(f"{name} to {out_dt}")
            if kind == "reciprocal":
                args = [1.0, args[0]]
            a, b = (operand(x, out_dt) for x in args)
            expr = f"__fdiv_rn({a}, {b})"
        elif kind in ("mod", "floordiv", "fmod"):
            a, b = (operand(x, out_dt) for x in args)
            if out_dt == torch.bool:
                raise _refuse(f"{name} on bool operands")
            if not fl and not isinstance(args[1], torch.fx.Node) \
                    and int(args[1]) == 0:
                raise _refuse(f"{name} by a constant integer 0 (torch "
                              f"raises)")
            expr = (f"fmodf({a}, {b})" if fl and kind == "fmod" else
                    f"vrt_p_f{kind}({a}, {b})" if fl else
                    f"vrt_p_ifmod<{ct}>({a}, {b})" if kind == "fmod" else
                    f"vrt_p_imod<{ct}>({a}, {b})" if kind == "mod" else
                    f"vrt_p_ifloordiv<{ct}, {u_t}>({a}, {b})")
        elif kind == "copysign":
            if not fl:
                raise _refuse(f"{name} to {out_dt}")
            a, b = (operand(x, out_dt) for x in args)
            expr = f"copysignf({a}, {b})"
        elif kind in ("lshift", "rshift"):
            if not integer:
                raise _refuse(f"{name} on {out_dt} operands")
            a, b = (operand(x, out_dt) for x in args)
            expr = (f"vrt_p_shl<{ct}, {u_t}>({a}, {b})" if kind == "lshift"
                    else f"vrt_p_shr<{ct}>({a}, {b})")
        elif kind == "neg":
            a = operand(args[0], out_dt)
            if out_dt == torch.bool:
                raise _refuse("neg on a bool operand")
            expr = f"(-{a})" if fl else f"(({ct})(({u_t})0 - ({u_t})({a})))"
        elif kind == "abs":
            a = operand(args[0], out_dt)
            expr = (f"fabsf({a})" if fl else a if out_dt == torch.bool
                    else f"vrt_p_iabs<{ct}, {u_t}>({a})")
        elif kind == "sign":
            a = operand(args[0], out_dt)
            expr = (a if out_dt == torch.bool else
                    f"(({ct})(({a} > 0) - ({a} < 0)))")
        elif kind in ("floor", "ceil", "trunc", "round", "frac"):
            if kw or len(args) > 1 or (kind == "frac" and not fl):
                raise _refuse(f"{name} with arguments {args[1:] or ''}"
                              f"{kw or ''} to {out_dt}")
            a = operand(args[0], out_dt)
            fn = {"floor": "floorf", "ceil": "ceilf", "trunc": "truncf",
                  "round": "rintf"}.get(kind)
            expr = (f"({a} - truncf({a}))" if kind == "frac" else
                    f"{fn}({a})" if fl else a)
        elif kind in ("isnan", "isinf", "isfinite", "signbit"):
            src = args[0]
            sdt = env[src.name][1] if isinstance(src, torch.fx.Node) \
                else None
            if sdt is None:
                raise _refuse(f"{name} of a Python scalar")
            a = env[src.name][0]
            if sdt == torch.float32:
                expr = {"isnan": f"({a} != {a})",
                        "isinf": f"(fabsf({a}) == {_INF})",
                        "isfinite": f"(fabsf({a}) < {_INF})",
                        "signbit": f"(copysignf(1.0f, {a}) < 0.0f)"}[kind]
            elif kind == "signbit" and sdt != torch.bool:
                expr = f"({a} < 0)"
            else:
                expr = "true" if kind == "isfinite" else "false"
        elif kind in ("minimum", "maximum", "clamp", "clamp_min",
                      "clamp_max"):
            mx = "vrt_p_fmax" if fl else f"vrt_p_max<{ct}>"
            mn = "vrt_p_fmin" if fl else f"vrt_p_min<{ct}>"
            if kind in ("minimum", "maximum"):
                a, b = (operand(x, out_dt) for x in args)
                expr = f"{mx if kind == 'maximum' else mn}({a}, {b})"
            else:
                names = {"clamp": ("min", "max"), "clamp_min": ("min",),
                         "clamp_max": ("max",)}[kind]
                bounds = dict(zip(names, args[1:]))
                bounds.update(kw)
                expr = operand(args[0], out_dt)
                if len(args) > len(names) + 1:
                    raise _refuse(f"{name} with {len(args)} operands")
                if bounds.get("min") is not None:
                    expr = f"{mx}({expr}, {operand(bounds['min'], out_dt)})"
                if bounds.get("max") is not None:
                    expr = f"{mn}({expr}, {operand(bounds['max'], out_dt)})"
        elif kind == "where":
            if len(args) != 3:
                raise _refuse("where without three operands")
            c, a, b = args
            if not isinstance(c, torch.fx.Node) \
                    or env[c.name][1] != torch.bool:
                raise _refuse("where with a condition that is not bool")
            expr = (f"({env[c.name][0]} ? {operand(a, out_dt)} : "
                    f"{operand(b, out_dt)})")
        elif kind in _COMPARE:
            dt = result_type(args)
            a, b = (operand(x, dt) for x in args)
            expr = f"({a} {_COMPARE[kind]} {b})"
        elif kind in ("and", "or", "xor"):
            a, b = (operand(x, out_dt) for x in args)
            if fl:
                raise _refuse(f"{name} on float operands")
            op = ({"and": "&&", "or": "||", "xor": "!="}
                  if out_dt == torch.bool else
                  {"and": "&", "or": "|", "xor": "^"})[kind]
            expr = f"({a} {op} {b})"
        elif kind == "invert":
            a = operand(args[0], out_dt)
            if fl:
                raise _refuse("~ on a float operand")
            expr = f"(!{a})" if out_dt == torch.bool else f"(({ct})~{a})"
        elif kind in ("logical_and", "logical_or", "logical_xor",
                      "logical_not"):
            ops = [_cast(env[x.name][0], env[x.name][1], torch.bool)
                   if isinstance(x, torch.fx.Node)
                   else _literal(x, torch.bool) for x in args]
            expr = (f"(!{ops[0]})" if kind == "logical_not" else
                    f"({ops[0]} {_LOGICAL[kind]} {ops[1]})")
        else:  # (every kind of the tables is handled above)
            raise _refuse(name)
        cname = f"p{len(lines)}"
        lines.append(f"    const {ct} {cname} = {expr};  // {node.name}")
        kinds.append(kind)
        env[node.name] = (cname, out_dt)
    out = list(gm.graph.nodes)[-1].args[0]
    body = "\n".join(lines)
    name = getattr(pred, "__qualname__", type(pred).__name__)
    text = (f"// vrt_pred: the stateless any-hit predicate {name}, compiled\n"
            f"// by vortex_rt_tpu_torch/ops/anyhit_pred.py ({len(lines)} "
            f"operations).\n#pragma once\n{_HELPERS}\n"
            f"__device__ __forceinline__ bool vrt_pred(float u, float v, "
            f"float alpha) {{\n    (void)u; (void)v; (void)alpha;\n"
            f"{body}\n    return {env[out.name][0]};\n}}\n")
    digest = hashlib.sha256(text.encode()).hexdigest()[:16]
    return CompiledPredicate(fn=pred, plain=_plain(gm, rounded), text=text,
                             digest=digest, ops=tuple(kinds))


def _plain(gm, rounded: Dict[str, str]):
    """The plain version: ``gm``'s graph with each correctly rounded node
    (``rounded``: name -> kind) replaced by its float64 evaluation on the
    float32 operands, rounded once to float32, in the kernel's order.
    Every operand is a full float64 tensor, so torch takes none of its
    shortcuts for a Python-scalar or 0-dim operand (``x**2`` as ``x*x``,
    ``x**0.5`` as ``sqrt``)."""
    import torch.fx

    g = torch.fx.Graph()
    env = {}
    f64 = torch.float64
    for node in gm.graph.nodes:
        kind = rounded.get(node.name)
        if kind is None:
            env[node] = g.node_copy(node, lambda n: env[n])
            continue
        full = [a for a in node.args
                if isinstance(a, torch.fx.Node) and not _zero_dim(a)]
        ops = []
        for a in node.args:
            if isinstance(a, torch.fx.Node):
                x = env[a]
                if a.meta["tensor_meta"].dtype != torch.float32:
                    x = g.call_method("to", (x, torch.float32))
                ops.append(g.call_method("to", (x, f64)))
            else:
                ops.append(float(np.float32(a)))
        ref = next((o for o, a in zip(ops, node.args) if a in full), ops[0])
        if full and len(ops) > 1:  # Python scalars and 0-dim tensors: full
            ops = [o if a in full else
                   g.call_function(torch.full_like, (ref, o))
                   if isinstance(o, float) else
                   g.call_function(torch.add, (g.call_function(
                       torch.zeros_like, (ref,)), o))
                   for o, a in zip(ops, node.args)]
        if kind == "rsqrt":
            x = g.call_function(torch.reciprocal, (g.call_function(
                torch.sqrt, (ops[0],)),))
        elif kind == "sigmoid":
            e = g.call_function(torch.exp, (g.call_function(
                torch.neg, (ops[0],)),))
            x = g.call_function(torch.reciprocal, (g.call_function(
                torch.add, (e, 1.0)),))
        else:
            x = g.call_function(getattr(torch, _CORRECTLY_ROUNDED[kind][0]),
                                tuple(ops))
        env[node] = g.call_method("to", (x, torch.float32))
    return torch.fx.GraphModule(gm, g)
