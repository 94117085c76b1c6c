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

The op set is closed, and each op is emitted to give torch's CPU result
to the bit (the header is built without FMA contraction):

- ``+ - *`` and unary ``-`` (integers wrap, as torch's do); ``/`` as a
  correctly rounded ``__fdiv_rn``, never a multiply by the reciprocal
  (ROADMAP hazard H6: torch on a card multiplies by the reciprocal of a
  Python-scalar divisor, so a plain walk on the card may differ there);
- ``abs``, ``floor``, ``ceil``, ``trunc``, ``torch.round`` (half to even,
  ``rintf``); ``%`` and ``//`` (``torch.remainder``,
  ``torch.floor_divide``) with torch's floored formulas on integers and
  floats (C's ``%`` truncates, hazard H10);
- ``minimum``, ``maximum`` and ``clamp`` (a NaN operand gives NaN),
  ``where``;
- the six comparisons, ``& | ^ ~``, ``logical_and``, ``logical_or``,
  ``logical_not``;
- ``.to(dtype)``, ``.int()``, ``.long()``, ``.float()`` and ``.bool()``
  to int32, int64, float32 and bool (a float is truncated to an integer;
  NaN and values out of range give the type's minimum, as x86 does).

An operation's compute type is the node's type, and a comparison's is
``torch.result_type`` of its operands; Python scalars follow torch's
promotion (a Python float against float32 or integer operands rounds to
float32) and are emitted as exact hex literals.  Refused, each with a
``NotImplementedError`` that names the op: ``sqrt`` and the
transcendentals (ROADMAP H5 and H14: torch's CPU results are not
correctly rounded, so the plain walk and the kernel would differ;
Queue 1 item 8c), any other op outside the set, a captured tensor, a
value-dependent Python branch (fx cannot trace it) and a result that is
not a bool of the inputs' shape.

The plain version of a compiled predicate is the user's callable itself
(``CompiledPredicate.fn``): the plain walks call it on tensors.
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

# the op set: fx targets (functions, and method names) -> the op's kind
_FUNCTIONS = {
    operator.add: "add", operator.sub: "sub", operator.mul: "mul",
    operator.truediv: "div", operator.floordiv: "floordiv",
    operator.mod: "mod", operator.neg: "neg", operator.abs: "abs",
    operator.lt: "lt", operator.le: "le", operator.gt: "gt",
    operator.ge: "ge", operator.eq: "eq", operator.ne: "ne",
    operator.and_: "and", operator.or_: "or", operator.xor: "xor",
    operator.invert: "invert",
    torch.neg: "neg", torch.abs: "abs", torch.floor: "floor",
    torch.ceil: "ceil", torch.trunc: "trunc", torch.round: "round",
    torch.remainder: "mod", torch.floor_divide: "floordiv",
    torch.minimum: "minimum", torch.maximum: "maximum",
    torch.clamp: "clamp", torch.clamp_min: "clamp_min",
    torch.clamp_max: "clamp_max", torch.where: "where",
    torch.logical_and: "logical_and", torch.logical_or: "logical_or",
    torch.logical_not: "logical_not",
}
_METHODS = {"neg", "abs", "floor", "ceil", "trunc", "round", "remainder",
            "floor_divide", "minimum", "maximum", "clamp", "clamp_min",
            "clamp_max", "logical_and", "logical_or", "logical_not", "to",
            *_CAST_METHODS}
_COMPARE = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=", "eq": "==",
            "ne": "!="}
_TRANSCENDENTAL = {"sqrt", "rsqrt", "sin", "cos", "tan", "asin", "acos",
                   "atan", "atan2", "sinh", "cosh", "tanh", "exp", "exp2",
                   "expm1", "log", "log2", "log10", "log1p", "pow", "sigmoid",
                   "erf", "erfc", "hypot"}

# Helpers the emitted function may call.  Their formulas are torch's CPU
# kernels' (c10 div_floor_floating / div_floor_integer, the remainder
# kernel's fmod form, maximum's NaN propagation, x86's conversion of an
# out-of-range float), so the kernel decides as the user's callable does.
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
"""


@dataclasses.dataclass(frozen=True, eq=False)
class CompiledPredicate:
    """A predicate compiled for the walks' predicate modes.

    ``fn`` is the user's callable (the plain version), ``text`` the
    header that defines ``vrt_pred``, ``digest`` a hash of the text (the
    header's name and part of its kernels' build key) and ``ops`` the
    kinds of the emitted function's operations in graph order."""

    fn: Callable
    text: str
    digest: str
    ops: Tuple[str, ...]

    @property
    def n_ops(self) -> int:
        """The emitted function's operations (``tools/walk_bounds``)."""
        return len(self.ops)

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
            raise _refuse(f"a captured tensor ({n.target})")
        if n.op == "call_module":
            raise _refuse(f"a module call ({n.target})")
        name = _op_name(n)
        if n.op == "call_function" and n.target not in _FUNCTIONS \
                or n.op == "call_method" and n.target not in _METHODS:
            if name in _TRANSCENDENTAL:
                raise NotImplementedError(
                    f"stateless any-hit predicate: {name} is refused: "
                    f"torch's CPU result is not correctly rounded, so the "
                    f"plain walk and the kernel would differ (ROADMAP H5, "
                    f"H14; Queue 1 item 8c)")
            raise _refuse(name)
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


def _compile(pred) -> CompiledPredicate:
    gm, holders = _trace(pred)
    env: Dict[str, Tuple[str, torch.dtype]] = {}
    for node, cname in zip(holders, ("u", "v", "alpha")):
        env[node.name] = (cname, torch.float32)
    lines, kinds = [], []

    def operand(a, dt: torch.dtype) -> str:
        """Argument ``a`` (a node or a Python scalar) as type ``dt``."""
        if isinstance(a, torch.fx.Node):
            expr, src = env[a.name]
            return _cast(expr, src, dt)
        if isinstance(a, (bool, int, float)):
            return _literal(a, dt)
        raise _refuse(f"the argument {a!r}")

    def result_type(args) -> torch.dtype:
        """torch's promotion of the operands (nodes are (8,) tensors)."""
        ts = [torch.empty(1, dtype=env[a.name][1])
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
        name = _op_name(node)
        kind = (_FUNCTIONS[node.target] if node.op == "call_function"
                else {"remainder": "mod", "floor_divide": "floordiv"}.get(
                    name, name))
        if kind in _CAST_METHODS:
            kind = "to"
        out_dt = _dtype(node)
        args, kw = list(node.args), dict(node.kwargs)
        if kw and kind not in ("to", "clamp", "clamp_min", "clamp_max"):
            raise _refuse(f"{name} with keyword arguments {kw}")
        ct, u_t = _CTYPE[out_dt], _UTYPE.get(out_dt)
        fl = out_dt == torch.float32
        if kind == "to":
            src = args[0]
            target = (_CAST_METHODS[name] if name in _CAST_METHODS
                      else kw.pop("dtype", args[1] if len(args) > 1 else None))
            if len(args) > (2 if name == "to" else 1) or kw \
                    or target not in _CTYPE:
                raise _refuse(f".{name}({', '.join(map(str, args[1:]))}"
                              f"{', ' if kw else ''}{kw or ''})")
            expr = _cast(*env[src.name], target)
        elif kind in ("add", "sub", "mul"):
            op = {"add": "+", "sub": "-", "mul": "*"}[kind]
            a, b = (operand(x, out_dt) for x in args)
            if out_dt == torch.bool:
                raise _refuse(f"{name} on bool operands")
            expr = (f"({a} {op} {b})" if fl else
                    f"(({ct})(({u_t})({a}) {op} ({u_t})({b})))")
        elif kind == "div":
            if out_dt != torch.float32 or kw:
                raise _refuse(f"{name} to {out_dt}")
            a, b = (operand(x, out_dt) for x in args)
            expr = f"__fdiv_rn({a}, {b})"
        elif kind in ("mod", "floordiv"):
            a, b = (operand(x, out_dt) for x in args)
            if out_dt == torch.bool:
                raise _refuse(f"{name} on bool operands")
            if not fl and not isinstance(args[1], torch.fx.Node) \
                    and int(args[1]) == 0:
                raise _refuse(f"{name} by a constant integer 0 (torch "
                              f"raises)")
            expr = (f"vrt_p_f{kind}({a}, {b})" if fl else
                    f"vrt_p_imod<{ct}>({a}, {b})" if kind == "mod" else
                    f"vrt_p_ifloordiv<{ct}, {u_t}>({a}, {b})")
        elif kind == "neg":
            a = operand(args[0], out_dt)
            if out_dt == torch.bool:
                raise _refuse("neg on a bool operand")
            expr = f"(-{a})" if fl else f"(({ct})(({u_t})0 - ({u_t})({a})))"
        elif kind == "abs":
            a = operand(args[0], out_dt)
            expr = (f"fabsf({a})" if fl else a if out_dt == torch.bool
                    else f"vrt_p_iabs<{ct}, {u_t}>({a})")
        elif kind in ("floor", "ceil", "trunc", "round"):
            if kw or len(args) > 1:
                raise _refuse(f"{name} with arguments "
                              f"{args[1:] or ''}{kw or ''}")
            a = operand(args[0], out_dt)
            fn = {"floor": "floorf", "ceil": "ceilf", "trunc": "truncf",
                  "round": "rintf"}[kind]
            expr = f"{fn}({a})" if fl else a
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
                if set(bounds) - {"min", "max"}:
                    raise _refuse(f"{name} with {sorted(bounds)}")
                if bounds.get("min") is not None:
                    expr = f"{mx}({expr}, {operand(bounds['min'], out_dt)})"
                if bounds.get("max") is not None:
                    expr = f"{mn}({expr}, {operand(bounds['max'], out_dt)})"
        elif kind == "where":
            if len(args) != 3 or kw:
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
        elif kind in ("logical_and", "logical_or", "logical_not"):
            ops = [_cast(env[x.name][0], env[x.name][1], torch.bool)
                   if isinstance(x, torch.fx.Node)
                   else _literal(x, torch.bool) for x in args]
            expr = (f"(!{ops[0]})" if kind == "logical_not" else
                    f"({ops[0]} {'&&' if kind == 'logical_and' else '||'} "
                    f"{ops[1]})")
        else:  # (every kind of the table is handled above)
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
    return CompiledPredicate(fn=pred, text=text, digest=digest,
                             ops=tuple(kinds))
