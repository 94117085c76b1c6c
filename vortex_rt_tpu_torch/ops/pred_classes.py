"""Slot classes of a compiled stateless any-hit predicate, by interval
arithmetic over its compiled operations (ROADMAP hazard H25).

K1's and K2's predicate modes test a candidate that passes
Moller-Trumbore with two dependent reads (the slot's alpha fields from
its row, then the texel at the interpolated uv from the alpha pool) and
the predicate ``vrt_pred(u, v, alpha)``.  ``build`` decides for
each leaf slot of a table what every candidate of that slot can get, as
``ops/traverse_packet.alpha_classes`` does for a threshold, in the same
2 bits a slot:

- ``CLS_KEPT`` (1): the predicate is true for every (u, v, alpha) the
  slot's candidates can have: kept untested;
- ``CLS_CUT`` (2): false for every one: cut out untested;
- ``CLS_UV`` (3): undecided, but the predicate gives the same value for
  every alpha the slot can reach and the table's representative alpha
  ``rep``: the kernel tests on (u, v, rep) and reads no texel (for a
  predicate that never reads alpha, every undecided slot);
- ``CLS_TEST`` (0): anything else, tested as before.

Inputs of a slot: u and v in the box of its three uv corners widened by
``_UV_REL`` of their largest magnitude and ``_UV_ABS`` (the walk's
float32 interpolation ``uv1*w1 + uv2*w2 + uv0*bz`` with w1, w2 >= 0 and
``w1 + w2 <= 1`` in float32, built with ``-fmad=false``, stays within
about 2^-20 of that magnitude of the corners' hull), rounded out to
float32; alpha in the least and greatest texel of the texels the slot can
sample (``texel_box``, the texel box of ``alpha_classes``, through a
min/max pyramid of each texture: a box of side up to 2^L is covered by
at most four aligned blocks of level L, so a wide reach takes a coarser
level and at last the texture's whole range; a 1x1 texture gives one
value).

Each operation of ``CompiledPredicate.steps`` has a rule that bounds the
kernel's float32 (or integer, or bool) result over its operands'
intervals: exact float32 ops are evaluated at the corners in float32 on
the CPU (the kernel's IEEE operations: a rounded monotone function takes
its extremes at the corners), the correctly rounded ops (H23) from their
float64 values at the extremes of their range on the interval, widened by
``_CR_REL`` (the CUDA and host float64 libraries differ by a few double
ulps) and rounded out to float32; floor, ``%``, ``//``, casts,
comparisons and the logical ops by their own rules.  An interval may
hold a NaN (a negative ``sqrt``, ``inf - inf``, a division by an interval
holding 0 ...) or come from an op without a rule (integer bitwise
``& | ^``, shifts, ``pow`` on integers): it is then *tainted*, and a
slot whose result is tainted is never kept or cut (it stays to be
tested; counted in ``PredClasses.counts``).  Signed zeros: an interval
that holds 0 is taken to hold both zeros wherever the sign matters.

Class 3 is shown by a dependence analysis over the same evaluation: a
node depends on alpha when one of its operands does and its interval is
not one value (a float one that is not 0; an untainted one): a node of a
single value over the slot's inputs is the same for every alpha.  The
evaluation for class 3 takes the hull of the slot's alpha interval and
``rep``, so the kernel's answer on (u, v, rep) is the answer at the
candidate's own texel.  ``rep`` is a table-wide value (a kernel
argument, no load): the texel value most of the undecided slots reach
(0.0 for a predicate that never reads alpha).

Made on the CPU (float32 corner arithmetic is the kernel's only there
for sure: torch on a card may multiply by a reciprocal, H6) once per
table and compiled predicate, and kept with the table keyed by the
predicate's header hash (``traverse_packet.pred_classes``,
``packet_walk.pred_classes``).  Nothing falls back: a build that fails
raises."""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch

CLS_TEST, CLS_KEPT, CLS_CUT, CLS_UV = 0, 1, 2, 3
CLASS_NAMES = ("test", "kept", "cut", "uv")
# the walk's uv interpolation: within 2^-20 of the corners' largest
# magnitude (weights summing to 1 within 2^-23, each >= -2^-23; five
# float32 roundings), and 5 subnormal roundings; 4x and 2^23x that
_UV_REL = 2.0**-18
_UV_ABS = 2.0**-126
# the correctly rounded ops: the CUDA and host float64 functions agree
# within a few double ulps (2^-50); widened by 2^-44
_CR_REL = 2.0**-44
_CR_ABS = 2.0**-1000
# the classes' texel boxes (traverse_packet._CLS_SPAN, _CLS_MARGIN)
_CLS_SPAN = 2048.0
_CLS_MARGIN = 2.0**-8
_INF = math.inf
F32, F64, I64 = torch.float32, torch.float64, torch.int64
_RANGE = {torch.int32: (-2**31, 2**31 - 1),
          torch.int64: (-2**63, 2**63 - 1), torch.bool: (0, 1)}


class Iv(NamedTuple):
    """Intervals of a node over a batch of slots: ``lo``, ``hi`` (float64
    tensors holding float32 values for a float32 node, int64 for integer
    and bool nodes, bools as 0 and 1), ``taint`` (the interval may hold
    a NaN, or a rule was missing on the way: no claim) and ``dep`` (the
    node may depend on alpha)."""

    lo: torch.Tensor
    hi: torch.Tensor
    taint: torch.Tensor
    dep: torch.Tensor


class PredClasses(NamedTuple):
    """``cls``: (rows,) int32, 2 bits a slot (slot c at bits 2c, 2c+1);
    ``rep``: the representative alpha class-3 slots are tested with;
    ``counts``: slots of each class among the table's real slots (and
    ``tainted``: undecided slots whose result may be NaN or came through
    an op without a rule); ``no_rule``: the op kinds without a rule."""

    cls: torch.Tensor
    rep: float
    counts: Dict[str, int]
    no_rule: tuple


# ------------------------------------------------------------- float32

def _down(x: torch.Tensor) -> torch.Tensor:
    """The largest float32 at or below each float64 (as float64)."""
    y = x.float()
    y = torch.where(y.double() > x, torch.nextafter(
        y, torch.full_like(y, -_INF)), y)
    return y.double()


def _up(x: torch.Tensor) -> torch.Tensor:
    """The least float32 at or above each float64 (as float64)."""
    y = x.float()
    y = torch.where(y.double() < x, torch.nextafter(
        y, torch.full_like(y, _INF)), y)
    return y.double()


def _out(lo: torch.Tensor, hi: torch.Tensor, rel: float = 0.0,
         absolute: float = 0.0):
    """[lo, hi] (float64) widened by ``rel`` of their magnitude and by
    ``absolute``, rounded out to float32."""
    if rel or absolute:
        lo = lo - lo.abs() * rel - absolute
        hi = hi + hi.abs() * rel + absolute
    return _down(lo), _up(hi)


def _f32(fn, *xs) -> torch.Tensor:
    """``fn`` on float32 copies of float64 tensors, back to float64: the
    kernel's float32 operation, on the CPU."""
    return fn(*(x.float() for x in xs)).double()


def _has0(a: Iv) -> torch.Tensor:
    return (a.lo <= 0) & (a.hi >= 0)


def _has_inf(a: Iv) -> torch.Tensor:
    return torch.isinf(a.lo) | torch.isinf(a.hi)


def _mag(a: Iv):
    """The interval of |a| (float64)."""
    lo = torch.where(_has0(a), torch.zeros_like(a.lo),
                     torch.minimum(a.lo.abs(), a.hi.abs()))
    return lo, torch.maximum(a.lo.abs(), a.hi.abs())


def _corners(fn, a: Iv, b: Iv):
    cs = [fn(x, y) for x in (a.lo, a.hi) for y in (b.lo, b.hi)]
    lo = cs[0]
    hi = cs[0]
    for c in cs[1:]:
        lo = torch.minimum(lo, c)
        hi = torch.maximum(hi, c)
    return lo, hi


def _no_nan(n: int):
    return torch.zeros(n, dtype=torch.bool)


# ---------------------------------------------------------------- rules
# Each rule takes the step and its operands' intervals (already in the
# operand types) and returns (lo, hi, nan): nan marks slots whose result
# may be NaN beyond their operands' taint.  A rule that returns None has
# no claim for that type (the op has no rule).

def _float_add(st, a, b):
    nan = ((a.hi == _INF) & (b.lo == -_INF)) | ((a.lo == -_INF)
                                                 & (b.hi == _INF))
    return (_f32(torch.add, a.lo, b.lo), _f32(torch.add, a.hi, b.hi), nan)


def _float_sub(st, a, b):
    nan = ((a.hi == _INF) & (b.hi == _INF)) | ((a.lo == -_INF)
                                                & (b.lo == -_INF))
    return (_f32(torch.sub, a.lo, b.hi), _f32(torch.sub, a.hi, b.lo), nan)


def _float_mul(st, a, b):
    nan = (_has0(a) & _has_inf(b)) | (_has0(b) & _has_inf(a))
    if st.args[0][0] == st.args[1][0] and isinstance(st.args[0][0], str):
        # x * x: the square of |x|
        m_lo, m_hi = _mag(a)
        return (_f32(torch.mul, m_lo, m_lo), _f32(torch.mul, m_hi, m_hi),
                nan)
    lo, hi = _corners(lambda x, y: _f32(torch.mul, x, y), a, b)
    return lo, hi, nan


def _float_div(st, a, b):
    z = _has0(b)
    nan = (z & _has0(a)) | (_has_inf(a) & _has_inf(b))
    safe = torch.where(z, torch.ones_like(b.lo), b.lo)
    safe_hi = torch.where(z, torch.ones_like(b.hi), b.hi)
    lo, hi = _corners(lambda x, y: _f32(torch.div, x, y), a,
                      Iv(safe, safe_hi, None, None))
    return (torch.where(z, -_INF, lo), torch.where(z, _INF, hi), nan)


def _int_arith(st, a, b, fn):
    """+ - * on integers: exact where no corner leaves the type (the
    kernel wraps: the whole range)."""
    if st.args[0][0] == st.args[1][0] and isinstance(st.args[0][0], str) \
            and fn is torch.mul:
        m0 = torch.where((a.lo <= 0) & (a.hi >= 0), torch.zeros_like(a.lo),
                         torch.minimum(a.lo.abs(), a.hi.abs()))
        m1 = torch.maximum(a.lo.abs(), a.hi.abs())
        a = Iv(m0, m1, a.taint, a.dep)
        b = a
    if fn is torch.sub:
        pairs = ((a.lo, b.hi), (a.hi, b.lo))
    else:
        pairs = [(x, y) for x in (a.lo, a.hi) for y in (b.lo, b.hi)]
    est = [fn(x.double(), y.double()) for x, y in pairs]
    big = torch.zeros_like(a.lo, dtype=torch.bool)
    for e in est:
        big |= e.abs() >= 2.0**62
    ex = [fn(torch.where(big, 0, x), torch.where(big, 0, y))
          for x, y in pairs]
    lo = hi = ex[0]
    for e in ex[1:]:
        lo = torch.minimum(lo, e)
        hi = torch.maximum(hi, e)
    t_lo, t_hi = _RANGE[st.out]
    over = big | (lo < t_lo) | (hi > t_hi)
    return (torch.where(over, t_lo, lo), torch.where(over, t_hi, hi),
            _no_nan(a.lo.shape[0]))


def _arith(fn_f, fn_i):
    def rule(st, a, b):
        if st.out == F32:
            return fn_f(st, a, b)
        if st.out == torch.bool:
            return None
        return _int_arith(st, a, b, fn_i)
    return rule


def _int_divlike(st, a, b, mode: str):
    """Integer division (``trunc`` or ``floor``) as the helpers give it:
    0 for a zero divisor, -a (wrapping) for -1; exact division at the
    corners of each sign part of the divisor."""
    t_lo, t_hi = _RANGE[st.out]
    n = a.lo.shape[0]
    lo = torch.full((n,), t_hi, dtype=I64)
    hi = torch.full((n,), t_lo, dtype=I64)
    full = (a.lo == t_lo) & (b.lo <= -1) & (b.hi >= -1)
    for part_lo, part_hi in ((b.lo, torch.minimum(b.hi, torch.full_like(
            b.hi, -1))), (torch.maximum(b.lo, torch.ones_like(b.lo)), b.hi)):
        has = part_lo <= part_hi
        for x in (a.lo, a.hi):
            for y in (part_lo, part_hi):
                ok = has & ~full
                yy = torch.where(ok, y, torch.ones_like(y))
                xx = torch.where(ok, x, torch.zeros_like(x))
                q = torch.div(xx, yy, rounding_mode=mode)
                lo = torch.where(ok, torch.minimum(lo, q), lo)
                hi = torch.where(ok, torch.maximum(hi, q), hi)
    z = _has0(b)
    lo = torch.where(z, torch.minimum(lo, torch.zeros_like(lo)), lo)
    hi = torch.where(z, torch.maximum(hi, torch.zeros_like(hi)), hi)
    over = full | (lo < t_lo) | (hi > t_hi)
    return (torch.where(over, t_lo, lo), torch.where(over, t_hi, hi),
            _no_nan(n))


def _div(st, a, b):
    mode = st.params[0] if st.params else None
    if st.out == F32:
        lo, hi, nan = _float_div(st, a, b)
        if mode == "trunc":
            return torch.trunc(lo), torch.trunc(hi), nan
        if mode == "floor":  # vrt_p_ffloordiv: floor(a/b) within one;
            # an infinite a gives NaN (its fmod)
            return (torch.floor(lo) - 1.0, torch.floor(hi) + 1.0,
                    nan | _has_inf(a))
        return lo, hi, nan
    if st.out == torch.bool or mode is None:
        return None
    return _int_divlike(st, a, b, mode)


def _period(a: Iv, b: Iv):
    """For a float divisor of one nonzero value B (a singleton):
    whether the operand lies in one period [kB, (k+1)B) (or the mirror
    for B < 0), k, and B; exact comparisons in float64 (k*B exact for
    |k| < 2^28)."""
    bb = torch.where(b.lo == b.hi, b.lo, torch.ones_like(b.lo))
    bb = torch.where(bb == 0, torch.ones_like(bb), bb)
    k = torch.floor(a.lo / bb)
    fin = torch.isfinite(k) & (k.abs() < 2.0**28) & torch.isfinite(a.hi)
    k = torch.where(fin, k, torch.zeros_like(k))
    k0, k1 = k * bb, (k + 1.0) * bb
    pos = bb > 0
    inside = torch.where(pos, (a.lo >= k0) & (a.hi < k1),
                         (a.lo > k1) & (a.hi <= k0))
    one = fin & (b.lo == b.hi) & (b.lo != 0) & inside
    return one, k, bb


def _float_mod(st, a, b):
    """vrt_p_fmod (floored, as torch's remainder): in [0, B] for B > 0
    (the fix-up ``m + b`` may round to B), [B, 0] for B < 0; within one
    period it is a - kB, rounded (increasing in a)."""
    nan = _has0(b) | _has_inf(a)
    one, k, bb = _period(a, b)
    r_lo, r_hi = _out(a.lo - k * bb, a.hi - k * bb, 2.0**-52)
    pos = b.lo > 0
    neg = b.hi < 0
    lo = torch.where(pos, torch.zeros_like(b.lo),
                     torch.where(neg, b.lo, -_INF))
    hi = torch.where(pos, b.hi, torch.where(neg, torch.zeros_like(b.hi),
                                            _INF))
    lo_one = torch.maximum(r_lo, lo)
    hi_one = torch.minimum(r_hi, hi)
    return (torch.where(one, lo_one, lo), torch.where(one, hi_one, hi), nan)


def _int_mod(st, a, b):
    """vrt_p_imod: 0 for a divisor of 0 or -1; else floored, in [0, B-1]
    (B > 0) or [B+1, 0] (B < 0); within one period a - kB."""
    n = a.lo.shape[0]
    one_b = b.lo == b.hi
    bb = torch.where(one_b & (b.lo != 0), b.lo, torch.ones_like(b.lo))
    r_lo = torch.remainder(a.lo, bb)
    r_hi = torch.remainder(a.hi, bb)
    span_small = (((a.hi.double() - a.lo.double()) < bb.abs().double())
                  & (a.lo.double().abs() < 2.0**53)
                  & (a.hi.double().abs() < 2.0**53))
    same = one_b & (b.lo != 0) & (b.lo != -1) & span_small & (r_lo <= r_hi)
    lo = torch.where(b.lo < -1, b.lo + 1, torch.zeros_like(b.lo))
    hi = torch.where(b.hi > 0, b.hi - 1, torch.zeros_like(b.hi))
    lo = torch.minimum(lo, torch.zeros_like(lo))
    hi = torch.maximum(hi, torch.zeros_like(hi))
    return (torch.where(same, r_lo, lo), torch.where(same, r_hi, hi),
            _no_nan(n))


def _mod(st, a, b):
    if st.out == F32:
        return _float_mod(st, a, b)
    if st.out == torch.bool:
        return None
    return _int_mod(st, a, b)


def _floordiv(st, a, b):
    if st.out == F32:
        return _div(st._replace(params=("floor",)), a, b)
    if st.out == torch.bool:
        return None
    return _int_divlike(st, a, b, "floor")


def _fmod(st, a, b):
    """C's fmod (truncated: the sign of a, |r| < |b| and |r| <= |a|);
    integers: 0 for a divisor of 0 or -1."""
    if st.out == torch.bool:
        return None
    m = torch.maximum(b.lo.abs(), b.hi.abs())
    if st.out == F32:
        nan = _has0(b) | _has_inf(a)
    else:  # (|INT64_MIN| wraps: the greatest int64)
        m = torch.where(b.lo == _RANGE[torch.int64][0],
                        _RANGE[torch.int64][1], m) - 1
        nan = _no_nan(a.lo.shape[0])
    zero = torch.zeros_like(a.lo)
    lo = torch.where(a.lo >= 0, zero, torch.maximum(a.lo, -m))
    hi = torch.where(a.hi <= 0, zero, torch.minimum(a.hi, m))
    return torch.minimum(lo, zero), torch.maximum(hi, zero), nan


def _copysign(st, a, b):
    if st.out != F32:
        return None
    m_lo, m_hi = _mag(a)
    pos, neg = b.lo > 0, b.hi < 0
    lo = torch.where(pos, m_lo, -m_hi)
    hi = torch.where(neg, -m_lo, m_hi)
    return lo, hi, _no_nan(a.lo.shape[0])


def _neg(st, a):
    if st.out == F32:
        return -a.hi, -a.lo, _no_nan(a.lo.shape[0])
    if st.out == torch.bool:
        return None
    t_lo, t_hi = _RANGE[st.out]
    w = a.lo == t_lo
    return (torch.where(w, t_lo, -a.hi), torch.where(w, t_hi, -a.lo),
            _no_nan(a.lo.shape[0]))


def _abs(st, a):
    n = a.lo.shape[0]
    if st.out == F32:
        lo, hi = _mag(a)
        return lo, hi, _no_nan(n)
    if st.out == torch.bool:
        return a.lo, a.hi, _no_nan(n)
    t_lo, t_hi = _RANGE[st.out]
    w = a.lo == t_lo
    z = (a.lo <= 0) & (a.hi >= 0)
    lo = torch.where(z, torch.zeros_like(a.lo),
                     torch.minimum(a.lo.abs(), a.hi.abs()))
    hi = torch.maximum(a.lo.abs(), a.hi.abs())
    return torch.where(w, t_lo, lo), torch.where(w, t_hi, hi), _no_nan(n)


def _sign(st, a):
    return torch.sign(a.lo), torch.sign(a.hi), _no_nan(a.lo.shape[0])


def _rounding(fn):
    def rule(st, a):
        if st.out == F32:
            return fn(a.lo), fn(a.hi), _no_nan(a.lo.shape[0])
        return a.lo, a.hi, _no_nan(a.lo.shape[0])
    return rule


def _frac(st, a):
    """x - trunc(x), exact: in one integer cell, x - t; else within
    (-1, 1) on x's side of 0."""
    nan = _has_inf(a)
    t0, t1 = torch.trunc(a.lo), torch.trunc(a.hi)
    one = t0 == t1
    zero = torch.zeros_like(a.lo)
    lo = torch.where(a.lo >= 0, zero, -torch.ones_like(a.lo))
    hi = torch.where(a.hi <= 0, zero, torch.ones_like(a.hi))
    return (torch.where(one, a.lo - t0, lo), torch.where(one, a.hi - t0, hi),
            nan)


def _bool_iv(always, can):
    return always.to(I64), can.to(I64)


def _isnan(st, a):
    z = torch.zeros_like(a.lo, dtype=I64)
    return z, z, _no_nan(a.lo.shape[0])


def _isinf(st, a, finite=False):
    n = a.lo.shape[0]
    if st.args[0][1] != F32:
        v = torch.full((n,), int(finite), dtype=I64)
        return v, v, _no_nan(n)
    can = _has_inf(a)
    always = (a.lo == a.hi) & torch.isinf(a.lo)
    if finite:
        always, can = ~can, ~always
    lo, hi = _bool_iv(always, can)
    return lo, hi, _no_nan(n)


def _signbit(st, a):
    n = a.lo.shape[0]
    if st.args[0][1] == torch.bool:
        z = torch.zeros(n, dtype=I64)
        return z, z, _no_nan(n)
    if st.args[0][1] == F32:  # a zero may be -0
        lo, hi = _bool_iv(a.hi < 0, a.lo <= 0)
    else:
        lo, hi = _bool_iv(a.hi < 0, a.lo < 0)
    return lo, hi, _no_nan(n)


def _minmax(fn):
    def rule(st, a, b):
        return fn(a.lo, b.lo), fn(a.hi, b.hi), _no_nan(a.lo.shape[0])
    return rule


def _clamp(st, x, *bounds):
    lo, hi = x.lo, x.hi
    for which, bd in zip(st.params, bounds):
        fn = torch.maximum if which == "min" else torch.minimum
        lo, hi = fn(lo, bd.lo), fn(hi, bd.hi)
    return lo, hi, _no_nan(x.lo.shape[0])


def _where(st, c, a, b):
    t, f = c.lo == 1, c.hi == 0
    lo = torch.where(t, a.lo, torch.where(f, b.lo, torch.minimum(a.lo, b.lo)))
    hi = torch.where(t, a.hi, torch.where(f, b.hi, torch.maximum(a.hi, b.hi)))
    return lo, hi, _no_nan(a.lo.shape[0])


def _compare(kind):
    def rule(st, a, b):
        if kind in ("lt", "le", "gt", "ge"):
            if kind in ("gt", "ge"):
                a, b = b, a
            if kind in ("lt", "gt"):
                always, can = a.hi < b.lo, a.lo < b.hi
            else:
                always, can = a.hi <= b.lo, a.lo <= b.hi
        else:
            can = (a.lo <= b.hi) & (b.lo <= a.hi)
            always = (a.lo == a.hi) & (b.lo == b.hi) & (a.lo == b.lo)
            if kind == "ne":
                always, can = ~can, ~always
        lo, hi = _bool_iv(always, can)
        return lo, hi, _no_nan(a.lo.shape[0])
    return rule


def _logic(kind):
    def rule(st, a, b=None):
        if st.out != torch.bool:
            if kind == "not":  # ~x on an integer: -x - 1
                return ~a.hi, ~a.lo, _no_nan(a.lo.shape[0])
            return None  # bitwise & | ^ on integers: no rule
        n = a.lo.shape[0]
        if kind == "not":
            return 1 - a.hi, 1 - a.lo, _no_nan(n)
        if kind == "and":
            return a.lo & b.lo, a.hi & b.hi, _no_nan(n)
        if kind == "or":
            return a.lo | b.lo, a.hi | b.hi, _no_nan(n)
        always = ((a.lo == 1) & (b.hi == 0)) | ((a.hi == 0) & (b.lo == 1))
        same = (a.lo == a.hi) & (b.lo == b.hi) & (a.lo == b.lo)
        lo, hi = _bool_iv(always, ~same)
        return lo, hi, _no_nan(n)
    return rule


def _to(st, a):
    lo, hi, nan = _cast(a, st.args[0][1], st.out)
    return lo, hi, nan


def _cast(a: Iv, src, dst):
    """The interval of ``_cast``'s conversion from ``src`` to ``dst``."""
    n = a.lo.shape[0]
    if src == dst:
        return a.lo, a.hi, _no_nan(n)
    if dst == torch.bool:  # x != 0
        zero = (a.lo == 0) & (a.hi == 0)
        lo, hi = _bool_iv((a.lo > 0) | (a.hi < 0), ~zero)
        return lo, hi, _no_nan(n)
    if dst == F32:  # an integer rounded to float32 (monotone)
        return (a.lo.float().double(), a.hi.float().double(), _no_nan(n))
    t_lo, t_hi = _RANGE[dst]
    if src == F32:  # truncated; out of range (and NaN) the type's minimum
        inside = (a.lo >= t_lo) & (a.hi < -float(t_lo))
        lo = torch.where(inside, torch.trunc(a.lo), 0.0).to(I64)
        hi = torch.where(inside, torch.trunc(a.hi), 0.0).to(I64)
        return (torch.where(inside, lo, t_lo), torch.where(inside, hi, t_hi),
                _no_nan(n))
    fits = (a.lo >= t_lo) & (a.hi <= t_hi)  # (wraps otherwise)
    return (torch.where(fits, a.lo, t_lo), torch.where(fits, a.hi, t_hi),
            _no_nan(n))


def _cr_monotone(fn, increasing=True, dom=(-_INF, _INF)):
    """A correctly rounded op increasing (or decreasing) on its domain
    ``dom`` (outside it, NaN)."""
    def rule(st, a):
        nan = (a.lo < dom[0]) | (a.hi > dom[1])
        lo_x = a.lo.clamp(min=dom[0], max=dom[1])
        hi_x = a.hi.clamp(min=dom[0], max=dom[1])
        y0, y1 = fn(lo_x), fn(hi_x)
        if not increasing:
            y0, y1 = y1, y0
        lo, hi = _out(y0, y1, _CR_REL, _CR_ABS)
        return lo, hi, nan
    return rule


def _sqrt(st, a):
    nan = a.lo < 0
    lo = _f32(torch.sqrt, a.lo.clamp(min=0))
    hi = _f32(torch.sqrt, a.hi.clamp(min=0))
    return lo, hi, nan


def _rsqrt(st, a):
    """1/sqrt(x) in float64: decreasing on [0, inf]; -0 gives -inf."""
    lo, hi, nan = _cr_monotone(lambda x: 1.0 / torch.sqrt(x), False,
                               (0.0, _INF))(st, a)
    return torch.where(a.lo <= 0, -_INF, lo), hi, nan


def _cosh(st, a):
    m_lo, m_hi = _mag(a)
    lo, hi = _out(torch.cosh(m_lo), torch.cosh(m_hi), _CR_REL, _CR_ABS)
    return lo, hi, _no_nan(a.lo.shape[0])


def _periodic(fn, phase_max: float, phase_min: float):
    """sin (maxima at pi/2 + 2k pi, minima at -pi/2 + 2k pi) and cos (0,
    pi): the values at the ends, and 1 or -1 where the interval holds a
    maximum or a minimum (with slack); [-1, 1] past 2^20 or a whole
    period."""
    def rule(st, a):
        nan = _has_inf(a)
        two_pi = 2.0 * math.pi
        slack = 1e-9
        y0, y1 = fn(a.lo), fn(a.hi)
        lo, hi = torch.minimum(y0, y1), torch.maximum(y0, y1)

        def holds(phase):
            k = torch.ceil((a.lo - slack - phase) / two_pi)
            return phase + k * two_pi <= a.hi + slack

        wide = ((a.hi - a.lo) >= two_pi) | (torch.maximum(
            a.lo.abs(), a.hi.abs()) > 2.0**20) | nan
        hi = torch.where(holds(phase_max) | wide, 1.0, hi)
        lo = torch.where(holds(phase_min) | wide, -1.0, lo)
        lo, hi = _out(lo, hi, _CR_REL, _CR_ABS)
        return lo.clamp(min=-1.0), hi.clamp(max=1.0), nan
    return rule


def _tan(st, a):
    nan = _has_inf(a)
    k = torch.ceil((a.lo - 1e-9 - math.pi / 2) / math.pi)
    pole = (math.pi / 2 + k * math.pi <= a.hi + 1e-9) | (
        (a.hi - a.lo) >= math.pi) | nan
    lo, hi = _out(torch.tan(a.lo), torch.tan(a.hi), _CR_REL, _CR_ABS)
    return (torch.where(pole, -_INF, lo), torch.where(pole, _INF, hi), nan)


def _atan2(st, y, x):
    """Corners where the box avoids the branch cut (x < 0, y = 0) and the
    origin; else [-pi, pi]."""
    n = y.lo.shape[0]
    ok = (x.lo > 0) | (y.lo > 0) | (y.hi < 0)
    lo, hi = _corners(torch.atan2, y, x)
    lo, hi = _out(lo, hi, _CR_REL, _CR_ABS)
    pi_hi = _up(torch.full((n,), math.pi, dtype=F64))
    return torch.where(ok, lo, -pi_hi), torch.where(ok, hi, pi_hi), _no_nan(n)


def _hypot(st, x, y):
    x0, x1 = _mag(x)
    y0, y1 = _mag(y)
    lo, hi = _out(torch.hypot(x0, y0), torch.hypot(x1, y1), _CR_REL, _CR_ABS)
    return lo, hi, _no_nan(x.lo.shape[0])


def _pow(st, a, b):
    """pow on float32 (float64, rounded once): corners for a base > 0, or
    a base >= 0 with an exponent > 0; a base that may be negative may
    give NaN; a zero base with an exponent <= 0 any value."""
    if st.out != F32:
        return None
    n = a.lo.shape[0]
    base0 = a.lo.clamp(min=0)
    lo, hi = _corners(torch.pow, Iv(base0, a.hi, None, None), b)
    lo, hi = _out(lo, hi, _CR_REL, _CR_ABS)
    ok = (a.lo > 0) | ((a.lo >= 0) & (b.lo > 0))
    nan = a.lo < 0
    return torch.where(ok, lo, -_INF), torch.where(ok, hi, _INF), nan


def _sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))


_RULES = {
    "add": _arith(_float_add, torch.add),
    "sub": _arith(_float_sub, torch.sub),
    "mul": _arith(_float_mul, torch.mul),
    "square": _arith(_float_mul, torch.mul),
    "div": _div, "reciprocal": _div, "mod": _mod,
    "floordiv": _floordiv, "fmod": _fmod, "copysign": _copysign,
    "neg": _neg, "abs": _abs, "sign": _sign,
    "floor": _rounding(torch.floor), "ceil": _rounding(torch.ceil),
    "trunc": _rounding(torch.trunc), "round": _rounding(torch.round),
    "frac": _frac, "isnan": _isnan, "isinf": _isinf,
    "isfinite": lambda st, a: _isinf(st, a, finite=True),
    "signbit": _signbit,
    "minimum": _minmax(torch.minimum), "maximum": _minmax(torch.maximum),
    "clamp": _clamp, "clamp_min": _clamp, "clamp_max": _clamp,
    "where": _where,
    **{k: _compare(k) for k in ("lt", "le", "gt", "ge", "eq", "ne")},
    "and": _logic("and"), "or": _logic("or"), "xor": _logic("xor"),
    "invert": _logic("not"), "logical_and": _logic("and"),
    "logical_or": _logic("or"), "logical_xor": _logic("xor"),
    "logical_not": _logic("not"), "to": _to,
    # the correctly rounded ops (float32 in, float32 out)
    "sqrt": _sqrt,
    "rsqrt": _rsqrt,
    "sin": _periodic(torch.sin, math.pi / 2, -math.pi / 2),
    "cos": _periodic(torch.cos, 0.0, math.pi), "tan": _tan,
    "asin": _cr_monotone(torch.asin, True, (-1.0, 1.0)),
    "acos": _cr_monotone(torch.acos, False, (-1.0, 1.0)),
    "atan": _cr_monotone(torch.atan),
    "sinh": _cr_monotone(torch.sinh), "cosh": _cosh,
    "tanh": _cr_monotone(torch.tanh),
    "asinh": _cr_monotone(torch.asinh),
    "acosh": _cr_monotone(torch.acosh, True, (1.0, _INF)),
    "atanh": _cr_monotone(torch.atanh, True, (-1.0, 1.0)),
    "exp": _cr_monotone(torch.exp), "exp2": _cr_monotone(torch.exp2),
    "expm1": _cr_monotone(torch.expm1),
    "log": _cr_monotone(torch.log, True, (0.0, _INF)),
    "log2": _cr_monotone(torch.log2, True, (0.0, _INF)),
    "log10": _cr_monotone(torch.log10, True, (0.0, _INF)),
    "log1p": _cr_monotone(torch.log1p, True, (-1.0, _INF)),
    "sigmoid": _cr_monotone(_sigmoid),
    "erf": _cr_monotone(torch.erf), "erfc": _cr_monotone(torch.erfc, False),
    "atan2": _atan2, "hypot": _hypot, "pow": _pow,
}
# (no rule: integer bitwise & | ^ (above), lshift, rshift, ipow)


# ------------------------------------------------------------ evaluator

def _full(dt, n: int) -> Iv:
    """The whole range of type ``dt`` over ``n`` slots, tainted."""
    if dt == F32:
        lo = torch.full((n,), -_INF, dtype=F64)
        hi = torch.full((n,), _INF, dtype=F64)
    else:
        t_lo, t_hi = _RANGE[dt]
        lo = torch.full((n,), t_lo, dtype=I64)
        hi = torch.full((n,), t_hi, dtype=I64)
    return Iv(lo, hi, torch.ones(n, dtype=torch.bool),
              torch.zeros(n, dtype=torch.bool))


def _const(x, dt, n: int) -> Iv:
    if dt == F32:
        v = float(torch.tensor(float(x), dtype=F32))
        t = torch.full((n,), v, dtype=F64)
        bad = math.isnan(v)
        return Iv(t, t.clone(), torch.full((n,), bad),
                  torch.zeros(n, dtype=torch.bool))
    if dt == torch.bool:
        v = int(bool(x))
    else:
        bits = 32 if dt == torch.int32 else 64
        v = int(x) & ((1 << bits) - 1)
        v = v - (1 << bits) if v >= 1 << (bits - 1) else v
    t = torch.full((n,), v, dtype=I64)
    return Iv(t, t.clone(), torch.zeros(n, dtype=torch.bool),
              torch.zeros(n, dtype=torch.bool))


def _single(iv: Iv, dt) -> torch.Tensor:
    """One value, and not a zero that may carry either sign."""
    one = (iv.lo == iv.hi) & ~iv.taint
    return one & (iv.lo != 0) if dt == F32 else one


def _settle(lo, hi, taint, dep, dt) -> Iv:
    if dt == F32:
        bad = torch.isnan(lo) | torch.isnan(hi)
        lo = torch.where(bad, -_INF, lo)
        hi = torch.where(bad, _INF, hi)
        taint = taint | bad
    iv = Iv(lo, hi, taint, dep)
    return iv._replace(dep=dep & ~_single(iv, dt))


def evaluate(compiled, u: Iv, v: Iv, alpha: Iv, nodes: Optional[dict] = None):
    """The intervals of ``compiled``'s result over slots with inputs u, v
    and alpha (float32 ``Iv``): (bool ``Iv`` of the result, the kinds of
    the operations without a rule on the way); ``nodes``, a dict, gets
    every node's (``Iv``, type)."""
    n = u.lo.shape[0]
    env = {name: (iv, F32) for name, iv in zip(compiled.inputs,
                                               (u, v, alpha))}
    missing = []

    def operand(ref, dt) -> Iv:
        if not isinstance(ref, str):
            return _const(ref, dt, n)
        iv, src = env[ref]
        if src == dt:
            return iv
        lo, hi, nan = _cast(iv, src, dt)
        return _settle(lo, hi, iv.taint | nan, iv.dep, dt)

    for st in compiled.steps:
        if st.kind == "const":
            env[st.name] = (_const(st.args[0][0], st.out, n), st.out)
            continue
        args = [operand(ref, dt) for ref, dt in st.args]
        rule = _RULES.get(st.kind)
        got = rule(st, *args) if rule is not None else None
        taint = torch.zeros(n, dtype=torch.bool)
        dep = torch.zeros(n, dtype=torch.bool)
        for a in args:
            taint = taint | a.taint
            dep = dep | a.dep
        if got is None:
            missing.append(st.kind)
            iv = _full(st.out, n)._replace(dep=dep)
        else:
            lo, hi, nan = got
            iv = _settle(lo, hi, taint | nan, dep, st.out)
        env[st.name] = (iv, st.out)
    if nodes is not None:
        nodes.update(env)
    return env[compiled.output][0], tuple(missing)


# ----------------------------------------------------------- slot inputs

def texel_box(c: torch.Tensor, side: torch.Tensor):
    """The texel range [lo, hi] of corners c (..., 3) along an axis of
    ``side`` texels (float64), after the floored modulo (the whole side
    where the range wraps, or where the span passes ``_CLS_SPAN``
    texels): int64 (lo, hi).  The walk's float32 uv interpolation lands
    within ``_CLS_MARGIN`` texels of the corners' box while the span is
    under ``_CLS_SPAN`` texels."""
    lo = torch.floor(c.amin(-1) * side - _CLS_MARGIN)
    hi = torch.floor(c.amax(-1) * side + _CLS_MARGIN)
    fit = (torch.isfinite(c).all(-1)
           & (c.abs().amax(-1) * side <= _CLS_SPAN))
    lo = torch.where(fit, lo, 0.0)
    hi = torch.where(fit, hi, 0.0)
    shift = torch.floor(lo / side) * side
    lo, hi = lo - shift, hi - shift
    fit = fit & (hi <= side - 1)
    return (torch.where(fit, lo, 0).long(),
            torch.where(fit, hi, side - 1).long())


def _alpha_range(toff, tw, th, ulo, uhi, vlo, vhi, pool):
    """The least and greatest pool value over each slot's texel box
    (flat (S,) int64 inputs), through a min/max pyramid of each texture;
    a texture that leaves the pool gives the whole pool's range (the
    walk clamps its index into the pool)."""
    s = toff.shape[0]
    amin = torch.full((s,), float(pool.min()), dtype=F64)
    amax = torch.full((s,), float(pool.max()), dtype=F64)
    if bool(torch.isnan(pool).any()):
        amin[:] = math.nan
    tex, inv = torch.unique(torch.stack([toff, tw, th], -1), dim=0,
                            return_inverse=True)
    for t, (t_off, t_w, t_h) in enumerate(tex.tolist()):
        if not (0 <= t_off and t_off + t_w * t_h <= pool.shape[0]):
            continue
        sel = (inv == t).nonzero().squeeze(1)
        img = pool[t_off:t_off + t_w * t_h].double().reshape(t_h, t_w)
        mins, maxs = [img], [img]
        while mins[-1].shape[0] > 1 or mins[-1].shape[1] > 1:
            mins.append(-torch.nn.functional.max_pool2d(
                -mins[-1][None, None], 2, ceil_mode=True)[0, 0])
            maxs.append(torch.nn.functional.max_pool2d(
                maxs[-1][None, None], 2, ceil_mode=True)[0, 0])
        u0, u1, v0, v1 = ulo[sel], uhi[sel], vlo[sel], vhi[sel]
        span = torch.maximum(u1 - u0, v1 - v0) + 1
        lvl = torch.ceil(torch.log2(span.double())).long().clamp(
            0, len(mins) - 1)
        lo = torch.full((sel.shape[0],), _INF, dtype=F64)
        hi = torch.full((sel.shape[0],), -_INF, dtype=F64)
        for L in range(len(mins)):
            at = (lvl == L).nonzero().squeeze(1)
            if at.numel() == 0:
                continue
            mn, mx = mins[L], maxs[L]
            h, w = mn.shape
            for bu in (u0[at] >> L, u1[at] >> L):
                for bv in (v0[at] >> L, v1[at] >> L):
                    bu_c, bv_c = bu.clamp(0, w - 1), bv.clamp(0, h - 1)
                    lo[at] = torch.minimum(lo[at], mn[bv_c, bu_c])
                    hi[at] = torch.maximum(hi[at], mx[bv_c, bu_c])
        amin[sel] = lo
        amax[sel] = hi
    return amin, amax


def slot_inputs(fields: torch.Tensor, pool: torch.Tensor):
    """The (u, v, alpha) intervals of each slot from its alpha fields
    (S, 8) float32 words (u0 v0 u1 v1 u2 v2, then the texture offset and
    ``tw << 16 | th`` as int bits), on the CPU."""
    fields = fields.cpu()
    pool = pool.cpu().float()
    s = fields.shape[0]
    uv = fields[:, :6].double()
    ints = fields.view(torch.int32)
    toff = ints[:, 6].long()
    twh = ints[:, 7].long()
    tw = (twh >> 16).clamp_min(1)
    th = (twh & 0xFFFF).clamp_min(1)
    out = []
    for corners in (uv[:, 0::2], uv[:, 1::2]):
        fin = torch.isfinite(corners).all(1)
        c = torch.where(fin.unsqueeze(1), corners, torch.zeros_like(corners))
        m = c.abs().amax(1) * _UV_REL + _UV_ABS
        lo, hi = _out(c.amin(1) - m, c.amax(1) + m)
        lo = torch.where(fin, lo, -_INF)
        hi = torch.where(fin, hi, _INF)
        out.append(Iv(lo, hi, ~fin, torch.zeros(s, dtype=torch.bool)))
    ulo, uhi = texel_box(uv[:, 0::2], tw.double())
    vlo, vhi = texel_box(uv[:, 1::2], th.double())
    amin, amax = _alpha_range(toff, tw, th, ulo, uhi, vlo, vhi, pool)
    bad = torch.isnan(amin) | torch.isnan(amax)
    amin = torch.where(bad, -_INF, amin)
    amax = torch.where(bad, _INF, amax)
    return out[0], out[1], Iv(amin, amax, bad,
                              torch.zeros(s, dtype=torch.bool))


def classify(compiled, fields: torch.Tensor, pool: torch.Tensor):
    """(classes (S,) int64, rep, counts, no_rule) of slots with alpha
    fields (S, 8) over ``pool``."""
    u, v, a = slot_inputs(fields, pool)
    s = u.lo.shape[0]
    dep_a = ~_single(a, F32)
    out, missing = evaluate(compiled, u, v, a._replace(dep=dep_a))
    kept = (out.lo == 1) & ~out.taint
    cut = (out.hi == 0) & ~out.taint
    undecided = ~kept & ~cut
    rep = 0.0
    uv_only = undecided.clone()
    if compiled.reads_alpha:
        cand = undecided & ~out.dep
        if bool(cand.any()):
            lows = a.lo[cand & torch.isfinite(a.lo)]
            if lows.numel():
                rep = float(torch.mode(lows).values)
        r = torch.full((s,), rep, dtype=F64)
        hull = Iv(torch.minimum(a.lo, r), torch.maximum(a.hi, r), a.taint,
                  None)
        hull = hull._replace(dep=~_single(hull, F32))
        out2, _ = evaluate(compiled, u, v, hull)
        uv_only = cand & ~out2.dep
    cls = torch.where(kept, CLS_KEPT, torch.where(
        cut, CLS_CUT, torch.where(uv_only, CLS_UV, CLS_TEST)))
    counts = {name: int((cls == k).sum())
              for k, name in enumerate(CLASS_NAMES)}
    counts["tainted"] = int((undecided & out.taint).sum())
    return cls, rep, counts, tuple(sorted(set(missing)))


def _pack(cls: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """(n, k) classes packed 2 bits a slot into (n,) int32."""
    shift = 2 * torch.arange(k, dtype=I64)
    packed = (cls.reshape(n, k).long() << shift).sum(-1)
    return torch.where(packed >= 2**31, packed - 2**32,
                       packed).to(torch.int32)


def build(compiled, words: torch.Tensor, pool: torch.Tensor,
          real: Optional[torch.Tensor], device) -> PredClasses:
    """``PredClasses`` of rows whose alpha fields are ``words`` (n, k, 8)
    (int32 bits or float32), over the alpha ``pool``; ``real`` (n, k)
    marks the slots a walk can test (the leaves' own slots: the others,
    which no walk reads, are left 0).  Raises for rows of more than 16
    slots (2 bits a slot in one word)."""
    n, k = words.shape[0], words.shape[1]
    if k > 16:
        raise ValueError(f"predicate slot classes hold 16 slots a row; the "
                         f"table's rows hold {k}")
    fields = words.cpu().contiguous().view(torch.float32).reshape(n * k, 8)
    at = (torch.arange(n * k) if real is None
          else real.cpu().reshape(-1).nonzero().squeeze(1))
    cls = torch.zeros(n * k, dtype=I64)
    cls[at], rep, counts, missing = classify(compiled, fields[at], pool)
    return PredClasses(_pack(cls, n, k).to(device), rep, counts, missing)


def check_classes(cls: torch.Tensor, rows: int, device) -> None:
    """Slot classes a kernel reads: a contiguous (rows,) int32 tensor on
    the walk's device."""
    if (cls.dtype != torch.int32 or cls.shape != (rows,)
            or not cls.is_contiguous() or cls.device != device):
        raise ValueError(f"slot classes must be a contiguous ({rows},) "
                         f"int32 tensor on {device}")

