"""The op cases of the predicate compiler (``ops/anyhit_pred.py``): one
predicate per op of its set and per form (operator, tensor method,
``torch`` function, alias, a captured 0-dim tensor), the exact ops' and
the correctly rounded ones', and the seeded grid of (u, v, alpha) they
are decided on.  Imports neither JAX nor the JAX package: the CPU tests
(``test_torch_anyhit_pred.py``, the emitted C compiled for the host) and
the card's (``test_torch_gpu.py``, compiled by nvcc) share them."""

import numpy as np
import torch

from vortex_rt_tpu_torch.tools.bench_ladder import perforated_pred


def cell(u):
    return torch.floor(u * 6.0).to(torch.int32)


def cell_in_range(u):
    """``cell`` of u with NaN made 0 and u clamped to [-100, 100]: a cast
    whose value torch gives alike on the CPU and on a card (out of range
    or NaN, x86 gives the type's minimum and a card saturates, ROADMAP
    H22), for the correctly rounded cases, which are held to the plain
    version run on the card."""
    return cell(torch.where(u == u, u, 0.0).clamp(-100.0, 100.0))


# one predicate per op of the compiler's set (and its forms)
OPS = {
    "add": lambda u, v, a: (u + v) > a,
    "sub": lambda u, v, a: (u - 0.25) < v,
    "mul": lambda u, v, a: (u * v) >= a * 0.5,
    "div": lambda u, v, a: (u / 0.1) > v / (a + 0.5),
    "neg": lambda u, v, a: -u > v,
    "abs": lambda u, v, a: torch.abs(u - 0.5) < a,
    "floor": lambda u, v, a: torch.floor(u * 6.0) == torch.floor(v * 6.0),
    "ceil": lambda u, v, a: torch.ceil(u * 3.0) > v * 3.0,
    "trunc": lambda u, v, a: (u * 4.0).trunc() <= a * 4.0,
    "round": lambda u, v, a: torch.round(u * 2.5) == torch.round(v * 2.5),
    "mod_int": lambda u, v, a: (cell(u) % 3) == 1,
    "mod_int_tensor": lambda u, v, a: (
        cell(u) % (torch.floor(v * 4.0).int() * 2 + 1)) > 0,
    "mod_float": lambda u, v, a: (u % 0.25) * 1.2 > (v % -0.3) + 0.3,
    "floordiv_int": lambda u, v, a: (cell(u) // 4) == (cell(v) // -3),
    "floordiv_float": lambda u, v, a: (u // 0.125) > (v // 0.5),
    "minimum": lambda u, v, a: torch.minimum(u, v * 2.0) > a,
    "maximum": lambda u, v, a: torch.maximum(u, a) < v + 0.5,
    "clamp": lambda u, v, a: torch.clamp(u, 0.0, 1.0) > v.clamp(max=0.75),
    "clamp_min": lambda u, v, a: u.clamp_min(0.25) < a,
    "where": lambda u, v, a: torch.where(a > 0.5, u, v * 2.0) > 0.3,
    "lt": lambda u, v, a: cell(u) < 2.5,
    "le": lambda u, v, a: u <= v,
    "gt": lambda u, v, a: a > 0.5,
    "ge": lambda u, v, a: a >= 0.05,
    "eq": lambda u, v, a: torch.floor(u * 4.0) == torch.floor(v * 4.0).long(),
    "ne": lambda u, v, a: cell(u) != torch.floor(v * 6.0).long(),
    "and": lambda u, v, a: ((cell(u) & 3) == 1) & (a > 0.2),
    "or": lambda u, v, a: ((cell(u) | cell(v)) > 4) | (a < 0.1),
    "xor": lambda u, v, a: ((cell(u) ^ cell(v)) > 2) ^ (u > v),
    "invert": lambda u, v, a: ~(u > v) & ((~cell(u)) < 0),
    "logical_and": lambda u, v, a: torch.logical_and(u > 0.5, a),
    "logical_or": lambda u, v, a: torch.logical_or(cell(u), v > 1.0),
    "logical_not": lambda u, v, a: torch.logical_not(cell(u)),
    "to_int32": lambda u, v, a: (u * 3e9).to(torch.int32) < 0,
    "int": lambda u, v, a: (u * 6.0).int() == 2,
    "long": lambda u, v, a: (u * 1e10).long() % 7 == 3,
    "float": lambda u, v, a: cell(u).float() / 7.0 > v,
    "bool": lambda u, v, a: (cell(u) % 2).bool() & (a > 0.3).bool(),
    "int64_arith": lambda u, v, a: (
        (cell(u).long() * 1000000007 + 12345) % 97) == 3,
}

# captured 0-dim tensors: exact literals that promote as 0-dim tensors
HALF = torch.tensor(0.5)
THREE = torch.tensor(3)
TWO_HALF = torch.tensor(2.5)

# the function and method forms, aliases and the other exact ops (an
# integer divisor is never 0 or -1: torch raises, or x86 traps, there)
OPS.update({
    "f_add": lambda u, v, a: torch.add(u, v) > a.add(0.25),
    "f_sub": lambda u, v, a: torch.sub(u, 0.25) < v.sub(a),
    "f_mul": lambda u, v, a: torch.mul(u, v) >= a.mul(0.75),
    "f_div": lambda u, v, a: torch.div(u, v) > torch.true_divide(a, 3.0),
    "div_trunc": lambda u, v, a: torch.div(
        u * 7.0, v, rounding_mode="trunc") > a * 3.0,
    "div_floor": lambda u, v, a: torch.div(
        u, 0.3, rounding_mode="floor") == torch.floor(v * 3.0),
    "div_trunc_int": lambda u, v, a: torch.div(
        cell(u), (cell(v) & 3) * 2 + 1, rounding_mode="trunc") > cell(a) // 2,
    "div_floor_int": lambda u, v, a: torch.div(
        cell(u), (cell(v) & 3) * -2 - 3, rounding_mode="floor") < cell(a),
    "f_lt": lambda u, v, a: torch.lt(u, v),
    "f_le": lambda u, v, a: u.le(0.5),
    "f_gt": lambda u, v, a: torch.gt(cell(u), 2.5),
    "f_ge": lambda u, v, a: torch.greater_equal(a, v),
    "f_eq": lambda u, v, a: torch.eq(cell(u), cell(v)),
    "f_ne": lambda u, v, a: cell(u).ne(torch.floor(v * 4.0).long()),
    "square": lambda u, v, a: torch.square(u - 0.5) < a * 0.25,
    "square_int": lambda u, v, a: cell(u).square() > 20,
    "reciprocal": lambda u, v, a: torch.reciprocal(u) > v * 4.0,
    "reciprocal_int": lambda u, v, a: cell(u).reciprocal() > v * 0.5,
    "sign": lambda u, v, a: torch.sign(u - 0.5) == torch.sign(v - a),
    "sign_int": lambda u, v, a: torch.sign(cell(u) - 3) > 0,
    "frac": lambda u, v, a: torch.frac(u * 3.0) > v,
    "fmod": lambda u, v, a: torch.fmod(u * 5.0, 0.7) > v - 0.5,
    "fmod_int": lambda u, v, a: cell(u).fmod(4) == -1,
    "copysign": lambda u, v, a: torch.copysign(a, u - v) > 0.2,
    "isnan": lambda u, v, a: torch.isnan(u * 0.0) | (v > 2.0),
    "isinf": lambda u, v, a: torch.isinf(u * 1e30) ^ (a > 1.0),
    "isfinite": lambda u, v, a: torch.isfinite(v * 3e37) & (u > 0.0),
    "isnan_int": lambda u, v, a: cell(u).isnan() | (u > 0.5),
    "signbit": lambda u, v, a: torch.signbit(u * v) | (a > 2.0),
    "signbit_int": lambda u, v, a: torch.signbit(cell(u) - 3),
    "logical_xor": lambda u, v, a: torch.logical_xor(u > 0.5, cell(v)),
    "bitwise_and": lambda u, v, a: torch.bitwise_and(cell(u), 5) > 3,
    "bitwise_or": lambda u, v, a: torch.bitwise_or(cell(u), cell(v)) < 3,
    "bitwise_xor": lambda u, v, a: cell(u).bitwise_xor(cell(v)) > 6,
    "bitwise_not": lambda u, v, a: torch.bitwise_not(cell(u)) < -3,
    "bitwise_bool": lambda u, v, a: torch.bitwise_and(
        u > v, torch.bitwise_not(a > 0.5)),
    "lshift": lambda u, v, a: (cell(u) << cell(v)) > 5,
    "lshift_int64": lambda u, v, a: (cell(u).long() << cell(v) * 9) < 0,
    "lshift_scalar": lambda u, v, a: (1 << cell(v)) > 4,
    "rshift": lambda u, v, a: ((cell(u) - 6) >> cell(v) * 5) == -1,
    "rshift_int64": lambda u, v, a: torch.bitwise_right_shift(
        cell(u).long() * 1000000007, cell(v) * 11) > 1000,
    "pow_int": lambda u, v, a: cell(u) ** 2 > 9,
    "pow_int_tensor": lambda u, v, a: torch.pow(
        cell(u) - 2, (cell(v) & 7) - 2) > 3,
    "aliases": lambda u, v, a: (torch.absolute(u - 0.5) < torch.clip(
        v, 0.0, 0.5)) | (torch.negative(u) > torch.fix(a * 2.0)),
    "captured": lambda u, v, a: u < HALF,
    "captured_int": lambda u, v, a: cell(u) + THREE > 5,
    "captured_promoted": lambda u, v, a: cell(v) > TWO_HALF,
})

# the correctly rounded ops: the float32 rounding of their float64
# evaluation (the plain version's result, not the callable's)
OPS.update({
    "sqrt": lambda u, v, a: torch.sqrt(u * v + a) > 0.7,
    "sqrt_method": lambda u, v, a: u.sqrt() < a,
    "rsqrt": lambda u, v, a: torch.rsqrt(u) < v + 0.5,
    "sin": lambda u, v, a: torch.sin(u * 25.0) > v,
    "cos": lambda u, v, a: u.cos() < v * 0.5,
    "tan": lambda u, v, a: torch.tan(u * 1.5) > a,
    "asin": lambda u, v, a: torch.asin(u) > v - 0.5,
    "acos": lambda u, v, a: torch.arccos(v) < a * 2.0,
    "atan": lambda u, v, a: torch.atan(u * 10.0) > v,
    "atan2": lambda u, v, a: torch.atan2(u - 0.5, v - 0.5) > a * 3.0,
    "sinh": lambda u, v, a: torch.sinh(u * 30.0) > v * 100.0,
    "cosh": lambda u, v, a: torch.cosh(u * 4.0) < a * 10.0,
    "tanh": lambda u, v, a: torch.tanh(u * 3.0) > v - 0.5,
    "asinh": lambda u, v, a: torch.asinh(u * 5.0) > v,
    "acosh": lambda u, v, a: torch.acosh(u * 3.0) < a,
    "atanh": lambda u, v, a: torch.atanh(u) > v,
    "exp": lambda u, v, a: torch.exp(u) > v * 5.0,
    "exp2": lambda u, v, a: torch.exp2(u * 3.0) > a * 8.0,
    "expm1": lambda u, v, a: torch.expm1(u * 1e-3) > v * 1e-3,
    "log": lambda u, v, a: torch.log(u) < v - 1.0,
    "log2": lambda u, v, a: torch.log2(u) > a,
    "log10": lambda u, v, a: torch.log10(v) < u - 1.0,
    "log1p": lambda u, v, a: torch.log1p(u) > v * 0.5,
    "pow": lambda u, v, a: u ** 2.2 > a * 0.5,
    "pow_tensor": lambda u, v, a: torch.pow(a, u) > v,
    "pow_scalar_base": lambda u, v, a: 2.0 ** u > v * 3.0,
    "pow_special": lambda u, v, a: (u ** 3 > v) ^ (u ** 0.5 < a) ^ (
        v ** -1 > a * 4.0) ^ (u ** 2 > a) ^ (v ** -0.5 < 1.2) ^ (
        a ** -2 > 3.0),
    "pow_int_float": lambda u, v, a: cell_in_range(u) ** 0.5 > v,
    "sigmoid": lambda u, v, a: torch.sigmoid(u * 4.0 - 2.0) > a,
    "erf": lambda u, v, a: torch.erf(u) > v - 0.2,
    "erfc": lambda u, v, a: torch.erfc(v) < a,
    "hypot": lambda u, v, a: torch.hypot(u, v) < a + 0.5,
    "special": lambda u, v, a: torch.special.expit(u) > torch.special.erf(v),
    "cr_int": lambda u, v, a: torch.sin(cell_in_range(u)) > 0.0,
    "cr_bool": lambda u, v, a: torch.exp(u > v) > a * 3.0,
    "cr_captured": lambda u, v, a: torch.atan2(u, HALF) > v,
    "perforated": perforated_pred,
})


def grid(n: int = 4096):
    """Seeded u, v, alpha: uniform values with negatives and values past
    1, exact cell edges (k/6, k/4, k/8), the checker's alpha cut 0.05,
    and far and edge values: past int32 after the casts' products, past
    1e5 (the slow path of sin and cos), near 88 (exp's overflow), zeros
    of both signs, subnormals, infinities and NaN."""
    rng = np.random.default_rng(11)
    k = np.arange(-12, 19, dtype=np.float32)
    edges = np.concatenate([k / np.float32(6), k / np.float32(4),
                            k / np.float32(8), np.float32([0.05, 0.3, 0.5,
                                                           0.75, 1.0])])
    far = np.float32([3.5e9, -7e9, 1e20, 2.5, -2.5, 0.1, 1e5, -1.5e5,
                      3.3e5, 1e6, 8.8e7, 88.5, 88.72, 88.8, 89.0, -87.5,
                      -104.0, 0.0, -0.0, 1e-40, -1e-41, 1.4e-45, 1.2e-38,
                      np.inf, -np.inf, np.nan])

    def one():
        a = np.concatenate([rng.uniform(-1.5, 2.5, n).astype(np.float32),
                            edges, far])
        return rng.permutation(a).astype(np.float32)

    return one(), one(), one()
