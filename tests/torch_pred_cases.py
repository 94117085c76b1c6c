"""The op cases of the predicate compiler (``ops/anyhit_pred.py``): one
predicate per op of its set, and the seeded grid of (u, v, alpha) they
are decided on.  Imports neither JAX nor the JAX package: the CPU tests
(``test_torch_anyhit_pred.py``, the emitted C compiled for the host) and
the card's (``test_torch_gpu.py``, compiled by nvcc) share them."""

import numpy as np
import torch


def cell(u):
    return torch.floor(u * 6.0).to(torch.int32)


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


def grid(n: int = 4096):
    """Seeded u, v, alpha: uniform values with negatives and values past
    1, exact cell edges (k/6, k/4, k/8), the checker's alpha cut 0.05,
    and a few far values (past int32 after the casts' products)."""
    rng = np.random.default_rng(11)
    k = np.arange(-12, 19, dtype=np.float32)
    edges = np.concatenate([k / np.float32(6), k / np.float32(4),
                            k / np.float32(8), np.float32([0.05, 0.3, 0.5,
                                                           0.75, 1.0])])
    far = np.float32([3.5e9, -7e9, 1e20, 2.5, -2.5, 0.1])

    def one():
        a = np.concatenate([rng.uniform(-1.5, 2.5, n).astype(np.float32),
                            edges, far])
        return rng.permutation(a).astype(np.float32)

    return one(), one(), one()
