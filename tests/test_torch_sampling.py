"""The port's counter-based sampler is bit-identical to the JAX package's
NumPy path (``vortex_rt_tpu/utils/sampling.py``), including u32
wraparound: torch's uint32 tensors lack ``+``, ``>>`` and ``%``, so the
port computes in int64 masked to 32 bits."""

import numpy as np
import pytest
import torch

from vortex_rt_tpu.utils import sampling as js
from vortex_rt_tpu_torch.utils import sampling as ts

# values that exercise the 32-bit wraparound of every add and multiply
_EDGES = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0x9E3779B9,
                   0xFFFFFFFE, 0xFFFFFFFF], np.uint32)


def _u32(seed: int, n: int = 4096) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.concatenate([_EDGES, rng.integers(0, 2**32, n, dtype=np.uint64)
                           .astype(np.uint32)])


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.int64))


def _as_u32(t: torch.Tensor) -> np.ndarray:
    out = t.numpy()
    assert out.min() >= 0 and out.max() < 2**32
    return out.astype(np.uint32)


@pytest.mark.parametrize("seed", [0, 1])
def test_pcg_bit_identical(seed):
    v = _u32(seed)
    np.testing.assert_array_equal(_as_u32(ts.pcg(_t(v))), js.pcg(np, v))


@pytest.mark.parametrize("scalars", [False, True])
def test_hash3_bit_identical(scalars):
    a, b, c = _u32(2), _u32(3), _u32(4)
    if scalars:  # b, c broadcast from Python ints near the u32 limit
        b, c = 0xFFFFFFFF, 0x80000001
        tb, tc = b, c
    else:
        tb, tc = _t(b), _t(c)
    np.testing.assert_array_equal(_as_u32(ts.hash3(_t(a), tb, tc)),
                                  js.hash3(np, a, b, c))


def test_u01_bit_identical():
    v = _u32(5)
    got = ts.u01(_t(v)).numpy()
    want = js.u01(np, v)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("dim,seed", [(0, 0), (1, 7), (2, 0xFFFFFFFF),
                                      (7, 123456789)])
def test_sample2_bit_identical(dim, seed):
    pix = _u32(6, 2048)
    samp = _u32(7, 2048)
    bounce = (np.arange(pix.shape[0]) % 5).astype(np.uint32)
    u_t, v_t = ts.sample2(_t(pix), _t(samp), _t(bounce), seed, dim=dim)
    u_n, v_n = js.sample2(np, pix, samp, bounce, seed, dim=dim)
    np.testing.assert_array_equal(u_t.numpy().view(np.uint32),
                                  u_n.view(np.uint32))
    np.testing.assert_array_equal(v_t.numpy().view(np.uint32),
                                  v_n.view(np.uint32))


@pytest.mark.parametrize("total_spp", [1, 2, 4, 5, 9])
def test_stratified_jitter_bit_identical(total_spp):
    pix = np.arange(3000, dtype=np.uint32) * np.uint32(2654435761)
    samp = (np.arange(3000) % (2 * total_spp)).astype(np.uint32) \
        + np.uint32(0xFFFFFFF0)
    jx_t, jy_t = ts.stratified_jitter(_t(pix), _t(samp), total_spp, 3)
    jx_n, jy_n = js.stratified_jitter(np, pix, samp, total_spp, 3)
    np.testing.assert_array_equal(jx_t.numpy().view(np.uint32),
                                  np.asarray(jx_n, np.float32).view(np.uint32))
    np.testing.assert_array_equal(jy_t.numpy().view(np.uint32),
                                  np.asarray(jy_n, np.float32).view(np.uint32))
    assert ((jx_t >= 0) & (jx_t < 1)).all()
