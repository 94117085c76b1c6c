"""The order of K1's 16-wide internal step (``csrc/sort16.cuh``) against the
JAX body's 16-slot network, on the CPU.

The header's ``vrt_order16`` is compiled as host C++ (``$CXX``, with a
shim that defines the CUDA qualifiers away) into one program that orders
every case; the reference applies the JAX ``_SORT_NET[16]`` (Batcher's
odd-even merge, ``vortex_rt_tpu/ops/traverse_packet.py:78-102``) in numpy,
swapping when ``d[a] < d[b]``.  For each case (16 keys as the network sees
them: hit children's entry distances above -LARGE, culled slots -LARGE or
below) the nearest hit child and the stack entry's two words (positions
0..m-1 of the network's permutation, 4 bits each) must be equal.  Every hit
count m from 0 to 16 in each family of keys: distinct, nodes with fewer
than 16 children, culled slots keyed at or below -LARGE, exact ties in
pairs, in triples and all equal, near ties within a few ulps, signed zeros
and subnormals, negative keys.
"""

import subprocess

import numpy as np
import pytest

from vortex_rt_tpu.ops.traverse_packet import _SORT_NET

from vortex_rt_tpu_torch.runtime import kernels, native

LARGE = np.float32(1e30)
PER_M = 40  # cases a hit count and family

_SHIM = r"""
#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#define __host__
#define __device__
#define __forceinline__ inline
#include "sort16.cuh"

int main(int argc, char** argv) {
    FILE* f = fopen(argv[1], "rb");
    long n;
    if (fread(&n, sizeof n, 1, f) != 1) return 1;
    float* ds = (float*)malloc(16 * n * sizeof(float));
    if (fread(ds, sizeof(float), 16 * n, f) != (size_t)(16 * n)) return 1;
    fclose(f);
    int32_t* out = (int32_t*)malloc(3 * n * sizeof(int32_t));
    for (long i = 0; i < n; ++i) {
        const float* d = ds + 16 * i;
        uint32_t hits = 0u;
        for (int c = 0; c < 16; ++c)
            if (d[c] > -1e30f) hits |= 1u << c;
        uint32_t w1, w2;
        out[3 * i] = vrt_order16(d, hits, w1, w2);
        out[3 * i + 1] = (int32_t)w1;
        out[3 * i + 2] = (int32_t)w2;
    }
    f = fopen(argv[2], "wb");
    fwrite(out, sizeof(int32_t), 3 * n, f);
    fclose(f);
    return 0;
}
"""


def network(d):
    """The JAX network over (N, 16) keys: (near slot or -1, word of
    positions 0..7, word of 8..15), each position past m-1 as 0."""
    d = d.copy()
    ix = np.broadcast_to(np.arange(16), d.shape).copy()
    m = (d > -LARGE).sum(1)
    for a, b in _SORT_NET[16]:
        swap = d[:, a] < d[:, b]
        d[:, [a, b]] = np.where(swap[:, None], d[:, [b, a]], d[:, [a, b]])
        ix[:, [a, b]] = np.where(swap[:, None], ix[:, [b, a]], ix[:, [a, b]])
    pos = np.arange(16)
    nib = np.where(pos < m[:, None], ix, 0).astype(np.uint32) << (4 * (pos % 8))
    w1 = np.bitwise_or.reduce(nib[:, :8], 1)
    w2 = np.bitwise_or.reduce(nib[:, 8:], 1)
    near = np.where(m > 0, ix[np.arange(len(d)), np.maximum(m - 1, 0)], -1)
    return near, w1, w2, m


def _hit_keys(rng, family, n):
    """``n`` keys of hit children in ``family``."""
    if family in ("distinct", "nch_below_16", "culled"):
        return rng.uniform(-2.0, 40.0, n)
    if family == "ties_pairs":
        return np.repeat(rng.uniform(0.0, 10.0, (n + 1) // 2), 2)[:n]
    if family == "ties_triples":
        return np.repeat(rng.uniform(-1.0, 10.0, (n + 2) // 3), 3)[:n]
    if family == "all_equal":
        return np.full(n, rng.uniform(0.0, 10.0))
    if family == "near_ties":
        base = np.float32(rng.uniform(0.5, 8.0))
        ulps = rng.integers(-20, 21, n)
        return (base.view(np.int32) + ulps).astype(np.int32).view(np.float32)
    if family == "signed_zero":
        sub = np.float32(1e-45) * rng.integers(-40, 41, n)
        return np.where(rng.random(n) < 0.5, np.where(
            rng.random(n) < 0.5, np.float32(-0.0), np.float32(0.0)), sub)
    if family == "negative":
        return -np.abs(rng.choice(rng.uniform(0.0, 5.0, 4), n))
    raise KeyError(family)


FAMILIES = ("distinct", "nch_below_16", "culled", "ties_pairs",
            "ties_triples", "all_equal", "near_ties", "signed_zero",
            "negative")


def cases(family, seed=0):
    """(N, 16) float32 keys: ``PER_M`` cases for every hit count 0..16."""
    rng = np.random.default_rng([seed, FAMILIES.index(family)])
    out = []
    for m in range(17):
        for _ in range(PER_M):
            d = np.full(16, -LARGE, np.float32)
            if family == "culled":  # keys at and below -LARGE also sink
                d = rng.choice(np.array([-LARGE, -np.inf, -3e30, -LARGE],
                                        np.float32), 16)
            nch = (int(rng.integers(m, 16)) if family == "nch_below_16"
                   and m < 16 else 16)
            slots = rng.permutation(nch)[:m]
            d[slots] = _hit_keys(rng, family, m).astype(np.float32)
            out.append(d)
    return np.stack(out)


@pytest.fixture(scope="module")
def order16(tmp_path_factory):
    """The header's order of (N, 16) keys, by one host program built once:
    a function of the keys returning (near, w1, w2)."""
    d = tmp_path_factory.mktemp("sort16")
    (d / "main.cpp").write_text(_SHIM)
    exe = d / "order16"
    proc = subprocess.run(
        [native.cxx_path(), "-std=c++17", "-O1", "-ffp-contract=off",
         "-fno-fast-math", "-I", str(kernels.SRC_DIR), "-o", str(exe),
         str(d / "main.cpp")], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr

    def run(keys):
        with open(d / "in.bin", "wb") as f:
            f.write(np.int64(keys.shape[0]).tobytes())
            f.write(np.ascontiguousarray(keys, np.float32).tobytes())
        subprocess.run([str(exe), str(d / "in.bin"), str(d / "out.bin")],
                       check=True, timeout=60)
        got = np.fromfile(d / "out.bin", np.int32).reshape(-1, 3)
        return got[:, 0], got[:, 1].view(np.uint32), got[:, 2].view(np.uint32)

    return run


@pytest.mark.parametrize("family", FAMILIES)
def test_order16_equals_the_jax_network(order16, family):
    """Positions 0..m-1 of the header's order (its nearest child and both
    stack words) equal the JAX network's on every case of ``family``, at
    every m from 0 to 16."""
    keys = cases(family)
    near, w1, w2 = order16(keys)
    want_near, want_w1, want_w2, m = network(keys)
    assert sorted(set(m.tolist())) == list(range(17))
    bad = np.flatnonzero((near != want_near) | (w1 != want_w1)
                         | (w2 != want_w2))
    assert bad.size == 0, (
        f"{family}: {bad.size} of {len(keys)} cases differ, e.g. keys "
        f"{keys[bad[0]].tolist()}: near {near[bad[0]]} vs {want_near[bad[0]]},"
        f" words {w1[bad[0]]:#x} {w2[bad[0]]:#x} vs {want_w1[bad[0]]:#x} "
        f"{want_w2[bad[0]]:#x}")
    if family.startswith("ties") or family == "all_equal":
        # exact ties among the hit keys, where the network is not stable
        hit = np.where(keys > -LARGE, keys, np.nan)
        srt = np.sort(hit, 1)
        assert bool((srt[:, 1:] == srt[:, :-1]).any())
