// sort16.cuh — the order in which K1's 16-wide internal step
// (traverse_packet.cu) visits a node's hit children: far -> near, exactly
// as the JAX body's 16-slot network leaves them (Batcher's odd-even
// merge, 63 comparators, vortex_rt_tpu/ops/traverse_packet.py:78-102,
// applied at :609 and :976), computed from the hit children alone.
//
// The walk reads only positions 0..m-1 of the sorted permutation (m hit
// children: keys above -LARGE; culled slots are keyed -LARGE and sink
// below every hit): the nearest at m-1, the deferred ones at 0..m-2 in the
// stack entry.  When the m hit keys are distinct, any correct descending
// sort puts the same child at each of those positions.  When two are
// equal, the network's placement depends on its comparators (it is not
// stable), so that case runs the network itself.
//
// The sort is a selection from the nearest, two keys a pass: each hit
// key carries its slot in its 4 low bits (so the keys are distinct and a
// minimum names its child), the first pass takes the two least keys
// (three min/max operations a slot), each later pass the two least above
// the last one taken (five).  Two keys taken in a row that agree above
// the slot bits (an exact tie, keys within 16 ulps of each other, or +0
// and -0) stop it, and the network orders the node.  Keys that differ
// above the low 4 bits keep their order under the truncation, so the
// selection equals the network wherever it completes.
//
// What it saves: the network is 63 compare-and-swaps (about five
// instructions each) and a 16-step pack on every internal step; the
// selection costs nothing at m <= 1 (most steps on the shipped scenes)
// and about 100 instructions at m = 2.
//
// __host__ __device__ so that tests/test_torch_sort16.py builds it as host
// C++ (with the CUDA qualifiers defined away) against the JAX
// network in numpy.
#pragma once

#include <stdint.h>
#include <string.h>

// the bit casts and bit counts, as intrinsics on the card and as their
// portable equivalents in a host build
__host__ __device__ __forceinline__ uint32_t vrt_f2u(float f) {
#ifdef __CUDA_ARCH__
    return __float_as_uint(f);
#else
    uint32_t u;
    memcpy(&u, &f, sizeof u);
    return u;
#endif
}

__host__ __device__ __forceinline__ float vrt_u2f(uint32_t u) {
#ifdef __CUDA_ARCH__
    return __uint_as_float(u);
#else
    float f;
    memcpy(&f, &u, sizeof f);
    return f;
#endif
}

__host__ __device__ __forceinline__ int vrt_popc(uint32_t x) {
#ifdef __CUDA_ARCH__
    return __popc(x);
#else
    return __builtin_popcount(x);
#endif
}

// the lowest set bit's index + 1 (0 for 0)
__host__ __device__ __forceinline__ int vrt_ffs(uint32_t x) {
#ifdef __CUDA_ARCH__
    return __ffs((int)x);
#else
    return __builtin_ffs((int)x);
#endif
}

#define VRT_SORT16_INF vrt_u2f(0x7F800000u)

// descending network comparator: swap when d[a] < d[b]
__host__ __device__ __forceinline__ void vrt_cswap16(float* ds, int* ix, int a,
                                                     int b) {
    if (ds[a] < ds[b]) {
        const float tf = ds[a]; ds[a] = ds[b]; ds[b] = tf;
        const int ti = ix[a]; ix[a] = ix[b]; ix[b] = ti;
    }
}

// The JAX body's 16-slot network (traverse_packet.py:78-102: Batcher's
// odd-even merge, 63 comparators) over keys `ds` and slot ids `ix`.
__host__ __device__ __forceinline__ void vrt_net16(float* ds, int* ix) {
    vrt_cswap16(ds, ix, 0, 1); vrt_cswap16(ds, ix, 2, 3);
    vrt_cswap16(ds, ix, 4, 5); vrt_cswap16(ds, ix, 6, 7);
    vrt_cswap16(ds, ix, 8, 9); vrt_cswap16(ds, ix, 10, 11);
    vrt_cswap16(ds, ix, 12, 13); vrt_cswap16(ds, ix, 14, 15);
    vrt_cswap16(ds, ix, 0, 2); vrt_cswap16(ds, ix, 1, 3);
    vrt_cswap16(ds, ix, 4, 6); vrt_cswap16(ds, ix, 5, 7);
    vrt_cswap16(ds, ix, 8, 10); vrt_cswap16(ds, ix, 9, 11);
    vrt_cswap16(ds, ix, 12, 14); vrt_cswap16(ds, ix, 13, 15);
    vrt_cswap16(ds, ix, 1, 2); vrt_cswap16(ds, ix, 5, 6);
    vrt_cswap16(ds, ix, 9, 10); vrt_cswap16(ds, ix, 13, 14);
    vrt_cswap16(ds, ix, 0, 4); vrt_cswap16(ds, ix, 1, 5);
    vrt_cswap16(ds, ix, 2, 6); vrt_cswap16(ds, ix, 3, 7);
    vrt_cswap16(ds, ix, 8, 12); vrt_cswap16(ds, ix, 9, 13);
    vrt_cswap16(ds, ix, 10, 14); vrt_cswap16(ds, ix, 11, 15);
    vrt_cswap16(ds, ix, 2, 4); vrt_cswap16(ds, ix, 3, 5);
    vrt_cswap16(ds, ix, 10, 12); vrt_cswap16(ds, ix, 11, 13);
    vrt_cswap16(ds, ix, 1, 2); vrt_cswap16(ds, ix, 3, 4);
    vrt_cswap16(ds, ix, 5, 6); vrt_cswap16(ds, ix, 9, 10);
    vrt_cswap16(ds, ix, 11, 12); vrt_cswap16(ds, ix, 13, 14);
    vrt_cswap16(ds, ix, 0, 8); vrt_cswap16(ds, ix, 1, 9);
    vrt_cswap16(ds, ix, 2, 10); vrt_cswap16(ds, ix, 3, 11);
    vrt_cswap16(ds, ix, 4, 12); vrt_cswap16(ds, ix, 5, 13);
    vrt_cswap16(ds, ix, 6, 14); vrt_cswap16(ds, ix, 7, 15);
    vrt_cswap16(ds, ix, 4, 8); vrt_cswap16(ds, ix, 5, 9);
    vrt_cswap16(ds, ix, 6, 10); vrt_cswap16(ds, ix, 7, 11);
    vrt_cswap16(ds, ix, 2, 4); vrt_cswap16(ds, ix, 3, 5);
    vrt_cswap16(ds, ix, 6, 8); vrt_cswap16(ds, ix, 7, 9);
    vrt_cswap16(ds, ix, 10, 12); vrt_cswap16(ds, ix, 11, 13);
    vrt_cswap16(ds, ix, 1, 2); vrt_cswap16(ds, ix, 3, 4);
    vrt_cswap16(ds, ix, 5, 6); vrt_cswap16(ds, ix, 7, 8);
    vrt_cswap16(ds, ix, 9, 10); vrt_cswap16(ds, ix, 11, 12);
    vrt_cswap16(ds, ix, 13, 14);
}

// Slot s at sorted position p of the stack entry's words: positions 0..7
// in w1, 8..15 in w2, 4 bits each.
__host__ __device__ __forceinline__ void vrt_put16(uint32_t& w1, uint32_t& w2,
                                                   int p, int s) {
    if (p < 8) w1 |= (uint32_t)s << (4 * p);
    else w2 |= (uint32_t)s << (4 * (p - 8));
}

// The packed key's slot, and its key with the slot bits cleared.
__host__ __device__ __forceinline__ int vrt_slot16(float pk) {
    return (int)(vrt_f2u(pk) & 15u);
}

__host__ __device__ __forceinline__ float vrt_trunc16(float pk) {
    return vrt_u2f(vrt_f2u(pk) & ~15u);
}

// The two least packed keys (above `thr` when ABOVE) in a and b, +inf
// where there are fewer: three min/max operations a slot.
template <bool ABOVE>
__host__ __device__ __forceinline__ void vrt_least2(const float* pk, float thr,
                                                    float& a, float& b) {
    a = VRT_SORT16_INF;
    b = VRT_SORT16_INF;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
        const float x = (!ABOVE || pk[c] > thr) ? pk[c] : VRT_SORT16_INF;
        b = fminf(b, fmaxf(a, x));
        a = fminf(a, x);
    }
}

// The hit children (bit c of `hits` set: ds[c] > -LARGE; ds as the network
// sees them, culled slots -LARGE) in the network's order: positions
// 0..m-1 of its permutation in w1 and w2 (vrt_put16; the nibbles past
// m-1 are 0), m = popcount(hits).  Returns the nearest hit child (position
// m-1), or -1 when none is hit.
__host__ __device__ __forceinline__ int vrt_order16(const float* ds,
                                                    uint32_t hits,
                                                    uint32_t& w1,
                                                    uint32_t& w2) {
    const int m = vrt_popc(hits);
    w1 = 0u;
    w2 = 0u;
    if (m <= 1) {
        w1 = m ? (uint32_t)(vrt_ffs(hits) - 1) : 0u;
        return m ? vrt_ffs(hits) - 1 : -1;
    }
    // hit keys with their slot in the low 4 bits (distinct values); +inf
    // elsewhere
    float pk[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) {
        pk[c] = ((hits >> c) & 1u)
            ? vrt_u2f((vrt_f2u(ds[c]) & ~15u) | (uint32_t)c)
            : VRT_SORT16_INF;
    }
    // two keys a pass, nearest first, at positions m-1, m-2, ...; a pass
    // after the first takes the two least above the last one taken.  Two
    // keys in a row that agree above the slot bits stop it.
    float a, b;
    vrt_least2<false>(pk, 0.0f, a, b);
    int near = vrt_slot16(a);
    bool tie = false;
    for (int k = 0;; k += 2) {
        vrt_put16(w1, w2, m - 1 - k, vrt_slot16(a));
        if (k + 1 == m) break;
        if (vrt_trunc16(b) == vrt_trunc16(a)) {
            tie = true;
            break;
        }
        vrt_put16(w1, w2, m - 2 - k, vrt_slot16(b));
        if (k + 2 == m) break;
        const float last = b;
        vrt_least2<true>(pk, last, a, b);
        if (vrt_trunc16(a) == vrt_trunc16(last)) {
            tie = true;
            break;
        }
    }
    if (tie) {
        float d2[16];
        int ix[16];
#pragma unroll
        for (int c = 0; c < 16; ++c) {
            d2[c] = ds[c];
            ix[c] = c;
        }
        vrt_net16(d2, ix);
        w1 = 0u;
        w2 = 0u;
#pragma unroll
        for (int p = 0; p < 16; ++p) {
            if (p < m) vrt_put16(w1, w2, p, ix[p]);
            if (p == m - 1) near = ix[p];
        }
    }
    return near;
}
