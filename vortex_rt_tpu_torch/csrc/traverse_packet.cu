// traverse_packet.cu — per-ray walk of the 8-wide fused BVH on Hopper.
//
// Replaces the XLA while_loop `trace_packets` of
// vortex_rt_tpu/ops/traverse_packet.py:202 (loop body :543-894) on the JAX
// main path's tables: flat 8-wide builds with fused node+leaf rows
// (WideArrays.fuse, ops/traverse_wide.py:208).  Same hits in the three
// modes: closest hit, bounded occlusion (the first hit inside t_max retires
// the ray) and the mixed wave of `occl_split` (rays below the split trace
// in occlusion mode, the rest closest-hit: the frame loop's merged
// shadow+bounce wave).
//
// Design.  One thread walks one ray.  The JAX loop walked packets of rays
// over the union of their paths, near-first by the packet-minimum child
// distance; only the hits must match, so each thread walks its own path,
// near-first by its own distance.  Per step the thread reads its fused row
// (32 node words, then the node's own leaf slots): the meta quarter first,
// then either the 8 quantized child boxes (slab tests, the JAX 19-comparator
// descending network, nearest child taken, the others deferred) or the
// leaf's Moller-Trumbore tests.  Deferred children are kept as the JAX
// body's packed words for width 8 (traverse_packet.py:634-643):
// `left << 4 | count` and 7 three-bit sorted slot ids, one entry per
// descended level, so a stack of depth + 4 entries cannot overflow; a pop
// takes the nearest deferred child and decrements the count in place until
// the entry is spent.
//
// What bounds it on this card: the latency of dependent row fetches.  Each
// step's row address comes from the previous step, so a warp waits one
// memory round trip per step; the fused table (14-40 MB at the shipped
// scenes) stays in the 50 MB L2.  Rows are read as 16-byte uint4 through
// the read-only path (__ldg), and only the parts a node kind needs.  This
// first version is simple and correct, not fast: no warp-level
// cooperation, no ray reordering, no persistent threads.
//
// Numerics match the JAX body and the plain PyTorch version bit for bit:
// the f32 slab test of `_slab_test` (corners g + f*s), the |d| < 1e-20
// reciprocal clamp of `_rcp_lane`, Moller-Trumbore in the op order of the
// JAX body, the leaf's (t, packed tid) fold then the fold into the ray's
// best hit, no contraction into FMA (built with -fmad=false and without
// --use_fast_math).
//
// Built by vortex_rt_tpu_torch/runtime/kernels.py with nvcc into a shared
// library with a plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

#define VRT_STACK_MAX 64
#define VRT_LARGE 1e30f
#define VRT_EPS 1e-6f
#define VRT_INT_MAX 2147483647
#define VRT_LEFT_MASK8 ((1u << 25) - 1u)
#define VRT_ROW_WORDS 32
#define VRT_BLOCK 128

namespace {

__device__ __forceinline__ float rcp_clamped(float d) {
    const float dd = (fabsf(d) < 1e-20f) ? ((d < 0.0f) ? -1e-20f : 1e-20f) : d;
    return 1.0f / dd;
}

__device__ __forceinline__ float qbyte(uint32_t w, int sh) {
    return (float)(int)((w >> sh) & 255u);
}

__device__ __forceinline__ void cswap_desc(float* ds, int* ix, int a, int b) {
    // descending network comparator: swap when d[a] < d[b]
    if (ds[a] < ds[b]) {
        const float tf = ds[a]; ds[a] = ds[b]; ds[b] = tf;
        const int ti = ix[a]; ix[a] = ix[b]; ix[b] = ti;
    }
}

__global__ void __launch_bounds__(VRT_BLOCK) traverse_packet_kernel(
        const uint4* __restrict__ fused,   // (N, row_words) words
        const float* __restrict__ o,       // (R, 3)
        const float* __restrict__ d,       // (R, 3)
        const float* __restrict__ limit,   // (R,) t_max (LARGE when none)
        const uint8_t* __restrict__ active,  // (R,) bool
        float* __restrict__ dist_out, float* __restrict__ bx_out,
        float* __restrict__ by_out, float* __restrict__ bz_out,
        int* __restrict__ tri_out, int* __restrict__ inst_out,
        int* __restrict__ steps_out,
        int n_rays, int n_nodes, int row_vec4, int lmax, int tri_bits,
        int max_steps, int occl_split) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n_rays) return;

    const float ox = o[3 * i + 0], oy = o[3 * i + 1], oz = o[3 * i + 2];
    const float dx = d[3 * i + 0], dy = d[3 * i + 1], dz = d[3 * i + 2];
    const float ivx = rcp_clamped(dx), ivy = rcp_clamped(dy), ivz = rcp_clamped(dz);
    const float lim = limit[i];
    const bool on = active[i] != 0;
    const bool occ = i < occl_split;

    // best_t doubles as the liveness register: dead lanes carry -LARGE and
    // never walk; an occlusion hit drops it to -LARGE and retires the ray
    float best_t = on ? lim : -VRT_LARGE;
    float bx = 0.0f, by = 0.0f;
    int tri = 0;

    int st0[VRT_STACK_MAX];   // left << 4 | deferred count
    int st1[VRT_STACK_MAX];   // 7 x 3-bit sorted slot ids
    int node = 0, sc = 0, steps = 0;
    bool alive = best_t > 0.0f;

    while (alive && steps < max_steps) {
        const int node_c = min(max(node, 0), n_nodes - 1);
        const uint4* row = fused + (size_t)node_c * row_vec4;
        const uint4 w5 = __ldg(row + 5);            // words 20..23
        const uint32_t meta = w5.z;
        const int kind = (int)(meta >> 29);
        const int nch = (int)((meta >> 25) & 15u);
        const int left = (int)(meta & VRT_LEFT_MASK8);
        const int leaf_n = (int)w5.w;

        int nxt = node;
        bool descended = false;
        if (kind == 0) {
            // ---- internal: 8 slab tests, far->near network, defer ----
            const uint4 w0 = __ldg(row + 0), w1 = __ldg(row + 1);
            const uint4 w2 = __ldg(row + 2), w3 = __ldg(row + 3);
            const uint4 w4 = __ldg(row + 4);
            const float gx = __uint_as_float(w0.x), gy = __uint_as_float(w0.y);
            const float gz = __uint_as_float(w0.z), sx = __uint_as_float(w0.w);
            const float sy = __uint_as_float(w1.x), sz = __uint_as_float(w1.y);
            const uint32_t ql[8] = {w1.z, w1.w, w2.x, w2.y, w2.z, w2.w, w3.x, w3.y};
            const uint32_t qh[8] = {w3.z, w3.w, w4.x, w4.y, w4.z, w4.w, w5.x, w5.y};
            float ds[8];
            int ix[8];
#pragma unroll
            for (int c = 0; c < 8; ++c) {
                const float lx = gx + qbyte(ql[c], 0) * sx;
                const float ly = gy + qbyte(ql[c], 8) * sy;
                const float lz = gz + qbyte(ql[c], 16) * sz;
                const float hx = gx + qbyte(qh[c], 0) * sx;
                const float hy = gy + qbyte(qh[c], 8) * sy;
                const float hz = gz + qbyte(qh[c], 16) * sz;
                const float t1x = (lx - ox) * ivx, t2x = (hx - ox) * ivx;
                const float t1y = (ly - oy) * ivy, t2y = (hy - oy) * ivy;
                const float t1z = (lz - oz) * ivz, t2z = (hz - oz) * ivz;
                const float tmin = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                                         fminf(t1z, t2z));
                const float tmax = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                                         fmaxf(t1z, t2z));
                const bool hit = (tmax >= tmin) && (tmax > 0.0f) && (tmin < best_t)
                    && (c < nch);
                ds[c] = hit ? tmin : -VRT_LARGE;
                ix[c] = c;
            }
            // the JAX body's 19-comparator network (traverse_packet.py:100)
            cswap_desc(ds, ix, 0, 2); cswap_desc(ds, ix, 1, 3);
            cswap_desc(ds, ix, 4, 6); cswap_desc(ds, ix, 5, 7);
            cswap_desc(ds, ix, 0, 4); cswap_desc(ds, ix, 1, 5);
            cswap_desc(ds, ix, 2, 6); cswap_desc(ds, ix, 3, 7);
            cswap_desc(ds, ix, 0, 1); cswap_desc(ds, ix, 2, 3);
            cswap_desc(ds, ix, 4, 5); cswap_desc(ds, ix, 6, 7);
            cswap_desc(ds, ix, 2, 4); cswap_desc(ds, ix, 3, 5);
            cswap_desc(ds, ix, 1, 4); cswap_desc(ds, ix, 3, 6);
            cswap_desc(ds, ix, 1, 2); cswap_desc(ds, ix, 3, 4);
            cswap_desc(ds, ix, 5, 6);
            int m = 0;
#pragma unroll
            for (int c = 0; c < 8; ++c) m += (ds[c] > -VRT_LARGE) ? 1 : 0;
            if (m >= 1) {
                // sorted far -> near: the nearest hit child sits at m - 1
                int child = ix[0];
#pragma unroll
                for (int c = 1; c < 8; ++c) child = (c == m - 1) ? ix[c] : child;
                nxt = left + child;
                descended = true;
                const int cnt_def = m - 1;
                if (cnt_def >= 1) {
                    int word1 = ix[0] & 7;
#pragma unroll
                    for (int j = 1; j < 7; ++j) word1 |= (ix[j] & 7) << (3 * j);
                    const int at = min(sc, VRT_STACK_MAX - 1);
                    st0[at] = (left << 4) | cnt_def;
                    st1[at] = word1;
                    ++sc;
                }
            }
        } else if (kind == 1) {
            // ---- triangle leaf: up to lmax Moller-Trumbore tests over the
            // row's own slots, folded to the leaf's best, then the ray's
            const float4* tr = reinterpret_cast<const float4*>(row) + VRT_ROW_WORDS / 4;
            float t_min = VRT_LARGE, w1_sel = 0.0f, w2_sel = 0.0f;
            int tid_sel = VRT_INT_MAX;
            for (int c = 0; c < lmax; ++c) {
                const float4 a4 = __ldg(tr + 4 * c + 0);  // v0x v0y v0z e1x
                const float4 b4 = __ldg(tr + 4 * c + 1);  // e1y e1z e2x e2y
                const float4 c4 = __ldg(tr + 4 * c + 2);  // e2z tid pad pad
                const float v0x = a4.x, v0y = a4.y, v0z = a4.z;
                const float e1x = a4.w, e1y = b4.x, e1z = b4.y;
                const float e2x = b4.z, e2y = b4.w, e2z = c4.x;
                const int tid = __float_as_int(c4.y);
                const float hx_ = dy * e2z - dz * e2y;
                const float hy_ = dz * e2x - dx * e2z;
                const float hz_ = dx * e2y - dy * e2x;
                const float a = e1x * hx_ + e1y * hy_ + e1z * hz_;
                const float fba = 1.0f / ((fabsf(a) < VRT_EPS) ? 1.0f : a);
                const float sx_ = ox - v0x, sy_ = oy - v0y, sz_ = oz - v0z;
                const float w1 = fba * (sx_ * hx_ + sy_ * hy_ + sz_ * hz_);
                const float qx = sy_ * e1z - sz_ * e1y;
                const float qy = sz_ * e1x - sx_ * e1z;
                const float qz = sx_ * e1y - sy_ * e1x;
                const float w2 = fba * (dx * qx + dy * qy + dz * qz);
                float t = fba * (e2x * qx + e2y * qy + e2z * qz);
                const bool ok = (fabsf(a) >= VRT_EPS) && (w1 >= 0.0f) && (w1 <= 1.0f)
                    && (w2 >= 0.0f) && (w1 + w2 <= 1.0f) && (t > VRT_EPS)
                    && (c < leaf_n);
                t = ok ? t : VRT_LARGE;
                const bool better = (t < t_min)
                    || ((t == t_min) && (t < VRT_LARGE) && (tid < tid_sel));
                if (better) {
                    t_min = t; tid_sel = tid; w1_sel = w1; w2_sel = w2;
                }
            }
            if (occ) {
                if (t_min < best_t) best_t = -VRT_LARGE;
            } else {
                const bool upd = (t_min < best_t)
                    || ((t_min == best_t) && (t_min < VRT_LARGE) && (tid_sel < tri));
                if (upd) {
                    best_t = t_min; bx = w1_sel; by = w2_sel; tri = tid_sel;
                }
            }
        }
        // (flat builds hold no instance nodes; any other kind pops)

        // pop when we didn't descend; the ray ends on an empty stack
        if (!descended) {
            if (sc > 0) {
                const int at = min(sc - 1, VRT_STACK_MAX - 1);
                const int top = st0[at];
                const int c_top = top & 15;
                const int slot = (st1[at] >> (3 * max(c_top - 1, 0))) & 7;
                nxt = (top >> 4) + slot;
                if (c_top > 1) {
                    st0[at] = top - 1;
                } else {
                    --sc;
                }
            } else {
                alive = false;
            }
        }
        if (occ && !(best_t > 0.0f)) alive = false;
        node = nxt;
        ++steps;
    }

    steps_out[i] = steps;
    bx_out[i] = bx;
    by_out[i] = by;
    bz_out[i] = 1.0f - bx - by;
    if (occ) {
        dist_out[i] = (on && best_t < 0.0f) ? 0.0f : VRT_LARGE;
    } else {
        // a real hit is strictly inside the clamp; unhit rays still carry
        // their initial t_max and report a miss
        dist_out[i] = (best_t < 0.0f || best_t >= lim) ? VRT_LARGE : best_t;
    }
    // leaf tids are packed (inst << tri_bits) | tri; misses carry 0
    tri_out[i] = tri & ((1 << tri_bits) - 1);
    inst_out[i] = tri >> tri_bits;
}

}  // namespace

extern "C" int vrt_traverse_packet_stack_max(void) { return VRT_STACK_MAX; }

extern "C" const char* vrt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// Launches the walk on `stream` and returns cudaGetLastError() (0 = ok).
// Pointers are device pointers of contiguous tensors; the caller
// allocates every output.
extern "C" int vrt_traverse_packet(
        const void* fused, const void* o, const void* d, const void* limit,
        const void* active, void* dist, void* bx, void* by, void* bz,
        void* tri, void* inst, void* steps,
        int n_rays, int n_nodes, int row_words, int lmax, int tri_bits,
        int stack_n, int max_steps, int occl_split, void* stream) {
    if (n_rays <= 0) return 0;
    if (stack_n > VRT_STACK_MAX || row_words < VRT_ROW_WORDS + 16 * lmax
            || (row_words - VRT_ROW_WORDS) % 16 != 0 || n_nodes <= 0
            || tri_bits <= 0 || tri_bits > 30) {
        return (int)cudaErrorInvalidValue;
    }
    const int grid = (n_rays + VRT_BLOCK - 1) / VRT_BLOCK;
    traverse_packet_kernel<<<grid, VRT_BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint4*)fused, (const float*)o, (const float*)d,
        (const float*)limit, (const uint8_t*)active,
        (float*)dist, (float*)bx, (float*)by, (float*)bz,
        (int*)tri, (int*)inst, (int*)steps,
        n_rays, n_nodes, row_words / 4, lmax, tri_bits, max_steps,
        occl_split);
    return (int)cudaGetLastError();
}
