// packet_walk.cu — per-ray walk of the 4-wide quantized BVH on Hopper.
//
// Replaces the Pallas TPU kernel `_walk_kernel`, launched by
// `trace_packets_pallas` (vortex_rt_tpu/ops/pallas/packet_walk.py:66 and
// :271).  Same hits in the same two modes: closest hit, and bounded
// occlusion (the first hit inside t_max retires the ray).  Flat builds and
// TLAS+BLAS builds with instance nodes.
//
// Design.  One thread walks one ray.  The TPU kernel walked one 1024-ray
// packet per program over the union of its rays' paths (the packet-min child
// distance, packet_walk.py:143); that union walk is not carried over, only
// the hits must match.  Each thread keeps its node index, a full stack of
// 3*(depth+2)+8 entries in local memory and its best hit in registers, and
// on each step switches on the node kind exactly as the TPU kernel does:
// internal (4 dequantized slab tests + a 5-comparator near-to-far sort,
// far children pushed), triangle leaf (up to lmax Moller-Trumbore tests),
// instance (affine ray transform, descend to the BLAS root in word 28).
//
// What bounds it on this card: the latency of dependent 128-byte row
// fetches.  Each step's node address comes from the previous step, so a
// warp waits one memory round trip per step; the tables (a few MB) stay in
// the 50 MB L2.  Rows are read as 16-byte uint4/float4 through the
// read-only path (__ldg), and only the row quarter a node kind needs.
// This first version is simple and correct, not fast: no warp-level
// cooperation, no ray reordering, no persistent threads.
//
// Alpha mode (`vrt_packet_walk_alpha`, the kernel's ALPHA = true
// instantiation): a candidate that passes Moller-Trumbore is kept only if
// its surface alpha is not below the threshold (alpha_test.cuh), read from
// the leaf's alpha row `alpha_rows[left]` (32 B a slot) and the alpha pool.
// The TPU kernel refused any-hit, and the JAX frame ran its 4-wide alpha
// waves through the XLA `trace_packets(alpha_ref)` (engine/wavefront.py:
// 384-390, traverse_packet.py:1057-1085); this is that test in this walk.
// The ALPHA = false instantiation is the walk above, unchanged.
//
// Numerics match the JAX body and the plain PyTorch version bit for bit:
// the same arithmetic order, the |d| < 1e-20 reciprocal clamp, the
// |a| < eps Moller-Trumbore guard, and no contraction into FMA (built with
// -fmad=false and without --use_fast_math).
//
// Built by vortex_rt_tpu_torch/runtime/kernels.py with nvcc into a shared
// library with a plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "alpha_test.cuh"

#define VRT_STACK_MAX 128
#define VRT_LARGE 1e30f
#define VRT_EPS 1e-6f
#define VRT_LEFT_MASK ((1u << 26) - 1u)
#define VRT_BLOCK 128

namespace {

__device__ __forceinline__ float rcp_clamped(float d) {
    const float dd = (fabsf(d) < 1e-20f) ? ((d < 0.0f) ? -1e-20f : 1e-20f) : d;
    return 1.0f / dd;
}

__device__ __forceinline__ float qbyte(uint32_t w, int sh) {
    return (float)(int)((w >> sh) & 255u);
}

// Alpha-mode inputs (ALPHA = true only): the (L, alpha_words) alpha rows,
// the pool and its length, and the threshold.
struct AlphaArgs {
    const float4* rows;
    int row_vec4;
    const float* pool;
    int n_pool;
    float thr;
};

template <bool ALPHA>
__global__ void __launch_bounds__(VRT_BLOCK) packet_walk_kernel(
        const uint4* __restrict__ nodes,   // (N, 32) words = 8 uint4 per row
        const float4* __restrict__ rows,   // (L, row_words) floats
        const float* __restrict__ o,       // (R, 3)
        const float* __restrict__ d,       // (R, 3)
        const float* __restrict__ limit,   // (R,) t_max, or -1 for dead rays
        float* __restrict__ dist_out, float* __restrict__ bx_out,
        float* __restrict__ by_out, float* __restrict__ bz_out,
        int* __restrict__ tri_out, int* __restrict__ inst_out,
        int* __restrict__ steps_out,
        int n_rays, int n_nodes, int n_rows, int row_vec4, int lmax,
        int num_tlas, int tri_bits, int max_steps, int occlusion,
        const AlphaArgs alpha) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n_rays) return;

    const float ox = o[3 * i + 0], oy = o[3 * i + 1], oz = o[3 * i + 2];
    const float dx = d[3 * i + 0], dy = d[3 * i + 1], dz = d[3 * i + 2];
    const float lim = limit[i];
    const float ivx = rcp_clamped(dx), ivy = rcp_clamped(dy), ivz = rcp_clamped(dz);

    // instance-local ray (equal to the world ray until an instance node)
    float lox = ox, loy = oy, loz = oz;
    float ldx = dx, ldy = dy, ldz = dz;
    float lix = ivx, liy = ivy, liz = ivz;
    int inst = 0;

    // best_t doubles as the liveness/clamp register: dead rays enter with
    // -1 and never pass a box test; in occlusion mode a hit sets it to -1
    float best_t = lim, bx = 0.0f, by = 0.0f;
    int tri = 2147483647, binst = 0;

    int stack[VRT_STACK_MAX];
    int node = 0, sc = 0, steps = 0;
    bool alive = lim > 0.0f;

    while (alive && steps < max_steps) {
        const int node_c = min(max(node, 0), n_nodes - 1);
        const uint4* nrow = nodes + (size_t)node_c * 8;
        const uint4 w3 = __ldg(nrow + 3);           // words 12..15
        const uint32_t meta = w3.z;
        const int kind = min((int)(meta >> 29), 2);
        const int nch = (int)((meta >> 26) & 7u);
        const int left = (int)(meta & VRT_LEFT_MASK);
        const int leaf_n = (int)w3.w;
        const bool in_tlas = node_c < num_tlas;

        int nxt = node;
        bool descended = false;
        if (kind == 0) {
            // ---- internal: 4 slab tests, near->far sort, push far ----
            const uint4 w0 = __ldg(nrow + 0);       // words 0..3
            const uint4 w1 = __ldg(nrow + 1);       // words 4..7
            const uint4 w2 = __ldg(nrow + 2);       // words 8..11
            const float gx = __uint_as_float(w0.x), gy = __uint_as_float(w0.y);
            const float gz = __uint_as_float(w0.z), sx = __uint_as_float(w0.w);
            const float sy = __uint_as_float(w1.x), sz = __uint_as_float(w1.y);
            const uint32_t ql[4] = {w1.z, w1.w, w2.x, w2.y};
            const uint32_t qh[4] = {w2.z, w2.w, w3.x, w3.y};
            const float rox = in_tlas ? ox : lox, roy = in_tlas ? oy : loy;
            const float roz = in_tlas ? oz : loz;
            const float rix = in_tlas ? ivx : lix, riy = in_tlas ? ivy : liy;
            const float riz = in_tlas ? ivz : liz;
            float ds[4];
            int ix[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const float lx = gx + qbyte(ql[c], 0) * sx;
                const float ly = gy + qbyte(ql[c], 8) * sy;
                const float lz = gz + qbyte(ql[c], 16) * sz;
                const float hx = gx + qbyte(qh[c], 0) * sx;
                const float hy = gy + qbyte(qh[c], 8) * sy;
                const float hz = gz + qbyte(qh[c], 16) * sz;
                const float t1x = (lx - rox) * rix, t2x = (hx - rox) * rix;
                const float t1y = (ly - roy) * riy, t2y = (hy - roy) * riy;
                const float t1z = (lz - roz) * riz, t2z = (hz - roz) * riz;
                const float tmin = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                                         fminf(t1z, t2z));
                const float tmax = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                                         fmaxf(t1z, t2z));
                const bool hit = (tmax >= tmin) && (tmax > 0.0f) && (tmin < best_t);
                ds[c] = (hit && c < nch) ? tmin : VRT_LARGE;
                ix[c] = c;
            }
            // sorting network (0,1) (2,3) (0,2) (1,3) (1,2), swap on '>'
            const int na[5] = {0, 2, 0, 1, 1};
            const int nb[5] = {1, 3, 2, 3, 2};
#pragma unroll
            for (int k = 0; k < 5; ++k) {
                const int a = na[k], b = nb[k];
                if (ds[a] > ds[b]) {
                    const float tf = ds[a]; ds[a] = ds[b]; ds[b] = tf;
                    const int ti = ix[a]; ix[a] = ix[b]; ix[b] = ti;
                }
            }
#pragma unroll
            for (int j = 3; j >= 1; --j) {
                if (ds[j] < VRT_LARGE) {
                    stack[min(sc, VRT_STACK_MAX - 1)] = left + ix[j];
                    ++sc;
                }
            }
            if (ds[0] < VRT_LARGE) {
                nxt = left + ix[0];
                descended = true;
            }
        } else if (kind == 1) {
            // ---- triangle leaf: up to lmax Moller-Trumbore tests ----
            const int row_i = min(max(left, 0), n_rows - 1);
            const float4* tr = rows + (size_t)row_i * row_vec4;
            for (int c = 0; c < lmax; ++c) {
                const float4 a4 = __ldg(tr + 4 * c + 0);  // v0x v0y v0z e1x
                const float4 b4 = __ldg(tr + 4 * c + 1);  // e1y e1z e2x e2y
                const float4 c4 = __ldg(tr + 4 * c + 2);  // e2z tid pad pad
                const float v0x = a4.x, v0y = a4.y, v0z = a4.z;
                const float e1x = a4.w, e1y = b4.x, e1z = b4.y;
                const float e2x = b4.z, e2y = b4.w, e2z = c4.x;
                const int tid = __float_as_int(c4.y);
                const float hx_ = ldy * e2z - ldz * e2y;
                const float hy_ = ldz * e2x - ldx * e2z;
                const float hz_ = ldx * e2y - ldy * e2x;
                const float a = e1x * hx_ + e1y * hy_ + e1z * hz_;
                const float fba = 1.0f / ((fabsf(a) < VRT_EPS) ? 1.0f : a);
                const float sx_ = lox - v0x, sy_ = loy - v0y, sz_ = loz - v0z;
                const float w1 = fba * (sx_ * hx_ + sy_ * hy_ + sz_ * hz_);
                const float qx = sy_ * e1z - sz_ * e1y;
                const float qy = sz_ * e1x - sx_ * e1z;
                const float qz = sx_ * e1y - sy_ * e1x;
                const float w2 = fba * (ldx * qx + ldy * qy + ldz * qz);
                float t = fba * (e2x * qx + e2y * qy + e2z * qz);
                bool ok = (fabsf(a) >= VRT_EPS) && (w1 >= 0.0f) && (w1 <= 1.0f)
                    && (w2 >= 0.0f) && (w1 + w2 <= 1.0f) && (t > VRT_EPS)
                    && (c < leaf_n);
                if (ALPHA && ok) {
                    const float4* al = alpha.rows + (size_t)row_i * alpha.row_vec4
                        + 2 * c;
                    ok = vrt_alpha_keep(__ldg(al), __ldg(al + 1), w1, w2,
                                        alpha.pool, alpha.n_pool, alpha.thr);
                }
                t = ok ? t : VRT_LARGE;
                if (occlusion) {
                    if (t < best_t) best_t = -1.0f;
                } else {
                    const bool better = (t < best_t)
                        || ((t == best_t) && (t < VRT_LARGE) && (tid < tri));
                    if (better) {
                        best_t = t; bx = w1; by = w2; tri = tid; binst = inst;
                    }
                }
            }
        } else {
            // ---- instance: world ray -> instance space, descend to BLAS ----
            const uint4 w4 = __ldg(nrow + 4), w5 = __ldg(nrow + 5);
            const uint4 w6 = __ldg(nrow + 6), w7 = __ldg(nrow + 7);
            const float m0 = __uint_as_float(w4.x), m1 = __uint_as_float(w4.y);
            const float m2 = __uint_as_float(w4.z), m3 = __uint_as_float(w4.w);
            const float m4 = __uint_as_float(w5.x), m5 = __uint_as_float(w5.y);
            const float m6 = __uint_as_float(w5.z), m7 = __uint_as_float(w5.w);
            const float m8 = __uint_as_float(w6.x), m9 = __uint_as_float(w6.y);
            const float m10 = __uint_as_float(w6.z), m11 = __uint_as_float(w6.w);
            lox = m0 * ox + m1 * oy + m2 * oz + m3;
            loy = m4 * ox + m5 * oy + m6 * oz + m7;
            loz = m8 * ox + m9 * oy + m10 * oz + m11;
            ldx = m0 * dx + m1 * dy + m2 * dz;
            ldy = m4 * dx + m5 * dy + m6 * dz;
            ldz = m8 * dx + m9 * dy + m10 * dz;
            lix = rcp_clamped(ldx); liy = rcp_clamped(ldy); liz = rcp_clamped(ldz);
            inst = left;
            nxt = (int)w7.x;
            descended = true;
        }

        // pop when we didn't descend; the ray ends on an empty stack
        if (!descended) {
            if (sc > 0) {
                --sc;
                nxt = stack[min(sc, VRT_STACK_MAX - 1)];
            } else {
                alive = false;
            }
        }
        if (occlusion && !(best_t > 0.0f)) alive = false;
        node = nxt;
        ++steps;
    }

    steps_out[i] = steps;
    bx_out[i] = bx;
    by_out[i] = by;
    bz_out[i] = 1.0f - bx - by;
    if (occlusion) {
        const bool occluded = (lim > 0.0f) && (best_t < 0.0f);
        dist_out[i] = occluded ? 0.0f : VRT_LARGE;
        tri_out[i] = 0;
        inst_out[i] = binst;
    } else {
        // a real hit is strictly inside the clamp; unhit rays still carry
        // their initial t_max and report a miss
        const bool miss = (best_t < 0.0f) || (best_t >= lim);
        int t_id = miss ? 0 : tri;
        int i_id = binst;
        if (num_tlas == 0 && tri_bits > 0) {
            // flattened build: leaf tids are packed (inst << tri_bits) | tri
            i_id = t_id >> tri_bits;
            t_id = t_id & ((1 << tri_bits) - 1);
        }
        dist_out[i] = miss ? VRT_LARGE : best_t;
        tri_out[i] = t_id;
        inst_out[i] = i_id;
    }
}

}  // namespace

extern "C" int vrt_packet_walk_stack_max(void) { return VRT_STACK_MAX; }

extern "C" const char* vrt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// Launches the walk on `stream` and returns cudaGetLastError() (0 = ok).
// Pointers are device pointers of contiguous tensors; the caller
// allocates every output.
extern "C" int vrt_packet_walk(
        const void* nodes, const void* rows, const void* o, const void* d,
        const void* limit, void* dist, void* bx, void* by, void* bz,
        void* tri, void* inst, void* steps,
        int n_rays, int n_nodes, int n_rows, int row_words, int lmax,
        int num_tlas, int tri_bits, int stack_n, int max_steps, int occlusion,
        void* stream) {
    if (n_rays <= 0) return 0;
    if (stack_n > VRT_STACK_MAX || row_words % 16 != 0 || lmax * 16 > row_words
            || n_nodes <= 0 || n_rows <= 0) {
        return (int)cudaErrorInvalidValue;
    }
    const int grid = (n_rays + VRT_BLOCK - 1) / VRT_BLOCK;
    packet_walk_kernel<false><<<grid, VRT_BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint4*)nodes, (const float4*)rows, (const float*)o,
        (const float*)d, (const float*)limit,
        (float*)dist, (float*)bx, (float*)by, (float*)bz,
        (int*)tri, (int*)inst, (int*)steps,
        n_rays, n_nodes, n_rows, row_words / 4, lmax, num_tlas, tri_bits,
        max_steps, occlusion, AlphaArgs{nullptr, 0, nullptr, 0, 0.0f});
    return (int)cudaGetLastError();
}

// The alpha mode: as vrt_packet_walk, with the (n_rows, alpha_words) alpha
// rows (8 words a slot), the alpha pool of n_pool floats and the
// threshold `thr`.
extern "C" int vrt_packet_walk_alpha(
        const void* nodes, const void* rows, const void* o, const void* d,
        const void* limit, void* dist, void* bx, void* by, void* bz,
        void* tri, void* inst, void* steps, const void* alpha_rows,
        const void* alpha_pool,
        int n_rays, int n_nodes, int n_rows, int row_words, int lmax,
        int num_tlas, int tri_bits, int stack_n, int max_steps, int occlusion,
        int alpha_words, int n_pool, float thr, void* stream) {
    if (n_rays <= 0) return 0;
    if (stack_n > VRT_STACK_MAX || row_words % 16 != 0 || lmax * 16 > row_words
            || n_nodes <= 0 || n_rows <= 0 || alpha_words % 4 != 0
            || lmax * 8 > alpha_words || n_pool <= 0) {
        return (int)cudaErrorInvalidValue;
    }
    const int grid = (n_rays + VRT_BLOCK - 1) / VRT_BLOCK;
    packet_walk_kernel<true><<<grid, VRT_BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint4*)nodes, (const float4*)rows, (const float*)o,
        (const float*)d, (const float*)limit,
        (float*)dist, (float*)bx, (float*)by, (float*)bz,
        (int*)tri, (int*)inst, (int*)steps,
        n_rays, n_nodes, n_rows, row_words / 4, lmax, num_tlas, tri_bits,
        max_steps, occlusion,
        AlphaArgs{(const float4*)alpha_rows, alpha_words / 4,
                  (const float*)alpha_pool, n_pool, thr});
    return (int)cudaGetLastError();
}
