// packet_walk.cu — per-ray walk of the 4-wide quantized BVH on Hopper (K2).
//
// Replaces the Pallas TPU kernel `_walk_kernel`, launched by
// `trace_packets_pallas` (vortex_rt_tpu/ops/pallas/packet_walk.py:66 and
// :271).  Same hits in the same two modes: closest hit, and bounded
// occlusion (the first hit inside t_max retires the ray).  Flat builds and
// TLAS+BLAS builds with instance nodes.
//
// The walk.  One thread walks one ray.  The TPU kernel walked one 1024-ray
// packet per program over the union of its rays' paths (the packet-min child
// distance, packet_walk.py:143); that union walk is not carried over, only
// the hits must match.  At an internal node the 4 dequantized slab tests
// and the TPU kernel's 5-comparator near-to-far sort pick the nearest hit
// child; the others are deferred.  A triangle leaf runs up to lmax
// Moller-Trumbore tests in its row; an instance node moves the ray into
// instance space (the affine transform in words 16-27) and descends to the
// BLAS root in word 28 without deferring anything.  Every ray visits the
// same nodes, and takes the same steps, as in the plain PyTorch version
// (ops/packet_walk.py).
//
// What bounds it on this card: dependent row fetches (each step's node
// comes from the last step; the tables, a few to tens of MB, stay in the
// 50 MB L2) and instruction issue.  The design is K1's
// (traverse_packet.cu), at width 4:
// - quantized bytes decode exactly with PRMT + FADD, not an int -> float
//   conversion: the byte goes into the low mantissa byte of 2^23 and 2^23
//   is taken off;
// - deferred children are one packed 8-B entry a descended level:
//   `left << 2 | count` and up to three 2-bit sorted slot ids, nearest
//   first.  A pop takes the nearest deferred child and shifts it out in
//   place until the entry is spent.  This is the order of the first
//   version's separate pushes (far to near, so the nearest pops first), and
//   the stack needs depth + 4 entries where it needed 3 * (depth + 2) + 8;
// - the stack lives in shared memory, sized at launch, entry e of thread t
//   at [e * VRT_BLOCK + t] (no bank conflicts), so the kernel keeps no
//   local-memory stack frame;
// - one loop whose iteration is an internal step for the lanes at an
//   internal node, then a leaf or instance step for the lanes at one.
//   K1's while-while (internal steps while any lane is at one, then leaf
//   steps) measured 14% slower on config 2's 4-wide waves, as fast on the
//   atrium's 1080p TLAS wave, 3% faster on row 6's alpha wave
//   (tools/walk_timing.py --variants, PERF.md);
// - a step reads the row's meta quarter (words 12-15) first and the child
//   boxes (words 0-11) only at an internal node, the transform only at an
//   instance node;
// - the nearest child comes out of the sorted slot ids packed 2 bits each
//   by one mask, the next one by a shift.
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
// Statistics (`vrt_packet_walk_stats`, `vrt_packet_walk_alpha_stats`: the
// STATS = true instantiations of either mode) replace the PacketStats the
// JAX loop carries (traverse_packet.py:179-199): each thread also writes
// its ray's counts of internal and of instance steps (int32); its leaf
// steps are its steps less both, and the wave's counters are reductions
// over the per-ray counts (ops/packet_walk.py).  With STATS = false the
// counts are compiled out and the kernel is the one above.
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

// 48 entries x 8 B x 128 threads = 48 KB, the shared memory a block gets
// without opting in (a depth-44 tree)
#define VRT_STACK_MAX 48
#define VRT_LARGE 1e30f
#define VRT_EPS 1e-6f
#define VRT_LEFT_MASK ((1u << 26) - 1u)
#define VRT_BLOCK 128
#define VRT_STK_STRIDE VRT_BLOCK  // entries between a thread's stack levels

namespace {

struct WalkArgs {
    const uint4* nodes;    // (N, 32) words = 8 uint4 per row
    const float4* rows;    // (L, row_words) floats
    const float* o;        // (R, 3)
    const float* d;        // (R, 3)
    const float* limit;    // (R,) t_max, or -1 for dead rays
    float* dist_out;
    float* bx_out;
    float* by_out;
    float* bz_out;
    int* tri_out;
    int* inst_out;
    int* steps_out;
    int n_rays, n_nodes, n_rows, row_vec4, lmax, num_tlas, tri_bits;
    int stack_n, max_steps, occlusion;
    // alpha mode only: the (L, alpha_words) alpha rows, the pool and its
    // length, and the threshold
    const float4* alpha_rows;
    int alpha_vec4;
    const float* alpha_pool;
    int n_pool;
    float alpha_thr;
    // STATS only: each ray's internal and instance steps, (R,) int32
    int* int_out;
    int* ins_out;
};

__device__ __forceinline__ float rcp_clamped(float d) {
    const float dd = (fabsf(d) < 1e-20f) ? ((d < 0.0f) ? -1e-20f : 1e-20f) : d;
    return 1.0f / dd;
}

// Byte k of w as a float, exactly: the byte becomes the low mantissa byte
// of 2^23 (0x4B0000bb; selector nibbles k, 5, 6, 7 over the 8 bytes of
// {0x4B000000, w}) and 2^23 is subtracted.  Equal to (float)b for every
// byte b, so the corners g + b * s keep their bits.
__device__ __forceinline__ float qbyte(uint32_t w, uint32_t k) {
    return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650u | k))
        - 8388608.0f;
}

__device__ __forceinline__ void cswap_asc(float* ds, int* ix, int a, int b) {
    // ascending network comparator: swap when d[a] > d[b]
    if (ds[a] > ds[b]) {
        const float tf = ds[a]; ds[a] = ds[b]; ds[b] = tf;
        const int ti = ix[a]; ix[a] = ix[b]; ix[b] = ti;
    }
}

// Pops the nearest deferred child off the stack (sc > 0): its node index.
__device__ __forceinline__ int pop_deferred(int2* stk, int& sc, int stack_n) {
    const int at = min(sc - 1, stack_n - 1) * VRT_STK_STRIDE;
    const int2 top = stk[at];
    if ((top.x & 3) > 1) stk[at] = make_int2(top.x - 1, top.y >> 2);
    else --sc;
    return (top.x >> 2) + (top.y & 3);
}

// Walks ray i; `stk` is this thread's first stack entry in shared memory.
template <bool ALPHA, bool STATS>
__device__ __forceinline__ void walk_ray(const WalkArgs& a, int i, int2* stk) {
    // best_t doubles as the liveness/clamp register: dead rays enter with
    // -1 and never walk; in occlusion mode a hit sets it to -1
    float best_t = a.limit[i], bx = 0.0f, by = 0.0f;
    int tri = 2147483647, binst = 0, inst = 0, sc = 0, steps = 0;
    int n_int = 0, n_ins = 0;  // STATS: internal and instance steps
    bool alive = best_t > 0.0f && a.max_steps > 0;
    float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
    float ivx = 0.0f, ivy = 0.0f, ivz = 0.0f;
    int node_c = 0;
    uint4 w3 = make_uint4(0u, 0u, 0u, 0u);  // words 12..15: qhi, meta, leaf_n
    if (alive) {  // a ray that never walks needs no o, d or row
        ox = a.o[3 * i + 0]; oy = a.o[3 * i + 1]; oz = a.o[3 * i + 2];
        dx = a.d[3 * i + 0]; dy = a.d[3 * i + 1]; dz = a.d[3 * i + 2];
        ivx = rcp_clamped(dx); ivy = rcp_clamped(dy); ivz = rcp_clamped(dz);
        w3 = __ldg(a.nodes + 3);
    }
    // instance-local ray (equal to the world ray until an instance node)
    float lox = ox, loy = oy, loz = oz;
    float ldx = dx, ldy = dy, ldz = dz;
    float lix = ivx, liy = ivy, liz = ivz;

    while (alive) {
        // ---- an internal step for the lanes at an internal node, then a
        // leaf or instance step for the lanes at one
        if ((w3.z >> 29) == 0u) {
            const uint4* row = a.nodes + (size_t)node_c * 8;
            const uint4 w0 = __ldg(row + 0);       // words 0..3
            const uint4 w1 = __ldg(row + 1);       // words 4..7
            const uint4 w2 = __ldg(row + 2);       // words 8..11
            const uint32_t meta = w3.z;
            const int nch = (int)((meta >> 26) & 7u);
            const int left = (int)(meta & VRT_LEFT_MASK);
            const float gx = __uint_as_float(w0.x), gy = __uint_as_float(w0.y);
            const float gz = __uint_as_float(w0.z), sx = __uint_as_float(w0.w);
            const float sy = __uint_as_float(w1.x), sz = __uint_as_float(w1.y);
            const uint32_t ql[4] = {w1.z, w1.w, w2.x, w2.y};
            const uint32_t qh[4] = {w2.z, w2.w, w3.x, w3.y};
            const bool in_tlas = node_c < a.num_tlas;
            const float rox = in_tlas ? ox : lox, roy = in_tlas ? oy : loy;
            const float roz = in_tlas ? oz : loz;
            const float rix = in_tlas ? ivx : lix, riy = in_tlas ? ivy : liy;
            const float riz = in_tlas ? ivz : liz;
            float ds[4];
            int ix[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const float lx = gx + qbyte(ql[c], 0) * sx;
                const float ly = gy + qbyte(ql[c], 1) * sy;
                const float lz = gz + qbyte(ql[c], 2) * sz;
                const float hx = gx + qbyte(qh[c], 0) * sx;
                const float hy = gy + qbyte(qh[c], 1) * sy;
                const float hz = gz + qbyte(qh[c], 2) * sz;
                const float t1x = (lx - rox) * rix, t2x = (hx - rox) * rix;
                const float t1y = (ly - roy) * riy, t2y = (hy - roy) * riy;
                const float t1z = (lz - roz) * riz, t2z = (hz - roz) * riz;
                const float tmin = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                                         fminf(t1z, t2z));
                const float tmax = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                                         fmaxf(t1z, t2z));
                const bool hit = (tmax >= tmin) && (tmax > 0.0f)
                    && (tmin < best_t) && (c < nch);
                ds[c] = hit ? tmin : VRT_LARGE;
                ix[c] = c;
            }
            // the TPU kernel's network (0,1) (2,3) (0,2) (1,3) (1,2)
            cswap_asc(ds, ix, 0, 1); cswap_asc(ds, ix, 2, 3);
            cswap_asc(ds, ix, 0, 2); cswap_asc(ds, ix, 1, 3);
            cswap_asc(ds, ix, 1, 2);
            // the hit children are the sorted prefix, nearest first; their
            // slot ids 2 bits each
            int m = 0, perm = 0;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                m += (ds[c] < VRT_LARGE) ? 1 : 0;
                perm |= ix[c] << (2 * c);
            }
            int nxt = 0;
            if (m >= 1) {
                nxt = left + (perm & 3);
                if (m >= 2) {
                    stk[min(sc, a.stack_n - 1) * VRT_STK_STRIDE] =
                        make_int2((left << 2) | (m - 1), perm >> 2);
                    ++sc;
                }
            } else if (sc > 0) {
                nxt = pop_deferred(stk, sc, a.stack_n);  // nothing hit
            } else {
                alive = false;  // empty stack: the ray is done
            }
            ++steps;
            if (STATS) ++n_int;
            if (steps >= a.max_steps) alive = false;
            if (alive) {
                node_c = min(max(nxt, 0), a.n_nodes - 1);
                w3 = __ldg(a.nodes + (size_t)node_c * 8 + 3);
            }
        }
        if (alive && (w3.z >> 29) != 0u) {
            const uint32_t meta = w3.z;
            const int left = (int)(meta & VRT_LEFT_MASK);
            int nxt = 0;
            bool descended = false;
            if ((meta >> 29) == 1u) {
                // ---- triangle leaf: the row's leaf_n Moller-Trumbore
                // tests (a slot past leaf_n fails its test and, with t_max
                // at most VRT_LARGE, changes nothing)
                const int n_slots = min(a.lmax, (int)w3.w);
                const int row_i = min(max(left, 0), a.n_rows - 1);
                const float4* tr = a.rows + (size_t)row_i * a.row_vec4;
                for (int c = 0; c < n_slots; ++c) {
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
                    const float det = e1x * hx_ + e1y * hy_ + e1z * hz_;
                    const float fba = 1.0f / ((fabsf(det) < VRT_EPS) ? 1.0f : det);
                    const float sx_ = lox - v0x, sy_ = loy - v0y, sz_ = loz - v0z;
                    const float w1 = fba * (sx_ * hx_ + sy_ * hy_ + sz_ * hz_);
                    const float qx = sy_ * e1z - sz_ * e1y;
                    const float qy = sz_ * e1x - sx_ * e1z;
                    const float qz = sx_ * e1y - sy_ * e1x;
                    const float w2 = fba * (ldx * qx + ldy * qy + ldz * qz);
                    float t = fba * (e2x * qx + e2y * qy + e2z * qz);
                    bool ok = (fabsf(det) >= VRT_EPS) && (w1 >= 0.0f)
                        && (w1 <= 1.0f) && (w2 >= 0.0f) && (w1 + w2 <= 1.0f)
                        && (t > VRT_EPS);
                    if (ALPHA && ok) {
                        const float4* al = a.alpha_rows
                            + (size_t)row_i * a.alpha_vec4 + 2 * c;
                        ok = vrt_alpha_keep(__ldg(al), __ldg(al + 1), w1, w2,
                                            a.alpha_pool, a.n_pool,
                                            a.alpha_thr);
                    }
                    t = ok ? t : VRT_LARGE;
                    if (a.occlusion) {
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
                // ---- instance: world ray -> instance space, descend to BLAS
                const uint4* row = a.nodes + (size_t)node_c * 8;
                const uint4 w4 = __ldg(row + 4), w5 = __ldg(row + 5);
                const uint4 w6 = __ldg(row + 6), w7 = __ldg(row + 7);
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
                if (STATS) ++n_ins;
            }
            // a leaf pops; the ray ends on an empty stack
            if (!descended) {
                if (sc > 0) nxt = pop_deferred(stk, sc, a.stack_n);
                else alive = false;
            }
            ++steps;
            if (steps >= a.max_steps || (a.occlusion && !(best_t > 0.0f))) {
                alive = false;
            }
            if (alive) {
                node_c = min(max(nxt, 0), a.n_nodes - 1);
                w3 = __ldg(a.nodes + (size_t)node_c * 8 + 3);
            }
        }
    }

    const float lim = a.limit[i];
    a.steps_out[i] = steps;
    if (STATS) {
        a.int_out[i] = n_int;
        a.ins_out[i] = n_ins;
    }
    a.bx_out[i] = bx;
    a.by_out[i] = by;
    a.bz_out[i] = 1.0f - bx - by;
    if (a.occlusion) {
        const bool occluded = (lim > 0.0f) && (best_t < 0.0f);
        a.dist_out[i] = occluded ? 0.0f : VRT_LARGE;
        a.tri_out[i] = 0;
        a.inst_out[i] = binst;
    } else {
        // a real hit is strictly inside the clamp; unhit rays still carry
        // their initial t_max and report a miss
        const bool miss = (best_t < 0.0f) || (best_t >= lim);
        int t_id = miss ? 0 : tri;
        int i_id = binst;
        if (a.num_tlas == 0 && a.tri_bits > 0) {
            // flattened build: leaf tids are packed (inst << tri_bits) | tri
            i_id = t_id >> a.tri_bits;
            t_id = t_id & ((1 << a.tri_bits) - 1);
        }
        a.dist_out[i] = miss ? VRT_LARGE : best_t;
        a.tri_out[i] = t_id;
        a.inst_out[i] = i_id;
    }
}

template <bool ALPHA, bool STATS>
__global__ void __launch_bounds__(VRT_BLOCK) packet_walk_kernel(
        const __grid_constant__ WalkArgs a) {
    // deferred-children stack: entry e of thread t at
    // stack_smem[e * VRT_STK_STRIDE + t] as (left << 2 | count, 3 x 2-bit ids)
    extern __shared__ int2 stack_smem[];
    const int i = blockIdx.x * VRT_BLOCK + threadIdx.x;
    if (i < a.n_rays) walk_ray<ALPHA, STATS>(a, i, stack_smem + threadIdx.x);
}

size_t stack_bytes(int stack_n) {
    return (size_t)stack_n * sizeof(int2) * VRT_BLOCK;
}

WalkArgs walk_args(const void* nodes, const void* rows, const void* o,
                   const void* d, const void* limit, void* dist, void* bx,
                   void* by, void* bz, void* tri, void* inst, void* steps,
                   int n_rays, int n_nodes, int n_rows, int row_words,
                   int lmax, int num_tlas, int tri_bits, int stack_n,
                   int max_steps, int occlusion) {
    return WalkArgs{
        (const uint4*)nodes, (const float4*)rows, (const float*)o,
        (const float*)d, (const float*)limit,
        (float*)dist, (float*)bx, (float*)by, (float*)bz,
        (int*)tri, (int*)inst, (int*)steps,
        n_rays, n_nodes, n_rows, row_words / 4, lmax, num_tlas, tri_bits,
        stack_n, max_steps, occlusion, nullptr, 0, nullptr, 0, 0.0f,
        nullptr, nullptr};
}

bool walk_sizes_ok(int n_nodes, int n_rows, int row_words, int lmax,
                   int stack_n) {
    return stack_n >= 1 && stack_n <= VRT_STACK_MAX && row_words % 16 == 0
        && lmax >= 1 && lmax * 16 <= row_words && n_nodes > 0 && n_rows > 0;
}

bool alpha_sizes_ok(int lmax, int alpha_words, int n_pool) {
    return alpha_words % 4 == 0 && lmax * 8 <= alpha_words && n_pool > 0;
}

template <bool ALPHA, bool STATS>
int launch(const WalkArgs& a, int stack_n, void* stream) {
    const int grid = (a.n_rays + VRT_BLOCK - 1) / VRT_BLOCK;
    packet_walk_kernel<ALPHA, STATS><<<grid, VRT_BLOCK, stack_bytes(stack_n),
                                       (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vrt_packet_walk_stack_max(void) { return VRT_STACK_MAX; }

extern "C" const char* vrt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// Launches the walk on `stream` and returns cudaGetLastError() (0 = ok).
// Pointers are device pointers of contiguous tensors; the caller
// allocates every output.  `stack_n` packed stack entries (depth + 4).
extern "C" int vrt_packet_walk(
        const void* nodes, const void* rows, const void* o, const void* d,
        const void* limit, void* dist, void* bx, void* by, void* bz,
        void* tri, void* inst, void* steps,
        int n_rays, int n_nodes, int n_rows, int row_words, int lmax,
        int num_tlas, int tri_bits, int stack_n, int max_steps, int occlusion,
        void* stream) {
    if (n_rays <= 0) return 0;
    if (!walk_sizes_ok(n_nodes, n_rows, row_words, lmax, stack_n)) {
        return (int)cudaErrorInvalidValue;
    }
    const WalkArgs a = walk_args(
        nodes, rows, o, d, limit, dist, bx, by, bz, tri, inst, steps, n_rays,
        n_nodes, n_rows, row_words, lmax, num_tlas, tri_bits, stack_n,
        max_steps, occlusion);
    return launch<false, false>(a, stack_n, stream);
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
    if (!walk_sizes_ok(n_nodes, n_rows, row_words, lmax, stack_n)
            || !alpha_sizes_ok(lmax, alpha_words, n_pool)) {
        return (int)cudaErrorInvalidValue;
    }
    WalkArgs a = walk_args(
        nodes, rows, o, d, limit, dist, bx, by, bz, tri, inst, steps, n_rays,
        n_nodes, n_rows, row_words, lmax, num_tlas, tri_bits, stack_n,
        max_steps, occlusion);
    a.alpha_rows = (const float4*)alpha_rows;
    a.alpha_vec4 = alpha_words / 4;
    a.alpha_pool = (const float*)alpha_pool;
    a.n_pool = n_pool;
    a.alpha_thr = thr;
    return launch<true, false>(a, stack_n, stream);
}

// The counting instantiations: as vrt_packet_walk and
// vrt_packet_walk_alpha, and each ray's internal and instance steps into
// `int_steps` and `ins_steps` ((n_rays,) int32 each).
extern "C" int vrt_packet_walk_stats(
        const void* nodes, const void* rows, const void* o, const void* d,
        const void* limit, void* dist, void* bx, void* by, void* bz,
        void* tri, void* inst, void* steps, void* int_steps, void* ins_steps,
        int n_rays, int n_nodes, int n_rows, int row_words, int lmax,
        int num_tlas, int tri_bits, int stack_n, int max_steps, int occlusion,
        void* stream) {
    if (n_rays <= 0) return 0;
    if (!walk_sizes_ok(n_nodes, n_rows, row_words, lmax, stack_n)
            || int_steps == nullptr || ins_steps == nullptr) {
        return (int)cudaErrorInvalidValue;
    }
    WalkArgs a = walk_args(
        nodes, rows, o, d, limit, dist, bx, by, bz, tri, inst, steps, n_rays,
        n_nodes, n_rows, row_words, lmax, num_tlas, tri_bits, stack_n,
        max_steps, occlusion);
    a.int_out = (int*)int_steps;
    a.ins_out = (int*)ins_steps;
    return launch<false, true>(a, stack_n, stream);
}

extern "C" int vrt_packet_walk_alpha_stats(
        const void* nodes, const void* rows, const void* o, const void* d,
        const void* limit, void* dist, void* bx, void* by, void* bz,
        void* tri, void* inst, void* steps, const void* alpha_rows,
        const void* alpha_pool, void* int_steps, void* ins_steps,
        int n_rays, int n_nodes, int n_rows, int row_words, int lmax,
        int num_tlas, int tri_bits, int stack_n, int max_steps, int occlusion,
        int alpha_words, int n_pool, float thr, void* stream) {
    if (n_rays <= 0) return 0;
    if (!walk_sizes_ok(n_nodes, n_rows, row_words, lmax, stack_n)
            || !alpha_sizes_ok(lmax, alpha_words, n_pool)
            || int_steps == nullptr || ins_steps == nullptr) {
        return (int)cudaErrorInvalidValue;
    }
    WalkArgs a = walk_args(
        nodes, rows, o, d, limit, dist, bx, by, bz, tri, inst, steps, n_rays,
        n_nodes, n_rows, row_words, lmax, num_tlas, tri_bits, stack_n,
        max_steps, occlusion);
    a.alpha_rows = (const float4*)alpha_rows;
    a.alpha_vec4 = alpha_words / 4;
    a.alpha_pool = (const float*)alpha_pool;
    a.n_pool = n_pool;
    a.alpha_thr = thr;
    a.int_out = (int*)int_steps;
    a.ins_out = (int*)ins_steps;
    return launch<true, true>(a, stack_n, stream);
}
