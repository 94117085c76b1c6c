// traverse_packet.cu — per-ray walk of the 8- and 16-wide fused BVH on
// Hopper (K1).
//
// Replaces the XLA while_loop `trace_packets` of
// vortex_rt_tpu/ops/traverse_packet.py:202 (loop body :543-894) on the JAX
// main path's tables: flat 8-wide builds with fused node+leaf rows
// (WideArrays.fuse, ops/traverse_wide.py:208), and flat 16-wide ones
// (RTConfig(bvh_width=16)).  Same hits in the three
// modes: closest hit, bounded occlusion (the first hit inside t_max retires
// the ray) and the mixed wave of `occl_split` (rays below the split trace
// in occlusion mode, the rest closest-hit: the frame loop's merged
// shadow+bounce wave).
//
// The walk.  One thread walks one ray over its own path, near-first by its
// own entry distance.  A step reads the node's fused row (32 node words,
// then the node's own leaf slots): the meta quarter first, then either the
// 8 quantized child boxes (slab tests, the JAX 19-comparator descending
// network, nearest child taken, the others deferred) or the leaf's
// Moller-Trumbore tests.  Deferred children are kept as the JAX body's
// packed words for width 8 (traverse_packet.py:634-643): `left << 4 |
// count` and 7 three-bit sorted slot ids, one entry per descended level,
// so a stack of depth + 4 entries cannot overflow; a pop takes the nearest
// deferred child and decrements the count in place until the entry is
// spent.  Every ray visits the same nodes, and takes the same number of
// steps, as in the plain PyTorch version (ops/traverse_packet.py).
//
// What bounds it on this card: instruction issue.  An internal step is
// ~840 SASS instructions a warp, of which the FP32 work of the slab tests
// and the sort is about a third (PERF.md); its row is one 128-B line from
// L1 or L2 (the table, 14-40 MB at the shipped scenes, stays in the 50 MB
// L2).  The design, each piece measured against the kernel without it
// (tools/k1_timing.py):
// - quantized bytes decode exactly with PRMT + FADD, not an int -> float
//   conversion: the byte goes into the low mantissa byte of 2^23 and 2^23
//   is taken off;
// - the deferred-children stack lives in shared memory, depth + 4 entries
//   of 8 B per thread, sized at launch, entry e of thread t at
//   [e * VRT_BLOCK + t] (no bank conflicts), so the kernel keeps no
//   local-memory stack frame;
// - while-while: a warp steps internal nodes while any lane is at one,
//   then leaves while any lane is at one, so a warp whose lanes are split
//   does not run both branches every step;
// - a step reads the row's meta quarter first and the child boxes only at
//   an internal node, which keeps the kernel at 64 registers (8 blocks of
//   128 threads per SM);
// - the nearest child comes out of the sorted slot ids packed 3 bits
//   each (the stack entry's second word) by one shift, not a select per
//   slot;
// - one block per 128 rays.  Persistent warps fed 32 rays at a time from
//   a global counter (Aila & Laine, HPG 2009) walked no faster on the
//   frame's waves, and refilling idle lanes early walked slower (PERF.md).
//
// Alpha mode (`vrt_traverse_packet_alpha`, the kernel's MODE =
// VRT_MODE_ALPHA instantiation): the fused rows carry each leaf's alpha
// fields after its triangle slots (WideArrays.with_alpha), and a candidate
// that passes Moller-Trumbore is kept only if its surface alpha is not
// below the threshold (alpha_test.cuh: a 32-B read from the row in hand,
// then a dependent 4-B read from the alpha pool).  This replaces the in-loop
// `alpha_ref` of the JAX body (:723-761).  A test is a chain of two
// dependent L2 trips, so the walk skips those whose answer is known: a
// slot whose every reachable texel keeps (cuts) is kept (cut out)
// untested, by the 2-bit classes `alpha_classes` makes once a table and
// threshold (ops/traverse_packet.py).  Every other candidate that passes
// Moller-Trumbore is tested; the plain walk tests every one, so its hits
// check the classes.  (Testing only the
// candidates that could win the leaf's fold and the ray's, and stopping
// an occlusion ray at its first kept candidate, bought nothing: most
// candidates lie before the ray's hit, PERF.md section 6.)  The
// VRT_MODE_NONE instantiation is the walk above, unchanged: the main
// path's kernel, its steps and its launches are those of the build
// without alpha.
//
// Predicate mode (`vrt_traverse_packet_pred`, the MODE = VRT_MODE_PRED
// instantiation, 8b): a stateless any-hit predicate compiled from torch
// (ops/anyhit_pred.py) into `vrt_pred(u, v, alpha)`, in a header the
// build names with -DVRT_PRED_HEADER; the entry points exist only in such
// a build (runtime/kernels.load_pred), so the default library is the one
// above.  This replaces the in-loop `anyhit_pred` of the JAX body
// (:723-761, :1057-1085).  Every candidate that passes Moller-Trumbore
// is tested, with no slot classes (they belong to a threshold, ROADMAP
// H17): its surface (u, v, alpha) as the alpha mode computes it
// (alpha_test.cuh), then the predicate, before the leaf's fold, and so
// before an occlusion ray retires.
//
// Statistics (`vrt_traverse_packet_stats`, `vrt_traverse_packet_alpha_stats`,
// `vrt_traverse_packet_pred_stats`: the STATS = true instantiations of
// each mode) replace the PacketStats
// the JAX loop carries (traverse_packet.py:179-199, :1181-1193).  Each
// thread also writes its ray's count of internal steps (int32); its leaf
// steps are its steps less those, and the wave's counters are reductions
// over the two per-ray counts (ops/traverse_packet.py).  A register and
// one 4-B store a ray; with STATS = false the count is compiled out and
// the kernel is the one above.
//
// Width 16 (`vrt_traverse_packet16*`, the traverse_packet16_kernel
// instantiations of every mode above): the walk is templated on WIDTH.
// A 16-wide row is 40 node words (160 B, the meta word at word 38, so the
// meta quarter is the row's tenth 16-B vector), then the leaf slots; a
// step reads the meta quarter first, then at an internal node the other
// nine vectors, decodes and slab-tests up to 16 children with the same
// byte decode, and orders the hit children as the JAX body's 16-slot
// network (Batcher's odd-even merge, 63 comparators,
// traverse_packet.py:78-102) orders them (sort16.cuh): nothing to sort
// at one hit child or none, which is most steps on the shipped scenes; a
// selection of the two nearest remaining keys a pass otherwise; the
// network itself where two hit keys agree above their 4 low bits, as its
// order of equal keys is its own, so the walk visits the nodes the
// network's order visits.  The slab tests stay 16 a step: the nodes a
// walk visits hold 12.8-15.2 children on the shipped scenes, and tests
// skipped by groups of four bought nothing (PERF.md).
// A deferred-children entry is three words, `left << 4 | count`, sorted
// slots 0..7 and sorted slots 8..14 at 4 bits each (:337-343, :654-655):
// the first two in the int2 plane of the 8-wide stack, the third in an
// int plane after it, 12 B an entry, so 32 entries (a depth-28 tree) fill
// the 48 KB a block of 128 threads gets without opting in.  Node ids are
// 24 bits (a pool below 2^24 nodes).  A row spans two 128-B lines; the
// walk reads only the row's own words.  The 8-wide instantiations are the
// kernel above, unchanged.
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

#include "alpha_test.cuh"
#include "sort16.cuh"
#ifdef VRT_PRED_HEADER
// the generated predicate header, named without quotes by the build
#define VRT_STR_(x) #x
#define VRT_STR(x) VRT_STR_(x)
#include VRT_STR(VRT_PRED_HEADER)
#endif

// 48 entries x 8 B x 128 threads = 48 KB, the shared memory a block gets
// without opting in (a depth-44 tree; the shipped ones are 7-9 deep); at
// width 16, 32 entries x 12 B x 128 threads = 48 KB (a depth-28 tree)
#define VRT_STACK_MAX 48
#define VRT_STACK_MAX16 32
#define VRT_LARGE 1e30f
#define VRT_EPS 1e-6f
#define VRT_INT_MAX 2147483647
#define VRT_LEFT_MASK8 ((1u << 25) - 1u)
#define VRT_LEFT_MASK16 ((1u << 24) - 1u)
#define VRT_ROW_WORDS 32
#define VRT_ROW_WORDS16 40
#define VRT_BLOCK 128
#define VRT_STK_STRIDE VRT_BLOCK  // entries between a thread's stack levels
// the walk's any-hit modes: none, the alpha cutout, a compiled predicate
#define VRT_MODE_NONE 0
#define VRT_MODE_ALPHA 1
#define VRT_MODE_PRED 2

namespace {

struct WalkArgs {
    const uint4* fused;    // (N, row_words) words
    const float* o;        // (R, 3)
    const float* d;        // (R, 3)
    const float* limit;    // (R,) t_max (LARGE when none)
    const uint8_t* active;  // (R,) bool
    float* dist_out;
    float* bx_out;
    float* by_out;
    float* bz_out;
    int* tri_out;
    int* inst_out;
    int* steps_out;
    int n_rays, n_nodes, row_vec4, lmax, tri_bits, stack_n, max_steps;
    int occl_split;
    // alpha and predicate modes: the pool, its length, the float4 offset
    // of a row's alpha fields; alpha mode only: the threshold, and each
    // row's slot classes (2 bits a slot: 0 test, 1 kept and 2 cut out
    // wherever the triangle is hit; null: every slot is tested)
    const float* alpha_pool;
    int n_pool, alpha_vec4;
    float alpha_thr;
    const uint32_t* alpha_cls;
    // STATS only: each ray's internal steps (R,) int32
    int* int_out;
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

__device__ __forceinline__ void cswap_desc(float* ds, int* ix, int a, int b) {
    // descending network comparator: swap when d[a] < d[b]
    if (ds[a] < ds[b]) {
        const float tf = ds[a]; ds[a] = ds[b]; ds[b] = tf;
        const int ti = ix[a]; ix[a] = ix[b]; ix[b] = ti;
    }
}

// Pops the nearest deferred child off the stack (sc > 0): its node index.
// Width 16 reads sorted slots 8..14 from the third word's plane `stk2`.
template <int WIDTH>
__device__ __forceinline__ int pop_deferred(int2* stk, const int* stk2,
                                            int& sc, int stack_n) {
    const int at = min(sc - 1, stack_n - 1) * VRT_STK_STRIDE;
    const int2 top = stk[at];
    const int c_top = top.x & 15;
    if (c_top > 1) stk[at].x = top.x - 1; else --sc;
    if constexpr (WIDTH == 16) {
        const int j = max(c_top - 1, 0);
        const uint32_t w = j < 8 ? (uint32_t)top.y : (uint32_t)stk2[at];
        return (top.x >> 4) + (int)((w >> (4 * (j & 7))) & 15u);
    } else {
        return (top.x >> 4) + ((top.y >> (3 * max(c_top - 1, 0))) & 7);
    }
}

// An internal step at width 16: the node's 16 quantized child boxes
// (words 6..37 of the row; w9 is its meta quarter, words 36..39) decoded
// and slab-tested, the hit children ordered far -> near as the JAX body's
// 16-slot network orders them (sort16.cuh: a selection over the hit
// children, the network itself on a tie), the nearest returned and the
// others deferred in one three-word stack entry; with none hit, the
// nearest deferred child is popped, or the ray ends (`alive` false) on an
// empty stack.
__device__ __forceinline__ int internal_step16(
        const uint4* row, uint4 w9, float ox, float oy, float oz, float ivx,
        float ivy, float ivz, float best_t, int2* stk, int* stk2, int& sc,
        int stack_n, bool& alive) {
    const uint4 w0 = __ldg(row + 0), w1 = __ldg(row + 1);
    const uint4 w2 = __ldg(row + 2), w3 = __ldg(row + 3);
    const uint4 w4 = __ldg(row + 4), w5 = __ldg(row + 5);
    const uint4 w6 = __ldg(row + 6), w7 = __ldg(row + 7);
    const uint4 w8 = __ldg(row + 8);
    const uint32_t meta = w9.z;
    const int nch = (int)((meta >> 24) & 31u);
    const int left = (int)(meta & VRT_LEFT_MASK16);
    const float gx = __uint_as_float(w0.x), gy = __uint_as_float(w0.y);
    const float gz = __uint_as_float(w0.z), sx = __uint_as_float(w0.w);
    const float sy = __uint_as_float(w1.x), sz = __uint_as_float(w1.y);
    const uint32_t ql[16] = {w1.z, w1.w, w2.x, w2.y, w2.z, w2.w, w3.x, w3.y,
                             w3.z, w3.w, w4.x, w4.y, w4.z, w4.w, w5.x, w5.y};
    const uint32_t qh[16] = {w5.z, w5.w, w6.x, w6.y, w6.z, w6.w, w7.x, w7.y,
                             w7.z, w7.w, w8.x, w8.y, w8.z, w8.w, w9.x, w9.y};
    // the network's keys (culled slots -LARGE) and the hit children: the
    // keys above -LARGE, which the network puts at positions 0..m-1
    float ds[16];
    uint32_t hits = 0u;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
        const float lx = gx + qbyte(ql[c], 0) * sx;
        const float ly = gy + qbyte(ql[c], 1) * sy;
        const float lz = gz + qbyte(ql[c], 2) * sz;
        const float hx = gx + qbyte(qh[c], 0) * sx;
        const float hy = gy + qbyte(qh[c], 1) * sy;
        const float hz = gz + qbyte(qh[c], 2) * sz;
        const float t1x = (lx - ox) * ivx, t2x = (hx - ox) * ivx;
        const float t1y = (ly - oy) * ivy, t2y = (hy - oy) * ivy;
        const float t1z = (lz - oz) * ivz, t2z = (hz - oz) * ivz;
        const float tmin = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                                 fminf(t1z, t2z));
        const float tmax = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                                 fmaxf(t1z, t2z));
        const bool hit = (tmax >= tmin) && (tmax > 0.0f) && (tmin < best_t)
            && (c < nch) && (tmin > -VRT_LARGE);
        ds[c] = hit ? tmin : -VRT_LARGE;
        hits |= hit ? (1u << c) : 0u;
    }
    // the sorted slot ids, 4 bits each: the stack entry's second word
    // holds positions 0..7, its third 8..14
    uint32_t p1, p2;
    const int near = vrt_order16(ds, hits, p1, p2);
    const int m = __popc(hits);
    int nxt = 0;
    if (m >= 1) {
        // the nearest hit child (position m - 1 of the far -> near order)
        nxt = left + near;
        if (m >= 2) {
            const int at = min(sc, stack_n - 1) * VRT_STK_STRIDE;
            stk[at] = make_int2((left << 4) | (m - 1), (int)p1);
            stk2[at] = (int)(p2 & 0x0FFFFFFFu);
            ++sc;
        }
    } else if (sc > 0) {
        nxt = pop_deferred<16>(stk, stk2, sc, stack_n);  // nothing hit
    } else {
        alive = false;  // empty stack: the ray is done
    }
    return nxt;
}

// Walks ray i; `stk` is this thread's first stack entry in shared memory
// (width 16: `stk2` its first third word).
template <int WIDTH, int MODE, bool STATS>
__device__ __forceinline__ void walk_ray(const WalkArgs& a, int i, int2* stk,
                                         int* stk2) {
    constexpr bool ALPHA = MODE == VRT_MODE_ALPHA;
    // the row's meta quarter (the last two child boxes, meta, leaf_n) and
    // its first leaf slot, in 16-B vectors
    constexpr int META_V4 = WIDTH == 16 ? 9 : 5;
    constexpr int NODE_V4 = (WIDTH == 16 ? VRT_ROW_WORDS16 : VRT_ROW_WORDS) / 4;
    const float lim = a.limit[i];
    const bool on = a.active[i] != 0;
    const bool occ = i < a.occl_split;
    // best_t doubles as the liveness register: dead lanes carry -LARGE and
    // never walk; an occlusion hit drops it to -LARGE and retires the ray
    float best_t = on ? lim : -VRT_LARGE;
    float bx = 0.0f, by = 0.0f;
    int tri = 0, sc = 0, steps = 0;
    int n_int = 0;  // STATS: internal steps
    bool alive = best_t > 0.0f;
    float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
    float ivx = 0.0f, ivy = 0.0f, ivz = 0.0f;
    const uint4* row = a.fused;
    int node = 0;  // (its index: the alpha mode's slot classes)
    // (words 20..23, or 36..39 at width 16: boxes, meta, leaf_n)
    uint4 w5 = make_uint4(0u, 0u, 0u, 0u);
    if (alive) {  // a ray that never walks needs no o, d or row
        ox = a.o[3 * i + 0]; oy = a.o[3 * i + 1]; oz = a.o[3 * i + 2];
        dx = a.d[3 * i + 0]; dy = a.d[3 * i + 1]; dz = a.d[3 * i + 2];
        ivx = rcp_clamped(dx); ivy = rcp_clamped(dy); ivz = rcp_clamped(dz);
        w5 = __ldg(row + META_V4);
    }

    while (alive) {
        // ---- while-while: internal steps while any lane is at an
        // internal node, then leaf steps while any lane is at a leaf
        while (alive && (w5.z >> 29) == 0u) {
            int nxt = 0;
            if constexpr (WIDTH == 16) {
                nxt = internal_step16(row, w5, ox, oy, oz, ivx, ivy, ivz,
                                      best_t, stk, stk2, sc, a.stack_n,
                                      alive);
            } else {
                const uint4 w0 = __ldg(row + 0), w1 = __ldg(row + 1);
                const uint4 w2 = __ldg(row + 2), w3 = __ldg(row + 3);
                const uint4 w4 = __ldg(row + 4);
                const uint32_t meta = w5.z;
                const int nch = (int)((meta >> 25) & 15u);
                const int left = (int)(meta & VRT_LEFT_MASK8);
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
                    const float ly = gy + qbyte(ql[c], 1) * sy;
                    const float lz = gz + qbyte(ql[c], 2) * sz;
                    const float hx = gx + qbyte(qh[c], 0) * sx;
                    const float hy = gy + qbyte(qh[c], 1) * sy;
                    const float hz = gz + qbyte(qh[c], 2) * sz;
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
                // the sorted slot ids, 3 bits each: the low 21 bits are the
                // stack entry's second word
                int m = 0, perm = 0;
#pragma unroll
                for (int c = 0; c < 8; ++c) {
                    m += (ds[c] > -VRT_LARGE) ? 1 : 0;
                    perm |= ix[c] << (3 * c);
                }
                if (m >= 1) {
                    // sorted far -> near: the nearest hit child sits at m - 1
                    nxt = left + ((perm >> (3 * (m - 1))) & 7);
                    if (m >= 2) {
                        stk[min(sc, a.stack_n - 1) * VRT_STK_STRIDE] =
                            make_int2((left << 4) | (m - 1), perm & 0x1FFFFF);
                        ++sc;
                    }
                } else if (sc > 0) {
                    nxt = pop_deferred<8>(stk, stk2, sc, a.stack_n);  // nothing hit
                } else {
                    alive = false;  // empty stack: the ray is done
                }
            }
            ++steps;
            if (STATS) ++n_int;
            if (steps >= a.max_steps) alive = false;
            if (alive) {
                node = min(max(nxt, 0), a.n_nodes - 1);
                row = a.fused + (size_t)node * a.row_vec4;
                w5 = __ldg(row + META_V4);
            }
        }
        while (alive && (w5.z >> 29) != 0u) {
            if ((w5.z >> 29) == 1u) {
                // ---- triangle leaf: the row's leaf_n Moller-Trumbore
                // tests (slots past leaf_n never win the fold), folded to
                // the leaf's best, then into the ray's
                const float4* tr =
                    reinterpret_cast<const float4*>(row) + NODE_V4;
                const int n_slots = min(a.lmax, (int)w5.w);
                const uint32_t cls_w =
                    ALPHA && a.alpha_cls != nullptr ? __ldg(a.alpha_cls + node) : 0u;
                float t_min = VRT_LARGE, w1_sel = 0.0f, w2_sel = 0.0f;
                int tid_sel = VRT_INT_MAX;
                for (int c = 0; c < n_slots; ++c) {
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
                    const float det = e1x * hx_ + e1y * hy_ + e1z * hz_;
                    const float fba = 1.0f / ((fabsf(det) < VRT_EPS) ? 1.0f : det);
                    const float sx_ = ox - v0x, sy_ = oy - v0y, sz_ = oz - v0z;
                    const float w1 = fba * (sx_ * hx_ + sy_ * hy_ + sz_ * hz_);
                    const float qx = sy_ * e1z - sz_ * e1y;
                    const float qy = sz_ * e1x - sx_ * e1z;
                    const float qz = sx_ * e1y - sy_ * e1x;
                    const float w2 = fba * (dx * qx + dy * qy + dz * qz);
                    float t = fba * (e2x * qx + e2y * qy + e2z * qz);
                    bool ok = (fabsf(det) >= VRT_EPS) && (w1 >= 0.0f)
                        && (w1 <= 1.0f) && (w2 >= 0.0f) && (w1 + w2 <= 1.0f)
                        && (t > VRT_EPS);
                    const uint32_t cls = (cls_w >> (2 * c)) & 3u;
                    if (ALPHA && ok && cls == 2u) ok = false;  // cut out anywhere
                    if (ALPHA && ok && cls == 0u) {
                        const float4* al = reinterpret_cast<const float4*>(row)
                            + a.alpha_vec4 + 2 * c;
                        ok = vrt_alpha_keep(__ldg(al), __ldg(al + 1), w1, w2,
                                            a.alpha_pool, a.n_pool, a.alpha_thr);
                    }
#ifdef VRT_PRED_HEADER
                    if (MODE == VRT_MODE_PRED && ok) {
                        const float4* al = reinterpret_cast<const float4*>(row)
                            + a.alpha_vec4 + 2 * c;
                        float su, sv, salpha;
                        vrt_candidate_surface(__ldg(al), __ldg(al + 1), w1, w2,
                                              a.alpha_pool, a.n_pool, su, sv,
                                              salpha);
                        ok = vrt_pred(su, sv, salpha);
                    }
#endif
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
                        || ((t_min == best_t) && (t_min < VRT_LARGE)
                            && (tid_sel < tri));
                    if (upd) {
                        best_t = t_min; bx = w1_sel; by = w2_sel; tri = tid_sel;
                    }
                }
            }
            // (flat builds hold no instance nodes; any other kind pops)
            int nxt = 0;
            if (sc > 0) nxt = pop_deferred<WIDTH>(stk, stk2, sc, a.stack_n);
            else alive = false;
            ++steps;
            if (steps >= a.max_steps || (occ && !(best_t > 0.0f))) alive = false;
            if (alive) {
                node = min(max(nxt, 0), a.n_nodes - 1);
                row = a.fused + (size_t)node * a.row_vec4;
                w5 = __ldg(row + META_V4);
            }
        }
    }

    a.steps_out[i] = steps;
    if (STATS) a.int_out[i] = n_int;
    a.bx_out[i] = bx;
    a.by_out[i] = by;
    a.bz_out[i] = 1.0f - bx - by;
    if (occ) {
        a.dist_out[i] = (on && best_t < 0.0f) ? 0.0f : VRT_LARGE;
    } else {
        // a real hit is strictly inside the clamp; unhit rays still carry
        // their initial t_max and report a miss
        a.dist_out[i] = (best_t < 0.0f || best_t >= lim) ? VRT_LARGE : best_t;
    }
    // leaf tids are packed (inst << tri_bits) | tri; misses carry 0
    a.tri_out[i] = tri & ((1 << a.tri_bits) - 1);
    a.inst_out[i] = tri >> a.tri_bits;
}

template <int MODE, bool STATS>
__global__ void __launch_bounds__(VRT_BLOCK) traverse_packet_kernel(
        const __grid_constant__ WalkArgs a) {
    // deferred-children stack: entry e of thread t at
    // stack_smem[e * VRT_STK_STRIDE + t] as (left << 4 | count, 7 x 3-bit ids)
    extern __shared__ int2 stack_smem[];
    const int i = blockIdx.x * VRT_BLOCK + threadIdx.x;
    if (i < a.n_rays) {
        walk_ray<8, MODE, STATS>(a, i, stack_smem + threadIdx.x, nullptr);
    }
}

// The 16-wide walk: entry e of thread t at stack_smem[e * VRT_STK_STRIDE +
// t] as (left << 4 | count, sorted slots 0..7 x 4 bits), its third word
// (sorted slots 8..14 x 4 bits) at the same index of the int plane after
// the stack_n entries of the first
template <int MODE, bool STATS>
__global__ void __launch_bounds__(VRT_BLOCK) traverse_packet16_kernel(
        const __grid_constant__ WalkArgs a) {
    extern __shared__ int2 stack_smem[];
    const int i = blockIdx.x * VRT_BLOCK + threadIdx.x;
    if (i < a.n_rays) {
        int* plane2 = reinterpret_cast<int*>(stack_smem
                                             + a.stack_n * VRT_STK_STRIDE);
        walk_ray<16, MODE, STATS>(a, i, stack_smem + threadIdx.x,
                                  plane2 + threadIdx.x);
    }
}

template <int WIDTH>
size_t stack_bytes(int stack_n) {
    return (size_t)stack_n * (WIDTH == 16 ? 12 : sizeof(int2)) * VRT_BLOCK;
}

template <int WIDTH>
constexpr int stack_cap() { return WIDTH == 16 ? VRT_STACK_MAX16 : VRT_STACK_MAX; }

template <int WIDTH>
constexpr int node_words() { return WIDTH == 16 ? VRT_ROW_WORDS16 : VRT_ROW_WORDS; }

// Launches the instantiation of WIDTH, MODE and STATS.
template <int WIDTH, int MODE, bool STATS>
int launch(const WalkArgs& a, int stack_n, void* stream) {
    const int grid = (a.n_rays + VRT_BLOCK - 1) / VRT_BLOCK;
    if constexpr (WIDTH == 16) {
        traverse_packet16_kernel<MODE, STATS><<<grid, VRT_BLOCK,
                                                stack_bytes<16>(stack_n),
                                                (cudaStream_t)stream>>>(a);
    } else {
        traverse_packet_kernel<MODE, STATS><<<grid, VRT_BLOCK,
                                              stack_bytes<8>(stack_n),
                                              (cudaStream_t)stream>>>(a);
    }
    return (int)cudaGetLastError();
}

// The walk without alpha; STATS also writes `int_steps`.
template <int WIDTH, bool STATS>
int launch_plain(
        const void* fused, const void* o, const void* d, const void* limit,
        const void* active, void* dist, void* bx, void* by, void* bz,
        void* tri, void* inst, void* steps, void* int_steps,
        int n_rays, int n_nodes, int row_words, int lmax, int tri_bits,
        int stack_n, int max_steps, int occl_split, void* stream) {
    if (n_rays <= 0) return 0;
    constexpr int NW = node_words<WIDTH>();
    if (stack_n < 1 || stack_n > stack_cap<WIDTH>()
            || row_words < NW + 16 * lmax
            || (row_words - NW) % 16 != 0 || n_nodes <= 0
            || (WIDTH == 16 && n_nodes > (int)VRT_LEFT_MASK16)
            || tri_bits <= 0 || tri_bits > 30
            || (STATS && int_steps == nullptr)) {
        return (int)cudaErrorInvalidValue;
    }
    const WalkArgs a = {
        (const uint4*)fused, (const float*)o, (const float*)d,
        (const float*)limit, (const uint8_t*)active,
        (float*)dist, (float*)bx, (float*)by, (float*)bz,
        (int*)tri, (int*)inst, (int*)steps,
        n_rays, n_nodes, row_words / 4, lmax, tri_bits, stack_n, max_steps,
        occl_split, nullptr, 0, 0, 0.0f, nullptr, (int*)int_steps};
    return launch<WIDTH, VRT_MODE_NONE, STATS>(a, stack_n, stream);
}

// The alpha mode (`thr` and the slot classes `alpha_cls`, null: test every
// slot) or, MODE == VRT_MODE_PRED, the predicate mode (no threshold, no
// classes); STATS also writes `int_steps`.
template <int WIDTH, int MODE, bool STATS>
int launch_alpha(
        const void* fused, const void* o, const void* d, const void* limit,
        const void* active, void* dist, void* bx, void* by, void* bz,
        void* tri, void* inst, void* steps, const void* alpha_pool,
        const void* alpha_cls, void* int_steps,
        int n_rays, int n_nodes, int row_words, int lmax, int tri_bits,
        int stack_n, int max_steps, int occl_split, int n_pool, int slots,
        float thr, void* stream) {
    if (n_rays <= 0) return 0;
    constexpr int NW = node_words<WIDTH>();
    if (stack_n < 1 || stack_n > stack_cap<WIDTH>() || slots < lmax
            || lmax < 1 || row_words != NW + 24 * slots
            || n_nodes <= 0 || (WIDTH == 16 && n_nodes > (int)VRT_LEFT_MASK16)
            || n_pool <= 0 || tri_bits <= 0 || tri_bits > 30
            || (alpha_cls != nullptr && slots > 16)
            || (STATS && int_steps == nullptr)) {
        return (int)cudaErrorInvalidValue;
    }
    const WalkArgs a = {
        (const uint4*)fused, (const float*)o, (const float*)d,
        (const float*)limit, (const uint8_t*)active,
        (float*)dist, (float*)bx, (float*)by, (float*)bz,
        (int*)tri, (int*)inst, (int*)steps,
        n_rays, n_nodes, row_words / 4, lmax, tri_bits, stack_n, max_steps,
        occl_split, (const float*)alpha_pool, n_pool,
        (NW + 16 * slots) / 4, thr, (const uint32_t*)alpha_cls,
        (int*)int_steps};
    return launch<WIDTH, MODE, STATS>(a, stack_n, stream);
}

}  // namespace

extern "C" int vrt_traverse_packet_stack_max(void) { return VRT_STACK_MAX; }
extern "C" int vrt_traverse_packet16_stack_max(void) {
    return VRT_STACK_MAX16;
}

extern "C" const char* vrt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// The C entry points, each defined at width 8 (`vrt_traverse_packet*`,
// 32-word node rows) and width 16 (`vrt_traverse_packet16*`, 40-word node
// rows) with the same arguments.
#define VRT_PLAIN_ARGS                                                       \
        const void* fused, const void* o, const void* d, const void* limit, \
        const void* active, void* dist, void* bx, void* by, void* bz,       \
        void* tri, void* inst, void* steps
#define VRT_SIZE_ARGS                                                        \
        int n_rays, int n_nodes, int row_words, int lmax, int tri_bits,     \
        int stack_n, int max_steps, int occl_split
#define VRT_PLAIN_PASS                                                       \
        fused, o, d, limit, active, dist, bx, by, bz, tri, inst, steps
#define VRT_SIZE_PASS                                                        \
        n_rays, n_nodes, row_words, lmax, tri_bits, stack_n, max_steps,     \
        occl_split

// Launches the walk on `stream` and returns the first CUDA error (0 = ok).
// Pointers are device pointers of contiguous tensors; the caller
// allocates every output.
// The alpha mode (`_alpha`): as the walk over fused rows of
// NW + 24 * slots words (NW node words, slots triangle slots, then their
// alpha fields), with the alpha pool of n_pool floats, the threshold `thr`
// and the rows' slot classes for it (n_nodes uint32, slots <= 16; null:
// test every slot).
// The counting instantiations (`_stats`): as the walk and its alpha mode,
// and each ray's internal steps into `int_steps` ((n_rays,) int32).
#define VRT_ENTRIES(SUFFIX, W)                                               \
extern "C" int vrt_traverse_packet##SUFFIX(                                  \
        VRT_PLAIN_ARGS, VRT_SIZE_ARGS, void* stream) {                      \
    return launch_plain<W, false>(VRT_PLAIN_PASS, nullptr, VRT_SIZE_PASS,   \
                                  stream);                                  \
}                                                                            \
extern "C" int vrt_traverse_packet##SUFFIX##_alpha(                          \
        VRT_PLAIN_ARGS, const void* alpha_pool, const void* alpha_cls,      \
        VRT_SIZE_ARGS, int n_pool, int slots, float thr, void* stream) {    \
    return launch_alpha<W, VRT_MODE_ALPHA, false>(                           \
        VRT_PLAIN_PASS, alpha_pool, alpha_cls, nullptr, VRT_SIZE_PASS,      \
        n_pool, slots, thr, stream);                                        \
}                                                                            \
extern "C" int vrt_traverse_packet##SUFFIX##_stats(                          \
        VRT_PLAIN_ARGS, void* int_steps, VRT_SIZE_ARGS, void* stream) {     \
    return launch_plain<W, true>(VRT_PLAIN_PASS, int_steps, VRT_SIZE_PASS,  \
                                 stream);                                   \
}                                                                            \
extern "C" int vrt_traverse_packet##SUFFIX##_alpha_stats(                    \
        VRT_PLAIN_ARGS, const void* alpha_pool, const void* alpha_cls,      \
        void* int_steps, VRT_SIZE_ARGS, int n_pool, int slots, float thr,   \
        void* stream) {                                                      \
    return launch_alpha<W, VRT_MODE_ALPHA, true>(                            \
        VRT_PLAIN_PASS, alpha_pool, alpha_cls, int_steps, VRT_SIZE_PASS,    \
        n_pool, slots, thr, stream);                                        \
}

VRT_ENTRIES(, 8)
VRT_ENTRIES(16, 16)

#ifdef VRT_PRED_HEADER
// The predicate mode (`_pred`): as the alpha mode without the threshold
// and the classes; every candidate is tested by the compiled predicate.
#define VRT_PRED_ENTRIES(SUFFIX, W)                                          \
extern "C" int vrt_traverse_packet##SUFFIX##_pred(                           \
        VRT_PLAIN_ARGS, const void* alpha_pool, VRT_SIZE_ARGS, int n_pool,  \
        int slots, void* stream) {                                           \
    return launch_alpha<W, VRT_MODE_PRED, false>(                            \
        VRT_PLAIN_PASS, alpha_pool, nullptr, nullptr, VRT_SIZE_PASS,        \
        n_pool, slots, 0.0f, stream);                                       \
}                                                                            \
extern "C" int vrt_traverse_packet##SUFFIX##_pred_stats(                     \
        VRT_PLAIN_ARGS, const void* alpha_pool, void* int_steps,            \
        VRT_SIZE_ARGS, int n_pool, int slots, void* stream) {               \
    return launch_alpha<W, VRT_MODE_PRED, true>(                             \
        VRT_PLAIN_PASS, alpha_pool, nullptr, int_steps, VRT_SIZE_PASS,      \
        n_pool, slots, 0.0f, stream);                                       \
}

VRT_PRED_ENTRIES(, 8)
VRT_PRED_ENTRIES(16, 16)
#endif
