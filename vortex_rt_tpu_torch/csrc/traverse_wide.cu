// traverse_wide.cu — the per-ray walk with a restart trail, a short stack and
// any-hit suspension on Hopper (K3).
//
// Replaces the XLA while_loop `trace_lanes` of
// vortex_rt_tpu/ops/traverse_wide.py:640 (loop body :672-912); `commit`
// (:930) stays elementwise selects in PyTorch.  It walks the 4-wide
// TLAS+BLAS tables (nodes (N, 32) words, triangle rows (L, 16*k) floats) as
// the reference RT unit does: far-to-near child order, a trail of 4 bits a
// level that records how many children of each level are done, a 5-entry
// short stack whose oldest entry falls off on overflow (a restart from the
// root through the trail recovers it: that drop is the algorithm), instance
// leaves that move the ray into object space, and, in suspend mode, a stop
// at every candidate hit strictly closer than the ray's best, with the
// candidate in the pending fields and the stack cleared, so an any-hit
// shader can accept or reject it (`commit`) and the walk resume past it
// (the lexicographic (t, tid) barrier at the leaf it stopped in).
//
// Design.  One thread walks one ray, in place on its (R,) SoA WideState
// (43 fields, pointers in the launch's argument struct), so a suspended
// ray resumes exactly where it stopped.  A lane that is done or suspended
// at entry reads its two flag bytes and nothing more; a lane that walks
// reads only the fields the walk reads (not bx, by or the pending hit; the
// barrier only when suspending, the best hit's ids only when not) and
// writes only the fields its walk changed: the local ray and instance
// after an instance step, the best hit after a closer one, the pending hit
// at a suspension, the trail words up to the deepest level it could have
// touched, the stack when it pushed, popped or cleared it.  Late
// suspension rounds, where most lanes are done, then move almost no state.
// A caller whose input state must stay as it was (`trace_lanes`) walks a
// copy.
// The trail (8 u32 words) and the stack (5 ints) live in registers: every
// access is an unrolled loop of selects over compile-time indices, as the
// JAX helpers are, never a dynamic index into a local array.  A step
// issues its row's loads in one round: the meta quarter and the child
// boxes (64 B, four 16-B loads), and for a TLAS node (an internal or
// instance node) the transform and BLAS root too (the whole 128-B row);
// a leaf step then reads its triangle row (40 B a slot).  Each ray visits
// the nodes the JAX lane visits, in the same order, so its
// `nodes_visited` and `tri_tests` equal the JAX lane's.
//
// What bounds it on this card: the latency of dependent row fetches, as K2
// (one step's node index comes from the previous step), and divergence: a
// warp runs until its longest ray suspends or ends; in late rounds, the
// state a lane moves.
//
// The JAX loop caps its iterations over all lanes (`max_steps`); here the
// cap is per ray, on `nodes_visited`, and no walk reaches it.
//
// Numerics match the JAX body and the plain PyTorch version bit for bit:
// the JAX order of operations, the |d| < 1e-20 reciprocal clamp, the
// |a| < eps Moller-Trumbore guard, the leaf's (t, tid) fold and the ray's
// (t, inst, tri) tie-break, no contraction into FMA (-fmad=false, no
// --use_fast_math).
//
// Built by vortex_rt_tpu_torch/runtime/kernels.py with nvcc into a shared
// library with a plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

#define VRT_LARGE 1e30f
#define VRT_EPS 1e-6f
#define VRT_INT_MAX 2147483647
#define VRT_LEFT_MASK ((1u << 26) - 1u)
#define VRT_WIDTH 4
#define VRT_TRAIL_WORDS 8
#define VRT_LAST_FLAG (1 << 30)
#define VRT_ID_MASK ((1 << 30) - 1)
#define VRT_BLOCK 128

namespace {

// The WideState fields, in the order of ops/traverse_wide.py's WideState.
enum Field {
    F_NODE, F_LEVEL,
    F_TR0, F_TR1, F_TR2, F_TR3, F_TR4, F_TR5, F_TR6, F_TR7,
    F_S0, F_S1, F_S2, F_S3, F_S4, F_SCOUNT, F_INST,
    F_LOX, F_LOY, F_LOZ, F_LDX, F_LDY, F_LDZ, F_LIX, F_LIY, F_LIZ,
    F_BEST_T, F_BX, F_BY, F_TRI, F_BEST_INST,
    F_BAR_T, F_BAR_TID, F_BAR_LEAF,
    F_PEND_T, F_PEND_BX, F_PEND_BY, F_PEND_TRI, F_PEND_INST,
    F_SUSPENDED, F_DONE, F_NODES_VISITED, F_TRI_TESTS,
    F_COUNT
};

struct WalkArgs {
    const uint4* nodes;    // (N, 32) words = 8 uint4 per row
    const float4* rows;    // (L, row_words) floats
    const float* ox; const float* oy; const float* oz;  // world rays (R,)
    const float* dx; const float* dy; const float* dz;
    void* st[F_COUNT];     // the state, read at entry and updated in place
    int n_rays, n_nodes, n_rows, row_vec4, lmax, num_tlas, suspend, max_steps;
};

struct Lane {
    // what the walk changed, for the store: the instance and local ray,
    // the best hit, the stack, the triangle-test count
    bool entered, hit, stk, tested;
    int trail_top;    // the deepest trail word the walk may have changed
    int node, level;
    uint32_t tr[VRT_TRAIL_WORDS];
    int s0, s1, s2, s3, s4, scount;
    int inst;
    float lox, loy, loz, ldx, ldy, ldz, lix, liy, liz;
    float best_t, bx, by;
    int tri, best_inst;
    float bar_t;
    int bar_tid, bar_leaf;
    float pend_t, pend_bx, pend_by;
    int pend_tri, pend_inst;
    bool suspended, done;
    int visited, tri_tests;
};

template <typename T>
__device__ __forceinline__ T ld(void* const* f, int k, int i) {
    return reinterpret_cast<const T*>(f[k])[i];
}

template <typename T>
__device__ __forceinline__ void st(void* const* f, int k, int i, T v) {
    reinterpret_cast<T*>(f[k])[i] = v;
}

// Loads the fields the walk reads.
__device__ void load_lane(const WalkArgs& a, int i, Lane& L) {
    void* const* f = a.st;
    L.node = ld<int>(f, F_NODE, i); L.level = ld<int>(f, F_LEVEL, i);
#pragma unroll
    for (int w = 0; w < VRT_TRAIL_WORDS; ++w) L.tr[w] = ld<uint32_t>(f, F_TR0 + w, i);
    L.s0 = ld<int>(f, F_S0, i); L.s1 = ld<int>(f, F_S1, i);
    L.s2 = ld<int>(f, F_S2, i); L.s3 = ld<int>(f, F_S3, i);
    L.s4 = ld<int>(f, F_S4, i); L.scount = ld<int>(f, F_SCOUNT, i);
    L.inst = ld<int>(f, F_INST, i);
    L.lox = ld<float>(f, F_LOX, i); L.loy = ld<float>(f, F_LOY, i);
    L.loz = ld<float>(f, F_LOZ, i); L.ldx = ld<float>(f, F_LDX, i);
    L.ldy = ld<float>(f, F_LDY, i); L.ldz = ld<float>(f, F_LDZ, i);
    L.lix = ld<float>(f, F_LIX, i); L.liy = ld<float>(f, F_LIY, i);
    L.liz = ld<float>(f, F_LIZ, i);
    L.best_t = ld<float>(f, F_BEST_T, i);
    if (!a.suspend) {
        L.tri = ld<int>(f, F_TRI, i);
        L.best_inst = ld<int>(f, F_BEST_INST, i);
    }
    if (a.suspend) {
        L.bar_t = ld<float>(f, F_BAR_T, i); L.bar_tid = ld<int>(f, F_BAR_TID, i);
        L.bar_leaf = ld<int>(f, F_BAR_LEAF, i);
    }
    L.visited = ld<int>(f, F_NODES_VISITED, i);
    L.tri_tests = ld<int>(f, F_TRI_TESTS, i);
    L.entered = L.hit = L.stk = L.tested = false;
    L.trail_top = -1;
#pragma unroll
    for (int w = 0; w < VRT_TRAIL_WORDS; ++w) L.trail_top = L.tr[w] ? w : L.trail_top;
    L.trail_top = max(L.trail_top, L.level >> 3);
}

// Stores the fields the walk changed.
__device__ void store_lane(const WalkArgs& a, int i, const Lane& L) {
    void* const* f = a.st;
    st<int>(f, F_NODE, i, L.node); st<int>(f, F_LEVEL, i, L.level);
#pragma unroll
    for (int w = 0; w < VRT_TRAIL_WORDS; ++w) {
        if (w <= L.trail_top) st<uint32_t>(f, F_TR0 + w, i, L.tr[w]);
    }
    if (L.stk) {
        st<int>(f, F_S0, i, L.s0); st<int>(f, F_S1, i, L.s1);
        st<int>(f, F_S2, i, L.s2); st<int>(f, F_S3, i, L.s3);
        st<int>(f, F_S4, i, L.s4); st<int>(f, F_SCOUNT, i, L.scount);
    }
    if (L.entered) {
        st<int>(f, F_INST, i, L.inst);
        st<float>(f, F_LOX, i, L.lox); st<float>(f, F_LOY, i, L.loy);
        st<float>(f, F_LOZ, i, L.loz); st<float>(f, F_LDX, i, L.ldx);
        st<float>(f, F_LDY, i, L.ldy); st<float>(f, F_LDZ, i, L.ldz);
        st<float>(f, F_LIX, i, L.lix); st<float>(f, F_LIY, i, L.liy);
        st<float>(f, F_LIZ, i, L.liz);
    }
    if (L.hit) {
        st<float>(f, F_BEST_T, i, L.best_t); st<float>(f, F_BX, i, L.bx);
        st<float>(f, F_BY, i, L.by); st<int>(f, F_TRI, i, L.tri);
        st<int>(f, F_BEST_INST, i, L.best_inst);
    }
    if (L.suspended) {
        st<float>(f, F_PEND_T, i, L.pend_t); st<float>(f, F_PEND_BX, i, L.pend_bx);
        st<float>(f, F_PEND_BY, i, L.pend_by); st<int>(f, F_PEND_TRI, i, L.pend_tri);
        st<int>(f, F_PEND_INST, i, L.pend_inst);
        st<uint8_t>(f, F_SUSPENDED, i, L.suspended ? 1 : 0);
    }
    if (L.done) st<uint8_t>(f, F_DONE, i, L.done ? 1 : 0);
    st<int>(f, F_NODES_VISITED, i, L.visited);
    if (L.tested) st<int>(f, F_TRI_TESTS, i, L.tri_tests);
}

__device__ __forceinline__ float rcp_clamped(float d) {
    const float dd = (fabsf(d) < 1e-20f) ? ((d < 0.0f) ? -1e-20f : 1e-20f) : d;
    return 1.0f / dd;
}

__device__ __forceinline__ float qbyte(uint32_t w, int sh) {
    return (float)(int)((w >> sh) & 255u);
}

// ---- trail: 4 bits a level, 8 levels a word (the JAX helpers :453-499)
__device__ __forceinline__ uint32_t trail_get(const uint32_t (&tr)[VRT_TRAIL_WORDS],
                                              int level) {
    const int widx = level >> 3;
    uint32_t w = tr[0];
#pragma unroll
    for (int k = 1; k < VRT_TRAIL_WORDS; ++k) w = (widx == k) ? tr[k] : w;
    return (w >> ((level & 7) * 4)) & 0xFu;
}

__device__ __forceinline__ void trail_set(uint32_t (&tr)[VRT_TRAIL_WORDS], int level,
                                          uint32_t val) {
    const int widx = level >> 3;
    const int sh = (level & 7) * 4;
#pragma unroll
    for (int k = 0; k < VRT_TRAIL_WORDS; ++k) {
        const uint32_t nw = (tr[k] & ~(0xFu << sh)) | (val << sh);
        tr[k] = (widx == k) ? nw : tr[k];
    }
}

// Zeroes every level > p.
__device__ __forceinline__ void trail_clear_above(uint32_t (&tr)[VRT_TRAIL_WORDS],
                                                  int p) {
#pragma unroll
    for (int k = 0; k < VRT_TRAIL_WORDS; ++k) {
        const int n = min(max(p + 1 - 8 * k, 0), 8);
        tr[k] &= (n >= 8) ? 0xFFFFFFFFu : ((1u << (n * 4)) - 1u);
    }
}

// Deepest l < level whose nibble is not 4 (bit 2 clear), else -1.
__device__ __forceinline__ int trail_find_parent(const uint32_t (&tr)[VRT_TRAIL_WORDS],
                                                 int level) {
    int best = -1;
#pragma unroll
    for (int k = 0; k < VRT_TRAIL_WORDS; ++k) {
        const int n = min(max(level - 8 * k, 0), 8);
        const uint32_t limit = (n >= 8) ? 0xFFFFFFFFu : ((1u << (n * 4)) - 1u);
        const uint32_t cand = ~tr[k] & 0x44444444u & limit;
        if (cand != 0u) best = 8 * k + ((31 - __clz(cand)) >> 2);
    }
    return best;
}

// ---- the short stack: s0 on top; the oldest entry falls off on overflow
__device__ __forceinline__ void stack_push(Lane& L, int entry) {
    L.s4 = L.s3; L.s3 = L.s2; L.s2 = L.s1; L.s1 = L.s0; L.s0 = entry;
    L.scount = min(L.scount + 1, 5);
    L.stk = true;
}

__device__ __forceinline__ int stack_pop(Lane& L) {
    const int e = L.s0;
    L.s0 = L.s1; L.s1 = L.s2; L.s2 = L.s3; L.s3 = L.s4; L.s4 = 0;
    L.scount -= 1;
    L.stk = true;
    return e;
}

__device__ void walk(const WalkArgs& a, int i, Lane& L) {
    if (L.done || L.suspended || L.visited >= a.max_steps) return;
    const float ox = a.ox[i], oy = a.oy[i], oz = a.oz[i];
    const float dx = a.dx[i], dy = a.dy[i], dz = a.dz[i];
    const float ivx = rcp_clamped(dx), ivy = rcp_clamped(dy), ivz = rcp_clamped(dz);

    while (!L.done && !L.suspended && L.visited < a.max_steps) {
        const int node = min(max(L.node, 0), a.n_nodes - 1);
        const uint4* nrow = a.nodes + (size_t)node * 8;
        const bool in_tlas = node < a.num_tlas;
        // one round of loads: the meta quarter with the child boxes, and a
        // TLAS node's transform and BLAS root
        const uint4 w0 = __ldg(nrow + 0), w1 = __ldg(nrow + 1);
        const uint4 w2 = __ldg(nrow + 2), w3 = __ldg(nrow + 3);
        uint4 w4 = w3, w5 = w3, w6 = w3, w7 = w3;
        if (in_tlas) {
            w4 = __ldg(nrow + 4); w5 = __ldg(nrow + 5);
            w6 = __ldg(nrow + 6); w7 = __ldg(nrow + 7);
        }
        const uint32_t meta = w3.z;
        const uint32_t kind = meta >> 29;
        const int nch = (int)((meta >> 26) & 7u);
        const int left = (int)(meta & VRT_LEFT_MASK);
        const int leaf_data = (int)w3.w;

        int nxt = L.node;
        int level = L.level;
        bool want_pop = false;
        if (kind == 0u) {
            // ---- internal: 4 slab tests, the 5-swap far -> near network
            const float gx = __uint_as_float(w0.x), gy = __uint_as_float(w0.y);
            const float gz = __uint_as_float(w0.z), sx = __uint_as_float(w0.w);
            const float sy = __uint_as_float(w1.x), sz = __uint_as_float(w1.y);
            const uint32_t ql[4] = {w1.z, w1.w, w2.x, w2.y};
            const uint32_t qh[4] = {w2.z, w2.w, w3.x, w3.y};
            const float rox = in_tlas ? ox : L.lox, roy = in_tlas ? oy : L.loy;
            const float roz = in_tlas ? oz : L.loz;
            const float rix = in_tlas ? ivx : L.lix, riy = in_tlas ? ivy : L.liy;
            const float riz = in_tlas ? ivz : L.liz;
            float ds[4];
            int ix[4];
            int m = 0;
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
                const bool hc = (tmax >= tmin) && (tmax > 0.0f) && (c < nch)
                    && (tmin < L.best_t);
                ds[c] = hc ? tmin : -VRT_LARGE;
                ix[c] = c;
                m += (ds[c] > -VRT_LARGE) ? 1 : 0;
            }
            // descending network (0,1) (2,3) (0,2) (1,3) (1,2): swap on '<'
            const int na[5] = {0, 2, 0, 1, 1};
            const int nb[5] = {1, 3, 2, 3, 2};
#pragma unroll
            for (int k = 0; k < 5; ++k) {
                const int p = na[k], q = nb[k];
                if (ds[p] < ds[q]) {
                    const float tf = ds[p]; ds[p] = ds[q]; ds[q] = tf;
                    const int ti = ix[p]; ix[p] = ix[q]; ix[q] = ti;
                }
            }
            const int k_tr = (int)trail_get(L.tr, L.level);
            const int drop = (k_tr == VRT_WIDTH) ? max(m - 1, 0) : min(k_tr, m);
            const int remaining = m - drop;
            const int pos = m - 1 - drop;
            if (remaining >= 1) {
                int slot = ix[0];
#pragma unroll
                for (int k = 1; k < 4; ++k) slot = (pos == k) ? ix[k] : slot;
                nxt = left + slot;
                // the deferred children, the farthest first and flagged last
                if (pos >= 1) stack_push(L, (left + ix[0]) | VRT_LAST_FLAG);
                if (pos >= 2) stack_push(L, left + ix[1]);
                if (pos >= 3) stack_push(L, left + ix[2]);
                if (remaining == 1) trail_set(L.tr, L.level, (uint32_t)VRT_WIDTH);
                level = L.level + 1;
                L.trail_top = max(L.trail_top, level >> 3);
            } else {
                want_pop = true;
            }
        } else if (kind == 1u) {
            // ---- triangle leaf: one row, Moller-Trumbore per slot
            const int row_i = min(max(left, 0), a.n_rows - 1);
            const float4* tr = a.rows + (size_t)row_i * a.row_vec4;
            const bool barrier = node == L.bar_leaf;
            const int n_slots = min(a.lmax, leaf_data);
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
                const float hx_ = L.ldy * e2z - L.ldz * e2y;
                const float hy_ = L.ldz * e2x - L.ldx * e2z;
                const float hz_ = L.ldx * e2y - L.ldy * e2x;
                const float det = e1x * hx_ + e1y * hy_ + e1z * hz_;
                const float fba = 1.0f / ((fabsf(det) < VRT_EPS) ? 1.0f : det);
                const float sx_ = L.lox - v0x, sy_ = L.loy - v0y, sz_ = L.loz - v0z;
                const float w1 = fba * (sx_ * hx_ + sy_ * hy_ + sz_ * hz_);
                const float qx = sy_ * e1z - sz_ * e1y;
                const float qy = sz_ * e1x - sx_ * e1z;
                const float qz = sx_ * e1y - sy_ * e1x;
                const float w2 = fba * (L.ldx * qx + L.ldy * qy + L.ldz * qz);
                float t = fba * (e2x * qx + e2y * qy + e2z * qz);
                bool ok = (fabsf(det) >= VRT_EPS) && (w1 >= 0.0f) && (w1 <= 1.0f)
                    && (w2 >= 0.0f) && (w1 + w2 <= 1.0f) && (t > VRT_EPS);
                if (a.suspend) {
                    const bool beyond = !barrier || (t > L.bar_t)
                        || ((t == L.bar_t) && (tid > L.bar_tid));
                    ok = ok && (t < L.best_t) && beyond;
                }
                t = ok ? t : VRT_LARGE;
                const bool better = (t < t_min)
                    || ((t == t_min) && (t < VRT_LARGE) && (tid < tid_sel));
                if (better) {
                    t_min = t; tid_sel = tid; w1_sel = w1; w2_sel = w2;
                }
            }
            L.tri_tests += leaf_data;
            L.tested = true;
            if (a.suspend) {
                if (t_min < VRT_LARGE) {
                    // stop at the candidate, the stack cleared
                    // (rt_traversal.cpp:151); the ray keeps its node
                    L.pend_t = t_min; L.pend_bx = w1_sel; L.pend_by = w2_sel;
                    L.pend_tri = tid_sel; L.pend_inst = L.inst;
                    L.suspended = true;
                    L.s0 = L.s1 = L.s2 = L.s3 = L.s4 = 0;
                    L.scount = 0;
                    L.stk = true;
                } else {
                    want_pop = true;
                }
            } else {
                const bool closer = t_min < L.best_t;
                const bool tie = (t_min == L.best_t) && (t_min < VRT_LARGE);
                const bool tie_better = tie && ((L.inst < L.best_inst)
                    || ((L.inst == L.best_inst) && (tid_sel < L.tri)));
                if (closer || tie_better) {
                    L.best_t = t_min; L.bx = w1_sel; L.by = w2_sel;
                    L.tri = tid_sel; L.best_inst = L.inst;
                    L.hit = true;
                }
                want_pop = true;
            }
        } else if (kind == 2u) {
            // ---- instance: world ray -> object space, on to the BLAS root
            const float m0 = __uint_as_float(w4.x), m1 = __uint_as_float(w4.y);
            const float m2 = __uint_as_float(w4.z), m3 = __uint_as_float(w4.w);
            const float m4 = __uint_as_float(w5.x), m5 = __uint_as_float(w5.y);
            const float m6 = __uint_as_float(w5.z), m7 = __uint_as_float(w5.w);
            const float m8 = __uint_as_float(w6.x), m9 = __uint_as_float(w6.y);
            const float m10 = __uint_as_float(w6.z), m11 = __uint_as_float(w6.w);
            L.lox = m0 * ox + m1 * oy + m2 * oz + m3;
            L.loy = m4 * ox + m5 * oy + m6 * oz + m7;
            L.loz = m8 * ox + m9 * oy + m10 * oz + m11;
            L.ldx = m0 * dx + m1 * dy + m2 * dz;
            L.ldy = m4 * dx + m5 * dy + m6 * dz;
            L.ldz = m8 * dx + m9 * dy + m10 * dz;
            L.lix = rcp_clamped(L.ldx);
            L.liy = rcp_clamped(L.ldy);
            L.liz = rcp_clamped(L.ldz);
            L.inst = left;
            L.entered = true;
            nxt = (int)w7.x;
        }

        // ---- pop: the deepest unfinished level, then the stack or a
        // restart from the root (rt_traversal.cpp:179-213)
        if (want_pop) {
            const int p = trail_find_parent(L.tr, level);
            if (p < 0) {
                L.done = true;
            } else {
                const uint32_t kp = trail_get(L.tr, p);
                trail_set(L.tr, p, kp + 1u);
                trail_clear_above(L.tr, p);
                if (L.scount == 0) {
                    nxt = 0;
                    level = 0;
                } else {
                    const int entry = stack_pop(L);
                    if ((entry & VRT_LAST_FLAG) != 0)
                        trail_set(L.tr, p, (uint32_t)VRT_WIDTH);
                    nxt = entry & VRT_ID_MASK;
                    level = p + 1;
                }
            }
        }
        L.node = nxt;
        L.level = level;
        ++L.visited;
    }
}

// A lane that is done or suspended at entry touches nothing but its two
// flags.
__global__ void __launch_bounds__(VRT_BLOCK) traverse_wide_kernel(
        const __grid_constant__ WalkArgs a) {
    const int i = blockIdx.x * VRT_BLOCK + threadIdx.x;
    if (i >= a.n_rays) return;
    Lane L;
    L.suspended = ld<uint8_t>(a.st, F_SUSPENDED, i) != 0;
    L.done = ld<uint8_t>(a.st, F_DONE, i) != 0;
    if (L.suspended || L.done) return;
    load_lane(a, i, L);
    walk(a, i, L);
    store_lane(a, i, L);
}

}  // namespace

extern "C" const char* vrt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// Launches the walk on `stream` and returns the first CUDA error (0 = ok).
// `state` is a host array of the 43 WideState fields' device pointers, in
// WideState's order, which the walk updates in place (distinct fields).
extern "C" int vrt_traverse_wide(
        const void* nodes, const void* rows,
        const void* ox, const void* oy, const void* oz,
        const void* dx, const void* dy, const void* dz,
        void* const* state,
        int n_rays, int n_nodes, int n_rows, int row_words, int lmax,
        int num_tlas, int suspend, int max_steps, void* stream) {
    if (n_rays <= 0) return 0;
    if (row_words % 16 != 0 || lmax * 16 > row_words || lmax < 1
            || n_nodes <= 0 || n_rows <= 0) {
        return (int)cudaErrorInvalidValue;
    }
    WalkArgs a;
    a.nodes = (const uint4*)nodes;
    a.rows = (const float4*)rows;
    a.ox = (const float*)ox; a.oy = (const float*)oy; a.oz = (const float*)oz;
    a.dx = (const float*)dx; a.dy = (const float*)dy; a.dz = (const float*)dz;
    for (int k = 0; k < F_COUNT; ++k) a.st[k] = state[k];
    a.n_rays = n_rays; a.n_nodes = n_nodes; a.n_rows = n_rows;
    a.row_vec4 = row_words / 4; a.lmax = lmax; a.num_tlas = num_tlas;
    a.suspend = suspend; a.max_steps = max_steps;
    const int grid = (n_rays + VRT_BLOCK - 1) / VRT_BLOCK;
    traverse_wide_kernel<<<grid, VRT_BLOCK, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

// Blocks of the kernel an SM holds, or minus a CUDA error.
extern "C" int vrt_traverse_wide_blocks_per_sm() {
    int n = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, traverse_wide_kernel, VRT_BLOCK, 0);
    return err == cudaSuccess ? n : -(int)err;
}
