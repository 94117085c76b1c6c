// traverse2.cu — the binary TLAS+BLAS closest-hit walk on Hopper (K6).
//
// Replaces the XLA while_loop `trace_rays` of
// vortex_rt_tpu/ops/traverse2.py:143 (loop :281, body :178-279), the
// engine of the megakernel renderer (engine/megakernel.py).  It walks one
// merged node pool (TLAS nodes [0, K), BLAS node i at K + i) as the JAX
// body decides at each step:
// - TLAS nodes (node < num_tlas) test the world ray, BLAS nodes the
//   current object-space ray;
// - an internal node slab-tests both children with the non-strict
//   `t <= best_t` prune, goes to the near child (left on tl <= tr) and
//   pushes the far one when both hit;
// - an instance leaf moves the ray into object space (the 3x4 inverse
//   transform, then safe_rcp of the new direction) and jumps to the
//   instance's BLAS root;
// - a triangle leaf runs its Moller-Trumbore slots, folds them by (t, tid)
//   and updates the best hit on (t, inst, tid).
// The stack overflows as the JAX arrays do: a push writes
// stack[min(sp, D-1)] while sp keeps counting, a pop reads
// stack[min(max(sp-1, 0), D-1)] (the JAX gather clamps its index).
//
// What bounds it on this card: the latency of dependent loads (a step's
// node comes from the last step's loads; ~200 ns a round in L2) and
// divergence (a warp runs until its longest ray ends).  The design:
// - one record read a step.  The tables are packed once per scene
//   (ops/traverse2.py, pack_walk_tables): a 64-B record a pool node,
//   64-B aligned, holding its kind, left (clamped as the walk clamps it)
//   and count, and at an internal node both children's boxes, at an
//   instance node its 3x4 inverse transform and BLAS root.  The next
//   node's four 16-B vectors are requested together at the end of a step,
//   so an internal or instance step waits for one round of loads, not for
//   the kind and then the boxes or the instance;
// - a leaf slot's record (48 B: v0, e1 = v1 - v0, e2 = v2 - v0, the
//   clamped triangle id) sits in slot order: a leaf reads contiguous
//   records, with no triangle-id indirection (e1 and e2 are the float32
//   differences the walk itself takes, so the same bits);
// - the stack lives in shared memory, entry e of thread t at
//   [e * VRT_BLOCK + t] (no bank conflicts), min(D, the pool's levels)
//   entries, sized at launch: a walk never holds more entries than the
//   pool has levels, so the clamp min(sp, D-1) is the same clamp as
//   min(sp, entries-1) (ops/traverse2.py), and the kernel keeps no
//   local-memory stack frame;
// - while-while: a warp steps internal nodes while any lane is at one,
//   then leaves and instances while any lane is at one, so a warp whose
//   lanes are split does not run every branch each step.
// One thread walks one ray to its end under a cap of its own; the JAX loop
// steps every lane under one global `max_steps` and freezes a lane that
// is done, which is the same walk, so the per-ray `nodes_visited` and
// `tri_tests` equal the JAX lane's.  A ray whose `active` flag is 0 takes
// no step and keeps the initial record.  No library call computes a stack
// walk.
//
// Numerics match the JAX body and the plain PyTorch version bit for bit:
// every 3-term dot product as (a0*b0 + a1*b1) + a2*b2, true divisions for
// 1/a and 1/d, the |d| < 1e-20 reciprocal clamp, no contraction into FMA
// (-fmad=false, no --use_fast_math).
//
// Built by vortex_rt_tpu_torch/runtime/kernels.py with nvcc into a shared
// library with a plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

#define VRT_LARGE 1e30f
#define VRT_EPS 1e-6f
#define VRT_RCP_EPS 1e-20f
#define VRT_INT_MAX 2147483647
#define VRT_STACK_MAX 64
#define VRT_BLOCK 128
#define VRT_STK_STRIDE VRT_BLOCK  // ints between a thread's stack entries

enum { KIND_INTERNAL = 0, KIND_INSTANCE = 1, KIND_TRIS = 2 };

namespace {

struct WalkArgs {
    const int4* nodes;      // (P, 16) words: 4 int4 a record
    const float4* tris;     // (S, 12) words: 3 float4 a record
    const float* o; const float* d;         // (R, 3)
    const uint8_t* active;                  // (R,) bool or null
    float* dist; float* bx; float* by; float* bz;
    int* tri; int* inst; int* visited; int* tests;
    int n_rays, n_pool, n_slots, lmax, num_tlas;
    int stack_n, max_steps;  // stack_n = min(D, levels) entries
    float t_max;
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ float safe_rcp(float d) {
    float s = fabsf(d) < VRT_RCP_EPS ? (d < 0.0f ? -VRT_RCP_EPS : VRT_RCP_EPS)
                                     : d;
    return 1.0f / s;
}

// ray_aabb of the JAX package: t_enter on a hit, VRT_LARGE on a miss
__device__ __forceinline__ float slab(float mnx, float mny, float mnz,
                                      float mxx, float mxy, float mxz,
                                      float ox, float oy, float oz,
                                      float ix, float iy, float iz,
                                      bool& hit) {
    const float t1x = (mnx - ox) * ix, t2x = (mxx - ox) * ix;
    const float t1y = (mny - oy) * iy, t2y = (mxy - oy) * iy;
    const float t1z = (mnz - oz) * iz, t2z = (mxz - oz) * iz;
    const float tmin = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                             fminf(t1z, t2z));
    const float tmax = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                             fmaxf(t1z, t2z));
    hit = (tmax >= tmin) && (tmax > 0.0f);
    return hit ? tmin : VRT_LARGE;
}

// A node's record: the header (kind, left, count, BLAS root) and 12 words
// of child boxes or instance rows, requested together.
struct Record {
    int4 h;
    float4 b0, b1, b2;
};

__device__ __forceinline__ Record fetch(const WalkArgs& a, int nd) {
    const int4* r = a.nodes + 4 * (size_t)nd;
    Record rec;
    rec.h = __ldg(r);
    const int4 x = __ldg(r + 1), y = __ldg(r + 2), z = __ldg(r + 3);
    rec.b0 = make_float4(__int_as_float(x.x), __int_as_float(x.y),
                         __int_as_float(x.z), __int_as_float(x.w));
    rec.b1 = make_float4(__int_as_float(y.x), __int_as_float(y.y),
                         __int_as_float(y.z), __int_as_float(y.w));
    rec.b2 = make_float4(__int_as_float(z.x), __int_as_float(z.y),
                         __int_as_float(z.z), __int_as_float(z.w));
    return rec;
}

// Walks ray i; `stk` is this thread's first stack entry in shared memory.
__device__ __forceinline__ void walk_ray(const WalkArgs& a, int i, int* stk) {
    float best_t = a.t_max, bx = 0.0f, by = 0.0f;
    int tri = 0, best_inst = 0, inst = 0, visited = 0, tests = 0;
    bool live = (a.active == nullptr || a.active[i] != 0) && a.max_steps > 0;
    float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
    float wix = 0.0f, wiy = 0.0f, wiz = 0.0f;
    int nd = 0, sp = 0;
    Record rec;
    if (live) {  // a ray that never walks needs no o, d or record
        ox = a.o[3 * i]; oy = a.o[3 * i + 1]; oz = a.o[3 * i + 2];
        dx = a.d[3 * i]; dy = a.d[3 * i + 1]; dz = a.d[3 * i + 2];
        wix = safe_rcp(dx); wiy = safe_rcp(dy); wiz = safe_rcp(dz);
        rec = fetch(a, 0);
    }
    float lox = ox, loy = oy, loz = oz, ldx = dx, ldy = dy, ldz = dz;
    float lix = wix, liy = wiy, liz = wiz;
    const int top = a.stack_n - 1;

    while (live) {
        // ---- while-while: internal steps while any lane is at an
        // internal node, then leaf and instance steps
        while (live && rec.h.x == KIND_INTERNAL) {
            const bool tlas = nd < a.num_tlas;
            const float rx = tlas ? ox : lox, ry = tlas ? oy : loy,
                        rz = tlas ? oz : loz;
            const float ix = tlas ? wix : lix, iy = tlas ? wiy : liy,
                        iz = tlas ? wiz : liz;
            const int l = rec.h.y, r = l + 1;  // clamped by the packer
            bool hl, hr;
            const float tl = slab(rec.b0.x, rec.b0.y, rec.b0.z, rec.b0.w,
                                  rec.b1.x, rec.b1.y, rx, ry, rz, ix, iy, iz,
                                  hl);
            const float tr = slab(rec.b1.z, rec.b1.w, rec.b2.x, rec.b2.y,
                                  rec.b2.z, rec.b2.w, rx, ry, rz, ix, iy, iz,
                                  hr);
            hl = hl && (tl <= best_t);
            hr = hr && (tr <= best_t);
            const bool l_first = tl <= tr;
            int nxt;
            if (hl && hr) {
                nxt = l_first ? l : r;
                stk[min(sp, top) * VRT_STK_STRIDE] = l_first ? r : l;
                ++sp;
            } else if (hl) {
                nxt = l;
            } else if (hr) {
                nxt = r;
            } else if (sp > 0) {
                --sp;
                nxt = stk[min(sp, top) * VRT_STK_STRIDE];
            } else {
                nxt = 0;
                live = false;
            }
            ++visited;
            if (visited >= a.max_steps) live = false;
            if (live) {
                nd = clampi(nxt, 0, a.n_pool - 1);
                rec = fetch(a, nd);
            }
        }
        while (live && rec.h.x != KIND_INTERNAL) {
            bool jump = false;
            int nxt = 0;
            if (rec.h.x == KIND_INSTANCE) {
                // rows 0-2 of the inverse transform, in the record
                const float4 m0 = rec.b0, m1 = rec.b1, m2 = rec.b2;
                lox = (m0.x * ox + m0.y * oy) + m0.z * oz + m0.w;
                loy = (m1.x * ox + m1.y * oy) + m1.z * oz + m1.w;
                loz = (m2.x * ox + m2.y * oy) + m2.z * oz + m2.w;
                ldx = (m0.x * dx + m0.y * dy) + m0.z * dz;
                ldy = (m1.x * dx + m1.y * dy) + m1.z * dz;
                ldz = (m2.x * dx + m2.y * dy) + m2.z * dz;
                lix = safe_rcp(ldx); liy = safe_rcp(ldy); liz = safe_rcp(ldz);
                inst = rec.h.y;  // clamped by the packer
                nxt = rec.h.w;
                jump = true;
            } else if (rec.h.x == KIND_TRIS) {
                const int cnt = rec.h.z;
                const int n = cnt < a.lmax ? cnt : a.lmax;
                float t_min = VRT_LARGE, w1_sel = 0.0f, w2_sel = 0.0f;
                int tid_sel = VRT_INT_MAX;
                for (int j = 0; j < n; ++j) {
                    const float4* sr =
                        a.tris + 3 * (size_t)clampi(rec.h.y + j, 0,
                                                    a.n_slots - 1);
                    const float4 p = __ldg(sr), q = __ldg(sr + 1),
                                 s = __ldg(sr + 2);
                    const float v0x = p.x, v0y = p.y, v0z = p.z;
                    const float e1x = p.w, e1y = q.x, e1z = q.y;
                    const float e2x = q.z, e2y = q.w, e2z = s.x;
                    const int tid = __float_as_int(s.y);
                    const float hx = ldy * e2z - ldz * e2y;
                    const float hy = ldz * e2x - ldx * e2z;
                    const float hz = ldx * e2y - ldy * e2x;
                    const float av = (e1x * hx + e1y * hy) + e1z * hz;
                    const bool small = fabsf(av) < VRT_EPS;
                    const float f = 1.0f / (small ? 1.0f : av);
                    const float sx = lox - v0x, sy = loy - v0y, sz = loz - v0z;
                    const float w1 = f * ((sx * hx + sy * hy) + sz * hz);
                    const float qx = sy * e1z - sz * e1y;
                    const float qy = sz * e1x - sx * e1z;
                    const float qz = sx * e1y - sy * e1x;
                    const float w2 = f * ((ldx * qx + ldy * qy) + ldz * qz);
                    float t = f * ((e2x * qx + e2y * qy) + e2z * qz);
                    const bool ok = !small && w1 >= 0.0f && w1 <= 1.0f
                                    && w2 >= 0.0f && w1 + w2 <= 1.0f
                                    && t > VRT_EPS;
                    t = ok ? t : VRT_LARGE;
                    // the smallest t, then the smallest triangle id
                    if (t < t_min || (t == t_min && tid < tid_sel)) {
                        t_min = t; tid_sel = tid; w1_sel = w1; w2_sel = w2;
                    }
                }
                const bool closer = t_min < best_t;
                const bool tie = t_min == best_t && t_min < VRT_LARGE
                                 && (inst < best_inst
                                     || (inst == best_inst && tid_sel < tri));
                if (closer || tie) {
                    best_t = t_min; bx = w1_sel; by = w2_sel;
                    tri = tid_sel; best_inst = inst;
                }
                tests += cnt;
            }
            ++visited;
            if (!jump) {  // a leaf (or an unknown kind) pops
                if (sp > 0) {
                    --sp;
                    nxt = stk[min(sp, top) * VRT_STK_STRIDE];
                } else {
                    live = false;
                }
            }
            if (visited >= a.max_steps) live = false;
            if (live) {
                nd = clampi(nxt, 0, a.n_pool - 1);
                rec = fetch(a, nd);
            }
        }
    }
    a.dist[i] = best_t; a.bx[i] = bx; a.by[i] = by;
    a.bz[i] = (1.0f - bx) - by;
    a.tri[i] = tri; a.inst[i] = best_inst;
    a.visited[i] = visited; a.tests[i] = tests;
}

__global__ void __launch_bounds__(VRT_BLOCK)
traverse2_kernel(const __grid_constant__ WalkArgs a) {
    // the stack: entry e of thread t at stack_smem[e * VRT_STK_STRIDE + t]
    extern __shared__ int stack_smem[];
    const int i = blockIdx.x * VRT_BLOCK + threadIdx.x;
    if (i < a.n_rays) walk_ray(a, i, stack_smem + threadIdx.x);
}

}  // namespace

extern "C" int vrt_traverse2_stack_max(void) { return VRT_STACK_MAX; }

extern "C" const char* vrt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// Launches the walk on `stream` and returns the first CUDA error (0 = ok).
// `nodes` (n_pool, 16) and `tris` (n_slots, 12) are the packed records;
// `out` is a host array of the 8 output pointers (dist, bx, by, bz, tri,
// inst, nodes_visited, tri_tests), each (R,); the caller allocates them.
// `stack_depth` is the JAX stack's D, `stack_n` the entries the kernel
// keeps: min(D, the pool's levels).
extern "C" int vrt_traverse2(
        const void* nodes, const void* tris, const void* o, const void* d,
        const void* active, void* const* out, int n_rays, int n_pool,
        int n_slots, int lmax, int num_tlas, int stack_depth, int stack_n,
        int max_steps, float t_max, void* stream) {
    if (n_rays <= 0) return 0;
    if (n_pool < 2 || n_slots < 1 || lmax < 1 || stack_depth < 1
            || stack_depth > VRT_STACK_MAX || stack_n < 1
            || stack_n > stack_depth) {
        return (int)cudaErrorInvalidValue;
    }
    WalkArgs a;
    a.nodes = (const int4*)nodes; a.tris = (const float4*)tris;
    a.o = (const float*)o; a.d = (const float*)d;
    a.active = (const uint8_t*)active;
    a.dist = (float*)out[0]; a.bx = (float*)out[1]; a.by = (float*)out[2];
    a.bz = (float*)out[3]; a.tri = (int*)out[4]; a.inst = (int*)out[5];
    a.visited = (int*)out[6]; a.tests = (int*)out[7];
    a.n_rays = n_rays; a.n_pool = n_pool; a.n_slots = n_slots;
    a.lmax = lmax; a.num_tlas = num_tlas; a.stack_n = stack_n;
    a.max_steps = max_steps; a.t_max = t_max;
    const int grid = (n_rays + VRT_BLOCK - 1) / VRT_BLOCK;
    const size_t smem = (size_t)stack_n * sizeof(int) * VRT_BLOCK;
    traverse2_kernel<<<grid, VRT_BLOCK, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
