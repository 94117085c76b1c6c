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
// Design.  One thread walks one ray to its end; its stack (stack_depth <=
// 64 ints) lives in local memory, the rest of its state in registers.  The
// tables are read as the JAX arrays are laid out (boxes (P, 3), kind, left
// and count (P,), vertices (V, 3), inverse transforms (I, 4, 4)), a few
// scalar loads a step.  The JAX loop steps every lane under one global
// `max_steps`, and a lane that is done is frozen; one thread walking its
// ray under a cap of its own is the same walk, so the per-ray
// `nodes_visited` and `tri_tests` equal the JAX lane's.  A ray whose
// `active` flag is 0 takes no step and keeps the initial record.
//
// What bounds it on this card: the latency of dependent loads (a step's
// node comes from the last step's loads) and divergence (a warp runs until
// its longest ray ends).  This first version is simple and right, not
// fast; no library call computes a stack walk.
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
#define VRT_POP (-1)

enum { KIND_INTERNAL = 0, KIND_INSTANCE = 1, KIND_TRIS = 2 };

namespace {

struct WalkArgs {
    const float* nmin; const float* nmax;   // (P, 3)
    const int* left; const int* count; const int* kind;  // (P,)
    const int* tri_idx;                     // (T,)
    const float* v0; const float* v1; const float* v2;  // (V, 3)
    const float* inst_inv;                  // (I, 4, 4)
    const int* inst_root;                   // (I,)
    const float* o; const float* d;         // (R, 3)
    const uint8_t* active;                  // (R,) bool or null
    float* dist; float* bx; float* by; float* bz;
    int* tri; int* inst; int* visited; int* tests;
    int n_rays, n_pool, n_slots, n_tris, n_inst, lmax, num_tlas;
    int stack_depth, max_steps;
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
__device__ __forceinline__ float slab(const float* nmin, const float* nmax,
                                      int c, float ox, float oy, float oz,
                                      float ix, float iy, float iz,
                                      bool& hit) {
    float t1x = (nmin[3 * c] - ox) * ix, t2x = (nmax[3 * c] - ox) * ix;
    float t1y = (nmin[3 * c + 1] - oy) * iy, t2y = (nmax[3 * c + 1] - oy) * iy;
    float t1z = (nmin[3 * c + 2] - oz) * iz, t2z = (nmax[3 * c + 2] - oz) * iz;
    float tmin = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                       fminf(t1z, t2z));
    float tmax = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                       fmaxf(t1z, t2z));
    hit = (tmax >= tmin) && (tmax > 0.0f);
    return hit ? tmin : VRT_LARGE;
}

__global__ void __launch_bounds__(VRT_BLOCK)
traverse2_kernel(const WalkArgs a) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= a.n_rays) return;
    const float ox = a.o[3 * i], oy = a.o[3 * i + 1], oz = a.o[3 * i + 2];
    const float dx = a.d[3 * i], dy = a.d[3 * i + 1], dz = a.d[3 * i + 2];
    const float wix = safe_rcp(dx), wiy = safe_rcp(dy), wiz = safe_rcp(dz);
    float lox = ox, loy = oy, loz = oz, ldx = dx, ldy = dy, ldz = dz;
    float lix = wix, liy = wiy, liz = wiz;
    float best_t = a.t_max, bx = 0.0f, by = 0.0f;
    int tri = 0, best_inst = 0, inst = 0, visited = 0, tests = 0;
    const int D = a.stack_depth;
    int stack[VRT_STACK_MAX];
    int sp = 0, node = 0;
    bool live = a.active == nullptr || a.active[i] != 0;
    while (live && visited < a.max_steps) {
        const int nd = clampi(node, 0, a.n_pool - 1);
        const int kind = a.kind[nd];
        const int lft = a.left[nd];
        int nxt = VRT_POP;
        if (kind == KIND_INTERNAL) {
            const bool tlas = nd < a.num_tlas;
            const float rx = tlas ? ox : lox, ry = tlas ? oy : loy,
                        rz = tlas ? oz : loz;
            const float ix = tlas ? wix : lix, iy = tlas ? wiy : liy,
                        iz = tlas ? wiz : liz;
            const int l = clampi(lft, 0, a.n_pool - 2), r = l + 1;
            bool hl, hr;
            const float tl = slab(a.nmin, a.nmax, l, rx, ry, rz, ix, iy, iz, hl);
            const float tr = slab(a.nmin, a.nmax, r, rx, ry, rz, ix, iy, iz, hr);
            hl = hl && (tl <= best_t);
            hr = hr && (tr <= best_t);
            const bool l_first = tl <= tr;
            if (hl && hr) {
                nxt = l_first ? l : r;
                stack[sp < D - 1 ? sp : D - 1] = l_first ? r : l;
                ++sp;
            } else if (hl) {
                nxt = l;
            } else if (hr) {
                nxt = r;
            }
        } else if (kind == KIND_INSTANCE) {
            const int iid = clampi(lft, 0, a.n_inst - 1);
            const float* m = a.inst_inv + 16 * iid;
            lox = (m[0] * ox + m[1] * oy) + m[2] * oz + m[3];
            loy = (m[4] * ox + m[5] * oy) + m[6] * oz + m[7];
            loz = (m[8] * ox + m[9] * oy) + m[10] * oz + m[11];
            ldx = (m[0] * dx + m[1] * dy) + m[2] * dz;
            ldy = (m[4] * dx + m[5] * dy) + m[6] * dz;
            ldz = (m[8] * dx + m[9] * dy) + m[10] * dz;
            lix = safe_rcp(ldx); liy = safe_rcp(ldy); liz = safe_rcp(ldz);
            inst = iid;
            nxt = a.inst_root[iid];
        } else if (kind == KIND_TRIS) {
            const int cnt = a.count[nd];
            const int n = cnt < a.lmax ? cnt : a.lmax;
            float t_min = VRT_LARGE, w1_sel = 0.0f, w2_sel = 0.0f;
            int tid_sel = VRT_INT_MAX;
            for (int j = 0; j < n; ++j) {
                const int slot = clampi(lft + j, 0, a.n_slots - 1);
                const int tid = clampi(a.tri_idx[slot], 0, a.n_tris - 1);
                const float* p0 = a.v0 + 3 * tid;
                const float* p1 = a.v1 + 3 * tid;
                const float* p2 = a.v2 + 3 * tid;
                const float e1x = p1[0] - p0[0], e1y = p1[1] - p0[1],
                            e1z = p1[2] - p0[2];
                const float e2x = p2[0] - p0[0], e2y = p2[1] - p0[1],
                            e2z = p2[2] - p0[2];
                const float hx = ldy * e2z - ldz * e2y;
                const float hy = ldz * e2x - ldx * e2z;
                const float hz = ldx * e2y - ldy * e2x;
                const float av = (e1x * hx + e1y * hy) + e1z * hz;
                const bool small = fabsf(av) < VRT_EPS;
                const float f = 1.0f / (small ? 1.0f : av);
                const float sx = lox - p0[0], sy = loy - p0[1],
                            sz = loz - p0[2];
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
        if (nxt == VRT_POP) {
            if (sp <= 0) break;
            --sp;
            nxt = stack[sp < D - 1 ? sp : D - 1];
        }
        node = nxt;
    }
    a.dist[i] = best_t; a.bx[i] = bx; a.by[i] = by;
    a.bz[i] = (1.0f - bx) - by;
    a.tri[i] = tri; a.inst[i] = best_inst;
    a.visited[i] = visited; a.tests[i] = tests;
}

}  // namespace

extern "C" const char* vrt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// Launches the walk on `stream` and returns the first CUDA error (0 = ok).
// `out` is a host array of the 8 output pointers (dist, bx, by, bz, tri,
// inst, nodes_visited, tri_tests), each (R,); the caller allocates them.
extern "C" int vrt_traverse2(
        const void* nmin, const void* nmax, const void* left,
        const void* count, const void* kind, const void* tri_idx,
        const void* v0, const void* v1, const void* v2,
        const void* inst_inv, const void* inst_root,
        const void* o, const void* d, const void* active,
        void* const* out, int n_rays, int n_pool, int n_slots, int n_tris,
        int n_inst, int lmax, int num_tlas, int stack_depth, int max_steps,
        float t_max, void* stream) {
    if (n_rays <= 0) return 0;
    if (n_pool < 2 || n_slots < 1 || n_tris < 1 || n_inst < 1 || lmax < 1
            || stack_depth < 1 || stack_depth > VRT_STACK_MAX) {
        return (int)cudaErrorInvalidValue;
    }
    WalkArgs a;
    a.nmin = (const float*)nmin; a.nmax = (const float*)nmax;
    a.left = (const int*)left; a.count = (const int*)count;
    a.kind = (const int*)kind; a.tri_idx = (const int*)tri_idx;
    a.v0 = (const float*)v0; a.v1 = (const float*)v1; a.v2 = (const float*)v2;
    a.inst_inv = (const float*)inst_inv; a.inst_root = (const int*)inst_root;
    a.o = (const float*)o; a.d = (const float*)d;
    a.active = (const uint8_t*)active;
    a.dist = (float*)out[0]; a.bx = (float*)out[1]; a.by = (float*)out[2];
    a.bz = (float*)out[3]; a.tri = (int*)out[4]; a.inst = (int*)out[5];
    a.visited = (int*)out[6]; a.tests = (int*)out[7];
    a.n_rays = n_rays; a.n_pool = n_pool; a.n_slots = n_slots;
    a.n_tris = n_tris; a.n_inst = n_inst; a.lmax = lmax;
    a.num_tlas = num_tlas; a.stack_depth = stack_depth;
    a.max_steps = max_steps; a.t_max = t_max;
    const int grid = (n_rays + VRT_BLOCK - 1) / VRT_BLOCK;
    traverse2_kernel<<<grid, VRT_BLOCK, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
