// ploc_refit.cu — boxes of a PLOC tree's leaf rows and, for the refit,
// of every internal node (kernel K4c).
//
// Replaces `_row_boxes` of vortex_rt_tpu/accel/ploc.py (:316), which
// gathers an (l, leaf, 6) slab of triangle boxes and reduces it, and the
// level sweep of `refit_ploc` (:429, while_loop :466), which visits every
// internal once per creation round (60-90 rounds at a million triangles,
// each a pass over all l - 1 internals).  Here thread j owns leaf row j:
// it reduces the boxes of the row's triangles (sorted slots leaf_tids[j],
// global ids through `order`, four slots a round so that their chains of
// dependent loads overlap), writes the row's box — unused rows get
// (_BIG, -_BIG), a box that never wins a union — and, for the refit,
// climbs the parents as csrc/lbvh_refit.cu's treelet roots do: at each
// internal one atomic (release and acquire at device scope) says who
// came first; the first thread stops, the second resets the counter to 0
// for the next launch, joins its box with its sibling's, writes the
// parent's and climbs on.  2 * n_int - 1 box joins in all, against the
// sweep's rounds x internals.  Thread j also writes the zeros of
// internal j when it was never created (j >= n_int, a device scalar), so
// a refit frame is one launch into outputs allocated unfilled, over
// counters the caller zeroes once per topology.
//
// (A plan of treelets of at most 128 rows joined in shared memory, with
// atomics only above them, as K5 C's, cut the kernel from 0.140 to 0.106
// ms at config 5's mesh on an H100, but the plan cost 0.105 ms once a
// topology and some 450 lines: PERF.md, section 6.)
//
// The result does not depend on arrival order: min and max are exact, so
// it equals the JAX creation-level sweep (and the build's merge boxes) to
// the bit.
//
// What bounds it: bytes — per leaf row its ids (4 * leaf B) and count,
// 4 B of order and 36 B of vertices per triangle, 24 B of box out per
// node, plus the climb's sibling reads, parents and counters.
//
// Built by vortex_rt_tpu_torch/runtime/kernels.py with nvcc into a shared
// library with a plain C interface, loaded with ctypes.

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr float kBig = 3e38f;

struct Boxes {
    const float *v0, *v1, *v2;
    const int *order, *leaf_tids, *row_cnt;
    int l, lmax;
    // the refit's (null for the build's leaf-row boxes)
    const int *lchild, *rchild, *parent, *n_int;
    int* arrived;
    float *bmin, *bmax;
};

// The box of leaf row j: the union of its triangles' boxes, four slots a
// round; (kBig, -kBig) for an unused row.
__device__ __forceinline__ void row_box(const Boxes& g, int j, float* mn, float* mx) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        mn[k] = kBig;
        mx[k] = -kBig;
    }
    const int cnt = min(g.row_cnt[j], g.lmax);
    const int* ids = g.leaf_tids + (long long)j * g.lmax;
    for (int c0 = 0; c0 < cnt; c0 += 4) {
        int slot[4];
        long long tri[4];
#pragma unroll
        for (int s = 0; s < 4; ++s) slot[s] = c0 + s < cnt ? ids[c0 + s] : 0;
#pragma unroll
        for (int s = 0; s < 4; ++s)
            tri[s] = c0 + s < cnt ? (long long)g.order[min(max(slot[s], 0), g.l - 1)] : -1;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
            if (tri[s] < 0) continue;
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                const float a = g.v0[3 * tri[s] + k], b = g.v1[3 * tri[s] + k];
                const float d = g.v2[3 * tri[s] + k];
                mn[k] = fminf(mn[k], fminf(fminf(a, b), d));
                mx[k] = fmaxf(mx[k], fmaxf(fmaxf(a, b), d));
            }
        }
    }
}

__device__ __forceinline__ void put_box(float* bmin, float* bmax, long long node,
                                        const float* mn, const float* mx) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        bmin[3 * node + k] = mn[k];
        bmax[3 * node + k] = mx[k];
    }
}

__global__ void __launch_bounds__(kBlock) boxes_kernel(Boxes g) {
    const int j = blockIdx.x * kBlock + threadIdx.x;
    if (j >= g.l) return;
    float mn[3], mx[3];
    row_box(g, j, mn, mx);
    if (g.parent == nullptr) {  // the build's leaf-row boxes
        put_box(g.bmin, g.bmax, j, mn, mx);
        return;
    }
    if (j < g.l - 1 && j >= *g.n_int) {  // an internal never created
        const float zero[3] = {0.0f, 0.0f, 0.0f};
        put_box(g.bmin, g.bmax, j, zero, zero);
    }
    long long node = (long long)(g.l - 1) + j;
    put_box(g.bmin, g.bmax, node, mn, mx);
    if (g.row_cnt[j] <= 0) return;  // an unused row has no parent
    while (node != 0) {
        const int p = g.parent[node];
        // (the topology's words in flight during the arrival)
        const int lc = g.lchild[p], rc = g.rchild[p];
        cuda::atomic_ref<int, cuda::thread_scope_device> arrived(g.arrived[p]);
        if (arrived.fetch_add(1, cuda::memory_order_acq_rel) == 0) return;
        arrived.store(0, cuda::memory_order_relaxed);  // ready for the next launch
        const long long sib = lc == node ? rc : lc;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            // written by another thread during this launch: not through
            // the read-only path
            mn[k] = fminf(mn[k], __ldcg(&g.bmin[3 * sib + k]));
            mx[k] = fmaxf(mx[k], __ldcg(&g.bmax[3 * sib + k]));
        }
        put_box(g.bmin, g.bmax, p, mn, mx);
        node = p;
    }
}

}  // namespace

extern "C" const char* vrt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// Leaf-row boxes of the vertices v0, v1, v2 ((l, 3) float32), the rows'
// sorted slots leaf_tids (l, lmax) and counts row_cnt (l,), through the
// permutation `order` (l,).  With lchild, rchild (l-1,), parent (2l-1,),
// n_int (a device int32) and arrived ((l-1,) int32, zero) null: row j's
// box goes to row j of bmin, bmax ((l, 3) float32).  Else the boxes of
// the whole tree go to bmin, bmax ((2l-1, 3), old ids: internals, those
// never created zero, then the rows), allocated unfilled; arrived is zero
// again after the launch.  Returns cudaGetLastError() (0 = ok).
extern "C" int vrt_ploc_boxes(const void* v0, const void* v1, const void* v2, const void* order,
                              const void* leaf_tids, const void* row_cnt, int l, int lmax,
                              const void* lchild, const void* rchild, const void* parent,
                              const void* n_int, void* arrived, void* bmin, void* bmax,
                              void* stream) {
    if (l < 2 || lmax < 1 || (parent && !(lchild && rchild && n_int && arrived)))
        return (int)cudaErrorInvalidValue;
    const Boxes g{(const float*)v0,     (const float*)v1,        (const float*)v2,
                  (const int*)order,    (const int*)leaf_tids,   (const int*)row_cnt,
                  l,                    lmax,                    (const int*)lchild,
                  (const int*)rchild,   (const int*)parent,      (const int*)n_int,
                  (int*)arrived,        (float*)bmin,            (float*)bmax};
    boxes_kernel<<<(l + kBlock - 1) / kBlock, kBlock, 0, (cudaStream_t)stream>>>(g);
    return (int)cudaGetLastError();
}
