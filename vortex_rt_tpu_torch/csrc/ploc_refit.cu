// ploc_refit.cu — boxes of a PLOC tree's leaf rows and, for the refit,
// of every internal node (kernel K4c).
//
// Replaces `_row_boxes` of vortex_rt_tpu/accel/ploc.py (:316), which
// gathers an (l, leaf, 6) slab of triangle boxes and reduces it, and the
// level sweep of `refit_ploc` (:429, while_loop :466), which visits every
// internal once per creation round (60-90 rounds at a million triangles,
// each a pass over all l - 1 internals).  Here thread j owns leaf row j:
// it reduces the boxes of the row's triangles (sorted slots leaf_tids[j],
// global ids through `order`), writes the row's box — unused rows get
// (_BIG, -_BIG), a box that never wins a union — and, for the refit,
// climbs the parents as csrc/lbvh_refit.cu does: at each internal an
// atomic counter says who came first; the first thread stops, the second
// joins its box with its sibling's (written and fenced), writes the
// parent's and climbs on.  2 * n_int - 1 box joins in all, against the
// sweep's rounds x internals.
//
// The result does not depend on arrival order: min and max are exact, so
// it equals the JAX creation-level sweep (and the build's merge boxes) to
// the bit.  Internals that were never created keep the caller's zeros.
//
// What bounds it: bytes — per leaf row its ids (4 * leaf B) and count,
// 4 B of order and 36 B of vertices per triangle, 24 B of box out per
// node, plus the climb's sibling reads, parents and counters.
//
// Built by vortex_rt_tpu_torch/runtime/kernels.py with nvcc into a shared
// library with a plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr float kBig = 3e38f;

__global__ void boxes_kernel(const float* __restrict__ v0, const float* __restrict__ v1,
                             const float* __restrict__ v2, const int* __restrict__ order,
                             const int* __restrict__ leaf_tids, const int* __restrict__ row_cnt,
                             int l, int lmax, const int* __restrict__ lchild,
                             const int* __restrict__ rchild, const int* __restrict__ parent,
                             int* arrived, float* bmin, float* bmax) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= l) return;
    const bool climb = parent != nullptr;
    long long node = climb ? (long long)(l - 1) + j : j;
    const int cnt = row_cnt[j];
    float mn[3] = {kBig, kBig, kBig}, mx[3] = {-kBig, -kBig, -kBig};
    for (int c = 0; c < lmax && c < cnt; ++c) {
        const int slot = leaf_tids[(long long)j * lmax + c];
        const long long tri = order[min(max(slot, 0), l - 1)];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            const float a = v0[3 * tri + k], b = v1[3 * tri + k], d = v2[3 * tri + k];
            mn[k] = fminf(mn[k], fminf(fminf(a, b), d));
            mx[k] = fmaxf(mx[k], fmaxf(fmaxf(a, b), d));
        }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        bmin[3 * node + k] = mn[k];
        bmax[3 * node + k] = mx[k];
    }
    if (!climb || cnt <= 0) return;  // an unused row has no parent
    while (true) {
        const int p = parent[node];
        __threadfence();  // this node's box is visible before the arrival
        if (atomicAdd(&arrived[p], 1) == 0) return;  // the sibling is not done
        __threadfence();
        const int lc = lchild[p];
        const long long sib = lc == node ? rchild[p] : lc;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            // written by another thread during this launch: not through
            // the read-only path
            mn[k] = fminf(mn[k], __ldcg(&bmin[3 * sib + k]));
            mx[k] = fmaxf(mx[k], __ldcg(&bmax[3 * sib + k]));
        }
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            bmin[3 * p + k] = mn[k];
            bmax[3 * p + k] = mx[k];
        }
        if (p == 0) return;  // the root
        node = p;
    }
}

}  // namespace

extern "C" const char* vrt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// Leaf-row boxes of the vertices v0, v1, v2 ((l, 3) float32), the rows'
// sorted slots leaf_tids (l, lmax) and counts row_cnt (l,), through the
// permutation `order` (l,).  With lchild, rchild (l-1,), parent (2l-1,)
// and arrived ((l-1,) int32, all zero) null: row j's box goes to row j of
// bmin, bmax ((l, 3) float32).  Else the boxes of the whole tree go to
// bmin, bmax ((2l-1, 3), old ids: internals, zero-filled by the caller,
// then the rows).  Returns cudaGetLastError() (0 = ok).
extern "C" int vrt_ploc_boxes(const void* v0, const void* v1, const void* v2, const void* order,
                              const void* leaf_tids, const void* row_cnt, int l, int lmax,
                              const void* lchild, const void* rchild, const void* parent,
                              void* arrived, void* bmin, void* bmax, void* stream) {
    if (l < 2 || lmax < 1 || (parent && !(lchild && rchild && arrived)))
        return (int)cudaErrorInvalidValue;
    boxes_kernel<<<(l + kBlock - 1) / kBlock, kBlock, 0, (cudaStream_t)stream>>>(
        (const float*)v0, (const float*)v1, (const float*)v2, (const int*)order,
        (const int*)leaf_tids, (const int*)row_cnt, l, lmax, (const int*)lchild,
        (const int*)rchild, (const int*)parent, (int*)arrived, (float*)bmin, (float*)bmax);
    return (int)cudaGetLastError();
}
