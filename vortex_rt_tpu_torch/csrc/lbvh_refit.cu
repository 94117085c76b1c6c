// lbvh_refit.cu — boxes of every node of the binary Karras tree from the
// current vertices: the first half of the per-frame refit (kernel C of
// K5).
//
// Replaces `_leaf_boxes` and `_range_refit` of vortex_rt_tpu/accel/lbvh.py
// (:632, :284).  The TPU version answers every internal node's box as a
// range query over a sparse table of power-of-two windows (log2 T levels
// of T boxes: 480 MB at a million triangles), because gathers are dear
// there.  Here the tree is climbed bottom-up instead (Karras 2012): thread
// j computes the box of sorted triangle j, writes it, and climbs.  At
// each parent an atomic counter says who came first; the first thread
// stops, the second — whose sibling's box is now written and fenced —
// joins the two boxes, writes the parent's, and climbs on.  Chosen over a
// per-node reduction over [lo, hi] because that costs O(range) loads a
// node (the root alone reads every leaf) against 2T - 1 box joins in all
// here; the price is the parent array beside the topology and T - 1
// counters zeroed a call.
//
// The result does not depend on arrival order: min and max are exact and
// a node's box is the join of the same two child boxes whoever computes
// it.  It equals the sparse table's to the bit.
//
// What bounds it: bytes — 36 B of vertices and 4 B of order in per
// triangle, 24 B of box out per node (2T - 1 nodes), plus the climb's
// sibling reads (24 B), parents and counters.
//
// Built by vortex_rt_tpu_torch/runtime/kernels.py with nvcc into a shared
// library with a plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

__global__ void refit_boxes_kernel(const float* __restrict__ v0, const float* __restrict__ v1,
                                   const float* __restrict__ v2, const int* __restrict__ order,
                                   const int* __restrict__ lchild,
                                   const int* __restrict__ rchild,
                                   const int* __restrict__ parent, int l, int* arrived,
                                   float* bmin, float* bmax) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= l) return;
    const long long tri = order[j];
    float mn[3], mx[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float a = v0[3 * tri + k], b = v1[3 * tri + k], c = v2[3 * tri + k];
        mn[k] = fminf(fminf(a, b), c);
        mx[k] = fmaxf(fmaxf(a, b), c);
    }
    long long node = (long long)(l - 1) + j;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        bmin[3 * node + k] = mn[k];
        bmax[3 * node + k] = mx[k];
    }
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

// bmin, bmax ((2l-1, 3) float32, old ids: internals 0..l-2, then the
// sorted triangles) of the tree lchild, rchild (l-1,), parent (2l-1,) over
// the triangles v0, v1, v2 ((l, 3) float32) in the order `order` (l,).
// `arrived` is (l-1,) int32, all zero.  Returns cudaGetLastError().
extern "C" int vrt_lbvh_refit_boxes(const void* v0, const void* v1, const void* v2,
                                    const void* order, const void* lchild, const void* rchild,
                                    const void* parent, int l, void* arrived, void* bmin,
                                    void* bmax, void* stream) {
    if (l < 2) return (int)cudaErrorInvalidValue;
    refit_boxes_kernel<<<(l + kBlock - 1) / kBlock, kBlock, 0, (cudaStream_t)stream>>>(
        (const float*)v0, (const float*)v1, (const float*)v2, (const int*)order,
        (const int*)lchild, (const int*)rchild, (const int*)parent, l, (int*)arrived,
        (float*)bmin, (float*)bmax);
    return (int)cudaGetLastError();
}
