// lbvh_collapse.cu — subtree cut and depth-stride collapse of the binary
// Karras tree to 4- or 8-wide nodes (kernel B of K5).
//
// Replaces `_collapse_wide` of vortex_rt_tpu/accel/lbvh.py (:326), which
// finds node depths with a fixed-point sweep over whole arrays (loop at
// :361) and builds the child lists with stacked selects.  Here a thread
// owns one binary node:
//
// parents_kernel: internal i writes itself as the parent of its two
//   children (the root keeps 0).
// expand_kernel: a node whose range holds at most max_leaf triangles is
//   "leafish"; maximal leafish nodes (and triangles directly under the
//   cut) become wide leaves.  A thread walks its parents to the root for
//   its depth — the same integer the sweep gives — and an internal above
//   the cut survives at depth % 2 == 0 (width 4) or % 3 == 0 (width 8).
//   Every internal gets the list of descendants two (three) levels down,
//   clipped at the cut (ch_old, arity): the wide children if it survives.
//   Also written: what the two prefix sums run over (a survivor's arity;
//   one per wide leaf).
// assign_kernel, after the caller's two exclusive prefix sums: thread
//   (survivor i, slot t) gives child ch_old[i][t] its new id base[i] + t,
//   and when that child is a wide leaf fills its leaf row (first sorted
//   slot, count, new id).  Every wide leaf is the child of exactly one
//   survivor, so all targets are distinct.
//
// All integers: the topology equals the JAX package's field for field.
// What bounds it: bytes (about 70 B a node at width 8), plus the parent
// walk's dependent loads (tree depth, cached).
//
// Built by vortex_rt_tpu_torch/runtime/kernels.py with nvcc into a shared
// library with a plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

struct Tree {
    const int* lchild;
    const int* rchild;
    const int* lo;
    const int* hi;
    int l;
    int max_leaf;
};

__device__ __forceinline__ bool leafish(const Tree& t, int n) {
    return t.hi[n] - t.lo[n] + 1 <= t.max_leaf;
}

// old id -> becomes a wide leaf (triangle leaf or cut subtree)
__device__ __forceinline__ bool is_lf(const Tree& t, int c) {
    return c >= t.l - 1 || leafish(t, c);
}

// descendants of internal n two levels down, clipped at the cut
__device__ __forceinline__ int expand4(const Tree& t, int n, int* out) {
    int k = 0;
    const int lc = t.lchild[n], rc = t.rchild[n];
    if (is_lf(t, lc)) {
        out[k++] = lc;
    } else {
        out[k++] = t.lchild[lc];
        out[k++] = t.rchild[lc];
    }
    if (is_lf(t, rc)) {
        out[k++] = rc;
    } else {
        out[k++] = t.lchild[rc];
        out[k++] = t.rchild[rc];
    }
    return k;
}

__global__ void parents_kernel(const int* __restrict__ lchild, const int* __restrict__ rchild,
                               int l, int* __restrict__ parent) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= l - 1) return;
    if (i == 0) parent[0] = 0;
    parent[lchild[i]] = i;
    parent[rchild[i]] = i;
}

template <int W>
__global__ void expand_kernel(Tree t, const int* __restrict__ parent,
                              unsigned char* __restrict__ surv, int* __restrict__ ch_old,
                              int* __restrict__ arity, int* __restrict__ contrib,
                              int* __restrict__ is_max) {
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    const int l = t.l;
    if (n >= 2 * l - 1) return;
    if (n >= l - 1) {  // a triangle leaf: a wide leaf when directly under the cut
        is_max[n] = leafish(t, parent[n]) ? 0 : 1;
        return;
    }
    const bool lf = leafish(t, n);
    is_max[n] = (lf && !leafish(t, parent[n])) ? 1 : 0;
    bool sv = false;
    if (!lf) {
        int depth = 0;
        for (int p = n; p != 0; p = parent[p]) ++depth;
        sv = depth % (W == 4 ? 2 : 3) == 0;
    }
    int ch[W];
    int a = 0;
    if (W == 4) {
        a = expand4(t, n, ch);
    } else {
        const int c2[2] = {t.lchild[n], t.rchild[n]};
#pragma unroll
        for (int s = 0; s < 2; ++s) {
            if (is_lf(t, c2[s])) {
                ch[a++] = c2[s];
            } else {
                int sub[4];
                const int m = expand4(t, c2[s], sub);
                for (int k = 0; k < m; ++k) ch[a++] = sub[k];
            }
        }
    }
    for (int k = 0; k < W; ++k) ch_old[(long long)n * W + k] = k < a ? ch[k] : -1;
    surv[n] = sv ? 1 : 0;
    arity[n] = a;
    contrib[n] = sv ? a : 0;
}

__global__ void assign_kernel(const unsigned char* __restrict__ surv,
                              const int* __restrict__ ch_old, const int* __restrict__ base,
                              const int* __restrict__ lo, const int* __restrict__ hi,
                              const int* __restrict__ row_of, int l, int max_leaf, int width,
                              int* __restrict__ newid, int* __restrict__ row_lo,
                              int* __restrict__ row_cnt, int* __restrict__ leaf_newid) {
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= (long long)(l - 1) * width) return;
    if (idx == 0) newid[0] = 0;
    const int i = (int)(idx / width), s = (int)(idx % width);
    if (!surv[i]) return;
    const int c = ch_old[idx];
    if (c < 0) return;
    const int nid = base[i] + s;
    newid[c] = nid;
    int first, cnt;
    if (c >= l - 1) {
        first = c - (l - 1);
        cnt = 1;
    } else {
        first = lo[c];
        cnt = hi[c] - first + 1;
        if (cnt > max_leaf) return;  // an internal above the cut: no leaf row
    }
    const int r = row_of[c];
    row_lo[r] = first;
    row_cnt[r] = cnt;
    leaf_newid[r] = nid;
}

inline int blocks(long long n) { return (int)((n + kBlock - 1) / kBlock); }

}  // namespace

extern "C" const char* vrt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// parents_kernel then expand_kernel on `stream`.  Inputs: lchild, rchild,
// lo, hi (l-1,) int32.  Outputs: parent (2l-1,) int32, surv (l-1,) bytes
// 0/1, ch_old (l-1, width) int32, arity and contrib (l-1,) int32, is_max
// (2l-1,) int32.  width is 4 or 8.  Returns cudaGetLastError() (0 = ok).
extern "C" int vrt_lbvh_collapse_expand(const void* lchild, const void* rchild, const void* lo,
                                        const void* hi, int l, int max_leaf, int width,
                                        void* parent, void* surv, void* ch_old, void* arity,
                                        void* contrib, void* is_max, void* stream) {
    if (l < 2 || max_leaf < 1 || (width != 4 && width != 8)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    parents_kernel<<<blocks(l - 1), kBlock, 0, s>>>((const int*)lchild, (const int*)rchild, l,
                                                    (int*)parent);
    const Tree t{(const int*)lchild, (const int*)rchild, (const int*)lo, (const int*)hi, l,
                 max_leaf};
    if (width == 4) {
        expand_kernel<4><<<blocks(2LL * l - 1), kBlock, 0, s>>>(
            t, (const int*)parent, (unsigned char*)surv, (int*)ch_old, (int*)arity,
            (int*)contrib, (int*)is_max);
    } else {
        expand_kernel<8><<<blocks(2LL * l - 1), kBlock, 0, s>>>(
            t, (const int*)parent, (unsigned char*)surv, (int*)ch_old, (int*)arity,
            (int*)contrib, (int*)is_max);
    }
    return (int)cudaGetLastError();
}

// assign_kernel on `stream`.  base = 1 + the exclusive prefix sum of
// contrib; row_of = the inclusive prefix sum of is_max, minus 1.  The
// caller fills newid (2l-1,) and leaf_newid (l,) with -1 and row_lo,
// row_cnt (l,) with 0 first.  Returns cudaGetLastError() (0 = ok).
extern "C" int vrt_lbvh_collapse_assign(const void* surv, const void* ch_old, const void* base,
                                        const void* lo, const void* hi, const void* row_of,
                                        int l, int max_leaf, int width, void* newid,
                                        void* row_lo, void* row_cnt, void* leaf_newid,
                                        void* stream) {
    if (l < 2 || max_leaf < 1 || (width != 4 && width != 8)) return (int)cudaErrorInvalidValue;
    assign_kernel<<<blocks((long long)(l - 1) * width), kBlock, 0, (cudaStream_t)stream>>>(
        (const unsigned char*)surv, (const int*)ch_old, (const int*)base, (const int*)lo,
        (const int*)hi, (const int*)row_of, l, max_leaf, width, (int*)newid, (int*)row_lo,
        (int*)row_cnt, (int*)leaf_newid);
    return (int)cudaGetLastError();
}
