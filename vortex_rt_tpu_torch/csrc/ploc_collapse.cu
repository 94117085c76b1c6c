// ploc_collapse.cu — the PLOC tree's ids, parents and depth-stride wide
// collapse (kernel K4b).
//
// Replaces the creation-order remap of `build_ploc_topo` of
// vortex_rt_tpu/accel/ploc.py (:393-406, scatters) and `_collapse_ploc`
// (:223), which finds node depths by ready propagation from the root (a
// while_loop of whole-array steps, :247) and builds the child lists with
// stacked selects.  Here a thread owns one internal node:
//
// remap_kernel: old id o < n_int takes the record created as
//   k = n_int-1-o (the root, created last, becomes 0; children encoded
//   -(k'+1) become n_int-1-k'), its children, creation round and box, and
//   writes itself as the parent of its two children.  Rows n_int.. (never
//   created) are zero, as the JAX scatter leaves them.
// expand_kernel: a live internal walks its parents to the root for its
//   binary depth — the value the JAX propagation gives every node it
//   reaches within its 256 rounds (a deeper node keeps 0 there, and here)
//   — and survives at depth % 2 == 0 (width 4) or % 3 == 0 (width 8).
//   Every internal, live or not (the JAX arrays carry the dead rows too),
//   gets the list of descendants two (three) levels down where a leaf row
//   (id >= l-1) takes one slot (ch_old, arity); contrib = a survivor's
//   arity for the caller's prefix sum; the deepest live node's depth goes
//   to one atomicMax (the tree's real depth, ROADMAP H8).
// assign_kernel, after the caller's exclusive prefix sum: thread
//   (survivor i, slot t) gives child ch_old[i][t] its new id base[i] + t.
//   Every node is the wide child of exactly one survivor, so all targets
//   are distinct.
//
// All integers: the topology equals the JAX package's field for field.
// What bounds it: bytes (about 100 B a node at width 8), plus the parent
// walk's dependent loads (tree depth, cached).
//
// Built by vortex_rt_tpu_torch/runtime/kernels.py with nvcc into a shared
// library with a plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kDepthCap = 256;  // rounds of the JAX ready propagation

__global__ void remap_kernel(const int* __restrict__ lk, const int* __restrict__ rk,
                             const int* __restrict__ lvl, const float* __restrict__ bmn,
                             const float* __restrict__ bmx, const int* __restrict__ n_int_p,
                             int l, int* __restrict__ lchild, int* __restrict__ rchild,
                             int* __restrict__ level, float* __restrict__ imin,
                             float* __restrict__ imax, int* __restrict__ parent) {
    const int o = blockIdx.x * blockDim.x + threadIdx.x;
    if (o >= l - 1) return;
    const int n = *n_int_p;
    if (o >= n) {
        lchild[o] = rchild[o] = level[o] = 0;
#pragma unroll
        for (int a = 0; a < 3; ++a) imin[3LL * o + a] = imax[3LL * o + a] = 0.0f;
        return;
    }
    const int k = n - 1 - o;
    int lc = lk[k], rc = rk[k];
    lc = lc >= l - 1 ? lc : n + lc;
    rc = rc >= l - 1 ? rc : n + rc;
    lchild[o] = lc;
    rchild[o] = rc;
    level[o] = lvl[k];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        imin[3LL * o + a] = bmn[3LL * k + a];
        imax[3LL * o + a] = bmx[3LL * k + a];
    }
    parent[lc] = o;
    parent[rc] = o;
}

// descendants of internal n two levels down; a leaf row takes one slot
__device__ __forceinline__ int expand4(const int* __restrict__ lchild,
                                       const int* __restrict__ rchild, int l, int n, int* out) {
    int k = 0;
    const int lc = lchild[n], rc = rchild[n];
    if (lc >= l - 1) {
        out[k++] = lc;
    } else {
        out[k++] = lchild[lc];
        out[k++] = rchild[lc];
    }
    if (rc >= l - 1) {
        out[k++] = rc;
    } else {
        out[k++] = lchild[rc];
        out[k++] = rchild[rc];
    }
    return k;
}

template <int W>
__global__ void expand_kernel(const int* __restrict__ lchild, const int* __restrict__ rchild,
                              const int* __restrict__ parent, const int* __restrict__ n_int_p,
                              int l, unsigned char* __restrict__ surv, int* __restrict__ ch_old,
                              int* __restrict__ arity, int* __restrict__ contrib,
                              int* __restrict__ max_depth) {
    const int o = blockIdx.x * blockDim.x + threadIdx.x;
    if (o >= l - 1) return;
    const bool live = o < *n_int_p;
    int depth = 0;
    if (live) {
        int p = o, d = 0;
        while (p != 0 && d <= kDepthCap) {
            p = parent[p];
            ++d;
        }
        const bool reached = p == 0 && d <= kDepthCap;
        depth = reached ? d : 0;
        atomicMax(max_depth, reached ? d : kDepthCap + 1);
    }
    const bool sv = live && depth % (W == 4 ? 2 : 3) == 0;
    int ch[W];
    int a = 0;
    if (W == 4) {
        a = expand4(lchild, rchild, l, o, ch);
    } else {
        const int c2[2] = {lchild[o], rchild[o]};
#pragma unroll
        for (int s = 0; s < 2; ++s) {
            if (c2[s] >= l - 1) {
                ch[a++] = c2[s];
            } else {
                int sub[4];
                const int m = expand4(lchild, rchild, l, c2[s], sub);
                for (int k = 0; k < m; ++k) ch[a++] = sub[k];
            }
        }
    }
    for (int k = 0; k < W; ++k) ch_old[(long long)o * W + k] = k < a ? ch[k] : -1;
    surv[o] = sv ? 1 : 0;
    arity[o] = a;
    contrib[o] = sv ? a : 0;
}

__global__ void assign_kernel(const unsigned char* __restrict__ surv,
                              const int* __restrict__ ch_old, const int* __restrict__ base, int l,
                              int width, int* __restrict__ newid) {
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= (long long)(l - 1) * width) return;
    if (idx == 0) newid[0] = 0;
    const int i = (int)(idx / width), s = (int)(idx % width);
    if (!surv[i]) return;
    const int c = ch_old[idx];
    if (c >= 0) newid[c] = base[i] + s;
}

inline int blocks(long long n) { return (int)((n + kBlock - 1) / kBlock); }

}  // namespace

extern "C" const char* vrt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// remap_kernel on `stream`.  Inputs in creation order: lk, rk, lvl (l-1,)
// int32, bmn, bmx (l-1, 3) float32; n_int a device int32.  Outputs in old
// ids: lchild, rchild, level (l-1,), imin, imax (l-1, 3); parent (2l-1,)
// zero-filled by the caller.  Returns cudaGetLastError() (0 = ok).
extern "C" int vrt_ploc_remap(const void* lk, const void* rk, const void* lvl, const void* bmn,
                              const void* bmx, const void* n_int, int l, void* lchild,
                              void* rchild, void* level, void* imin, void* imax, void* parent,
                              void* stream) {
    if (l < 2) return (int)cudaErrorInvalidValue;
    remap_kernel<<<blocks(l - 1), kBlock, 0, (cudaStream_t)stream>>>(
        (const int*)lk, (const int*)rk, (const int*)lvl, (const float*)bmn, (const float*)bmx,
        (const int*)n_int, l, (int*)lchild, (int*)rchild, (int*)level, (float*)imin,
        (float*)imax, (int*)parent);
    return (int)cudaGetLastError();
}

// expand_kernel on `stream`.  Inputs: lchild, rchild (l-1,), parent
// (2l-1,) int32, n_int a device int32.  Outputs: surv (l-1,) bytes 0/1,
// ch_old (l-1, width), arity, contrib (l-1,) int32, max_depth a device
// int32 the caller zeroes.  Returns cudaGetLastError() (0 = ok).
extern "C" int vrt_ploc_collapse_expand(const void* lchild, const void* rchild,
                                        const void* parent, const void* n_int, int l, int width,
                                        void* surv, void* ch_old, void* arity, void* contrib,
                                        void* max_depth, void* stream) {
    if (l < 2 || (width != 4 && width != 8)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (width == 4) {
        expand_kernel<4><<<blocks(l - 1), kBlock, 0, s>>>(
            (const int*)lchild, (const int*)rchild, (const int*)parent, (const int*)n_int, l,
            (unsigned char*)surv, (int*)ch_old, (int*)arity, (int*)contrib, (int*)max_depth);
    } else {
        expand_kernel<8><<<blocks(l - 1), kBlock, 0, s>>>(
            (const int*)lchild, (const int*)rchild, (const int*)parent, (const int*)n_int, l,
            (unsigned char*)surv, (int*)ch_old, (int*)arity, (int*)contrib, (int*)max_depth);
    }
    return (int)cudaGetLastError();
}

// assign_kernel on `stream`.  base = 1 + the exclusive prefix sum of
// contrib; newid (2l-1,) filled with -1 by the caller.  Returns
// cudaGetLastError() (0 = ok).
extern "C" int vrt_ploc_collapse_assign(const void* surv, const void* ch_old, const void* base,
                                        int l, int width, void* newid, void* stream) {
    if (l < 2 || (width != 4 && width != 8)) return (int)cudaErrorInvalidValue;
    assign_kernel<<<blocks((long long)(l - 1) * width), kBlock, 0, (cudaStream_t)stream>>>(
        (const unsigned char*)surv, (const int*)ch_old, (const int*)base, l, width, (int*)newid);
    return (int)cudaGetLastError();
}
