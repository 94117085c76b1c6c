// lbvh_pack.cu — quantize the wide nodes and pack the traversal tables:
// the second half of the per-frame refit (kernel D of K5).
//
// Replaces `_pack_wide` and `_leaf_rows` of vortex_rt_tpu/accel/lbvh.py
// (:466, :578) and, when asked, `WideArrays.fuse` behind them
// (ops/traverse_wide.py): XLA builds whole record columns and scatters
// them; here a thread builds one record and writes it where it belongs.
//
// pack_nodes_kernel: one thread per survivor (of the compact survivor list
//   when given, else of all internals).  It gathers its wide children's
//   boxes from the binary box arrays, takes their join [org, top], the
//   scale 2^e with e = clip(ceil(log2(extent / 255)), -126, 127) read
//   exactly from the bits of extent / 255 (the exponent field, plus one
//   when a mantissa bit is set: no log2), quantizes each child box to
//   bytes — floor - 1 below, ceil + 1 above, clipped to [0, 255], so every
//   box grows by one step — and writes the 32-word record at its new id:
//   org, scale, the lo and hi words, and the meta word
//   left | arity << 26 (width 4) or 25 (width 8) | kind << 29.
// pack_leaves_kernel: one thread per leaf row.  It writes the row's
//   triangles (v0, e1, e2, global triangle id; empty slots zero with id
//   -1) and the leaf record at the row's new id.  Slot c of row j is the
//   sorted triangle row_lo[j] + c (a Morton range, K5), or, when
//   `leaf_tids` is given, leaf_tids[j][c]: the explicit triangle sets of
//   a PLOC tree (kernel K4d; replaces `_rows_from_tids` of
//   vortex_rt_tpu/accel/ploc.py:335, which gathers whole (l, leaf, 9)
//   slabs and sets the row columns one by one).
// Both write `nodes` (+ `tri_rows`) and, when `fused` is given, the fused
// (pool, 32 + 16 * leaf) table the 8-wide walk reads: a node's record,
// then its own triangle row if it is a leaf.  The caller zeroes nodes and
// fused first; all targets are distinct.
//
// What bounds it: bytes — per survivor `width` child boxes of 24 B in and
// 128 B out (twice with the fused table); per leaf row 40 B a triangle in
// and 64 B a slot out (twice with the fused table).
//
// Built by vortex_rt_tpu_torch/runtime/kernels.py with nvcc into a shared
// library with a plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;
constexpr int kRowWords = 32;
constexpr unsigned kKindInternal = 0u, kKindTris = 1u;

struct Layout {
    int qlo, qhi, meta, leaf, left_bits;
};

__device__ __forceinline__ Layout layout(int width) {
    return width == 4 ? Layout{6, 10, 14, 15, 26} : Layout{6, 14, 22, 23, 25};
}

__device__ __forceinline__ unsigned qbyte(float b, float org, float scale, bool lo_side) {
    const float q = (b - org) / scale;
    const float r = lo_side ? floorf(q) - 1.0f : ceilf(q) + 1.0f;
    return (unsigned)fminf(fmaxf(r, 0.0f), 255.0f);
}

template <int W>
__global__ void pack_nodes_kernel(const unsigned char* __restrict__ surv,
                                  const int* __restrict__ ch_old,
                                  const int* __restrict__ arity, const int* __restrict__ base,
                                  const int* __restrict__ newid,
                                  const int* __restrict__ surv_idx, int n_rows,
                                  const float* __restrict__ bmin,
                                  const float* __restrict__ bmax, int root_offset,
                                  int pool_rows, unsigned* __restrict__ nodes,
                                  unsigned* __restrict__ fused, int fused_words) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= n_rows) return;
    const int i = surv_idx ? surv_idx[r] : r;
    if (i < 0 || !surv[i]) return;
    const int sid = newid[i];
    if (sid < 0 || sid >= pool_rows) return;
    const Layout L = layout(W);
    int ch[W];
    float org[3] = {INFINITY, INFINITY, INFINITY};
    float top[3] = {-INFINITY, -INFINITY, -INFINITY};
#pragma unroll
    for (int c = 0; c < W; ++c) {
        ch[c] = ch_old[(long long)i * W + c];
        if (ch[c] < 0) continue;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            org[k] = fminf(org[k], bmin[3LL * ch[c] + k]);
            top[k] = fmaxf(top[k], bmax[3LL * ch[c] + k]);
        }
    }
    unsigned rec[kRowWords];
#pragma unroll
    for (int w = 0; w < kRowWords; ++w) rec[w] = 0u;
    float scale[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float x = fmaxf(top[k] - org[k], 1e-30f) / 255.0f;
        const unsigned bits = __float_as_uint(x);
        int e = (int)((bits >> 23) & 255u) - 127 + ((bits & 0x7FFFFFu) != 0u ? 1 : 0);
        e = min(max(e, -126), 127);
        scale[k] = __uint_as_float((unsigned)(e + 127) << 23);
        rec[k] = __float_as_uint(org[k]);
        rec[3 + k] = __float_as_uint(scale[k]);
    }
#pragma unroll
    for (int c = 0; c < W; ++c) {
        if (ch[c] < 0) continue;
        unsigned lo = 0u, hi = 0u;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            lo |= qbyte(bmin[3LL * ch[c] + k], org[k], scale[k], true) << (8 * k);
            hi |= qbyte(bmax[3LL * ch[c] + k], org[k], scale[k], false) << (8 * k);
        }
        rec[L.qlo + c] = lo;
        rec[L.qhi + c] = hi;
    }
    rec[L.meta] = (unsigned)(base[i] + root_offset) | ((unsigned)arity[i] << L.left_bits) |
                  (kKindInternal << 29);
    uint4* dst = (uint4*)(nodes + (long long)(sid + root_offset) * kRowWords);
#pragma unroll
    for (int w = 0; w < kRowWords / 4; ++w)
        dst[w] = make_uint4(rec[4 * w], rec[4 * w + 1], rec[4 * w + 2], rec[4 * w + 3]);
    if (fused) {
        uint4* f = (uint4*)(fused + (long long)sid * fused_words);
#pragma unroll
        for (int w = 0; w < kRowWords / 4; ++w)
            f[w] = make_uint4(rec[4 * w], rec[4 * w + 1], rec[4 * w + 2], rec[4 * w + 3]);
    }
}

__global__ void pack_leaves_kernel(const int* __restrict__ order,
                                   const int* __restrict__ row_lo,
                                   const int* __restrict__ row_cnt,
                                   const int* __restrict__ leaf_tids,
                                   const int* __restrict__ leaf_newid,
                                   const float* __restrict__ v0, const float* __restrict__ v1,
                                   const float* __restrict__ v2, int t, int width,
                                   int leaf_size, int root_offset, int pool_rows,
                                   int leaf_rows, unsigned* __restrict__ nodes,
                                   unsigned* __restrict__ tri_rows,
                                   unsigned* __restrict__ fused, int fused_words) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= leaf_rows) return;
    const Layout L = layout(width);
    const int first = row_lo[j], cnt = row_cnt[j], lid = leaf_newid[j];
    const bool used = lid >= 0 && lid < pool_rows;
    uint4* row = (uint4*)(tri_rows + (long long)j * 16 * leaf_size);
    uint4* frow = (fused && used)
                      ? (uint4*)(fused + (long long)lid * fused_words + kRowWords)
                      : nullptr;
    for (int c = 0; c < leaf_size; ++c) {
        const int slot = leaf_tids ? leaf_tids[(long long)j * leaf_size + c] : first + c;
        const long long tid = order[min(max(slot, 0), t - 1)];
        const bool valid = c < cnt;
        float w[9];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            const float a = v0[3 * tid + k];
            w[k] = valid ? a : 0.0f;
            w[3 + k] = valid ? v1[3 * tid + k] - a : 0.0f;
            w[6 + k] = valid ? v2[3 * tid + k] - a : 0.0f;
        }
        const uint4 q0 = make_uint4(__float_as_uint(w[0]), __float_as_uint(w[1]),
                                    __float_as_uint(w[2]), __float_as_uint(w[3]));
        const uint4 q1 = make_uint4(__float_as_uint(w[4]), __float_as_uint(w[5]),
                                    __float_as_uint(w[6]), __float_as_uint(w[7]));
        const uint4 q2 = make_uint4(__float_as_uint(w[8]), valid ? (unsigned)tid : 0xFFFFFFFFu,
                                    0u, 0u);
        const uint4 q3 = make_uint4(0u, 0u, 0u, 0u);
        row[4 * c] = q0;
        row[4 * c + 1] = q1;
        row[4 * c + 2] = q2;
        row[4 * c + 3] = q3;
        if (frow) {
            frow[4 * c] = q0;
            frow[4 * c + 1] = q1;
            frow[4 * c + 2] = q2;
            frow[4 * c + 3] = q3;
        }
    }
    if (!used) return;
    // the leaf record: every word zero (the caller's fill) but these two
    const unsigned meta = (unsigned)j | (1u << L.left_bits) | (kKindTris << 29);
    unsigned* rec = nodes + (long long)(lid + root_offset) * kRowWords;
    rec[L.meta] = meta;
    rec[L.leaf] = (unsigned)cnt;
    if (fused) {
        unsigned* f = fused + (long long)lid * fused_words;
        f[L.meta] = meta;
        f[L.leaf] = (unsigned)cnt;
    }
}

inline int blocks(long long n) { return (int)((n + kBlock - 1) / kBlock); }

}  // namespace

extern "C" const char* vrt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// pack_nodes_kernel then pack_leaves_kernel on `stream`.
// Topology (int32; surv bytes 0/1): surv, arity, base (l-1,), ch_old
// (l-1, width), newid (2l-1,), order, row_lo, row_cnt, leaf_newid (l,);
// leaf_tids (l, leaf_size) sorted slots of each leaf row (-1 padded), or
// null for the Morton ranges row_lo..;
// surv_idx (n_surv,) the survivors' ids, -1 padded, or null for all l-1
// internals (then n_surv = l-1).  Boxes bmin, bmax (2l-1, 3) float32;
// vertices v0, v1, v2 (l, 3) float32.  Outputs, 16-byte aligned: nodes
// (root_offset + pool_rows, 32) zero-filled (row 0 is the caller's when
// root_offset = 1), tri_rows (leaf_rows, 16 * leaf_size), and fused
// (pool_rows, 32 + 16 * leaf_size) zero-filled, or null.  Records whose
// new id lies outside [0, pool_rows) are dropped.  Returns
// cudaGetLastError() (0 = ok).
extern "C" int vrt_lbvh_pack_rows(const void* surv, const void* ch_old, const void* arity,
                                  const void* base, const void* newid, const void* surv_idx,
                                  int n_surv, const void* bmin, const void* bmax,
                                  const void* order, const void* row_lo, const void* row_cnt,
                                  const void* leaf_tids, const void* leaf_newid,
                                  const void* v0, const void* v1,
                                  const void* v2, int l, int width, int leaf_size,
                                  int root_offset, int pool_rows, int leaf_rows, void* nodes,
                                  void* tri_rows, void* fused, void* stream) {
    if (l < 2 || (width != 4 && width != 8) || leaf_size < 1 || n_surv < 0 ||
        (root_offset != 0 && root_offset != 1) || pool_rows < 1 || leaf_rows < 1 ||
        leaf_rows > l || (fused && root_offset) || ((uintptr_t)nodes & 15) ||
        ((uintptr_t)tri_rows & 15) || ((uintptr_t)fused & 15)) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = (cudaStream_t)stream;
    const int fw = kRowWords + 16 * leaf_size;
    if (n_surv > 0) {
        if (width == 4) {
            pack_nodes_kernel<4><<<blocks(n_surv), kBlock, 0, s>>>(
                (const unsigned char*)surv, (const int*)ch_old, (const int*)arity,
                (const int*)base, (const int*)newid, (const int*)surv_idx, n_surv,
                (const float*)bmin, (const float*)bmax, root_offset, pool_rows,
                (unsigned*)nodes, (unsigned*)fused, fw);
        } else {
            pack_nodes_kernel<8><<<blocks(n_surv), kBlock, 0, s>>>(
                (const unsigned char*)surv, (const int*)ch_old, (const int*)arity,
                (const int*)base, (const int*)newid, (const int*)surv_idx, n_surv,
                (const float*)bmin, (const float*)bmax, root_offset, pool_rows,
                (unsigned*)nodes, (unsigned*)fused, fw);
        }
    }
    pack_leaves_kernel<<<blocks(leaf_rows), kBlock, 0, s>>>(
        (const int*)order, (const int*)row_lo, (const int*)row_cnt, (const int*)leaf_tids,
        (const int*)leaf_newid,
        (const float*)v0, (const float*)v1, (const float*)v2, l, width, leaf_size, root_offset,
        pool_rows, leaf_rows, (unsigned*)nodes, (unsigned*)tri_rows, (unsigned*)fused, fw);
    return (int)cudaGetLastError();
}
