// lbvh_pack.cu — quantize the wide nodes and pack the traversal tables:
// the second half of the per-frame refit (kernel D of K5), and the PLOC
// build's and refit's pack (K4d).
//
// Replaces `_pack_wide` and `_leaf_rows` of vortex_rt_tpu/accel/lbvh.py
// (:466, :578) and, when asked, `WideArrays.fuse` behind them
// (ops/traverse_wide.py): XLA builds whole record columns and scatters
// them; here a group of lanes builds one record or one triangle row and
// stores it as consecutive 16-byte words, so a warp's store instruction
// writes whole 128-byte lines.
//
// pack_nodes_kernel: eight lanes per survivor (of the compact survivor
//   list when given, else of all internals), lane c for child slot c.
//   Each lane gathers its child's box from the binary box arrays; the
//   group takes the join [org, top] with shuffles; the scale 2^e with
//   e = clip(ceil(log2(extent / 255)), -126, 127) is read exactly from the
//   bits of extent / 255 (the exponent field, plus one when a mantissa bit
//   is set: no log2); each lane quantizes its own child box to bytes —
//   floor - 1 below, ceil + 1 above, clipped to [0, 255], so every box
//   grows by one step.  Lane c then stores words 4c..4c+3 of the 32-word
//   record at its new id (org, scale, the lo and hi words, taken from
//   their lanes with shuffles, and the meta word left | arity << 26
//   (width 4) or 25 (width 8) | kind << 29), and the same in the fused
//   row, whose triangle part it zeroes.  The same launch zeroes the pool
//   rows no record reaches: the collapse gives the records the new ids
//   0 .. n_used - 1, n_used = 1 + the sum of the survivors' arities
//   (base and arity of the last internal), so the rows from n_used to
//   pool_rows (the compact plan's padding, the unused tail of a full
//   2T-1 pool) are zero.
// pack_leaves_kernel: four lanes per triangle slot of a leaf row, one
//   16-byte word each: (v0, e1.x), (e1.yz, e2.xy), (e2.z, global triangle
//   id, 0, 0), 0; empty slots are zero with id -1.  Slot c of row j is the
//   sorted triangle row_lo[j] + c (a Morton range, K5), or, when
//   `leaf_tids` is given, leaf_tids[j][c]: the explicit triangle sets of
//   a PLOC tree (kernel K4d; replaces `_rows_from_tids` of
//   vortex_rt_tpu/accel/ploc.py:335).  The row's lanes also store its leaf
//   record (every word zero but the meta and count words) and the fused
//   row (the record, then the triangle row).
// Every word of every output row is written once; the caller allocates
// them unfilled (row 0 of a TLAS layout is the caller's).
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

__device__ __forceinline__ void zero_rows(unsigned* rows, long long first, long long end,
                                          int row_words, long long gt, long long stride) {
    const long long n = (end - first) * (row_words / 4);
    uint4* dst = (uint4*)(rows + first * row_words);
    for (long long u = gt; u < n; u += stride) dst[u] = make_uint4(0u, 0u, 0u, 0u);
}

template <int W>
__global__ void pack_nodes_kernel(const unsigned char* __restrict__ surv,
                                  const int* __restrict__ ch_old,
                                  const int* __restrict__ arity, const int* __restrict__ base,
                                  const int* __restrict__ newid,
                                  const int* __restrict__ surv_idx, int n_rows,
                                  const float* __restrict__ bmin,
                                  const float* __restrict__ bmax, int l, int root_offset,
                                  int pool_rows, int leaf_size, unsigned* __restrict__ nodes,
                                  unsigned* __restrict__ fused, int fused_words) {
    const long long gt = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long g = gt >> 3;                // the group's survivor row
    const int c = threadIdx.x & 7;              // this lane's child slot
    const int src = (threadIdx.x & 31) & ~7;    // the group's first lane
    const Layout L = layout(W);

    int i = -1, sid = -1;
    if (g < n_rows) {
        i = surv_idx ? surv_idx[g] : (int)g;
        if (i >= 0 && surv[i]) sid = newid[i];
    }
    const bool active = i >= 0 && sid >= 0 && sid < pool_rows;
    const int ch = active && c < W ? ch_old[(long long)i * W + c] : -1;
    float bmn[3], bmx[3], org[3], top[3], scale[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        bmn[k] = ch >= 0 ? bmin[3LL * ch + k] : INFINITY;
        bmx[k] = ch >= 0 ? bmax[3LL * ch + k] : -INFINITY;
        org[k] = bmn[k];
        top[k] = bmx[k];
    }
    // the join over the group's children (min and max: exact in any order)
#pragma unroll
    for (int d = 1; d < 8; d <<= 1) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            org[k] = fminf(org[k], __shfl_xor_sync(0xffffffffu, org[k], d));
            top[k] = fmaxf(top[k], __shfl_xor_sync(0xffffffffu, top[k], d));
        }
    }
    unsigned lo = 0u, hi = 0u;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float x = fmaxf(top[k] - org[k], 1e-30f) / 255.0f;
        const unsigned bits = __float_as_uint(x);
        int e = (int)((bits >> 23) & 255u) - 127 + ((bits & 0x7FFFFFu) != 0u ? 1 : 0);
        e = min(max(e, -126), 127);
        scale[k] = __uint_as_float((unsigned)(e + 127) << 23);
        if (ch >= 0) {
            lo |= qbyte(bmn[k], org[k], scale[k], true) << (8 * k);
            hi |= qbyte(bmx[k], org[k], scale[k], false) << (8 * k);
        }
    }
    const unsigned meta = active ? (unsigned)(base[i] + root_offset) |
                                       ((unsigned)arity[i] << L.left_bits) | (kKindInternal << 29)
                                 : 0u;
    unsigned q[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
        const int w = 4 * c + t;
        const unsigned vlo = __shfl_sync(0xffffffffu, lo, src + min(max(w - L.qlo, 0), 7));
        const unsigned vhi = __shfl_sync(0xffffffffu, hi, src + min(max(w - L.qhi, 0), 7));
        unsigned v = 0u;
        if (w < 3) v = __float_as_uint(org[w]);
        else if (w < 6) v = __float_as_uint(scale[w - 3]);
        else if (w < L.qlo + W) v = vlo;
        else if (w < L.qhi + W) v = vhi;
        else if (w == L.meta) v = meta;
        q[t] = v;
    }
    if (active) {
        const uint4 word = make_uint4(q[0], q[1], q[2], q[3]);
        ((uint4*)(nodes + (long long)(sid + root_offset) * kRowWords))[c] = word;
        if (fused) {
            uint4* f = (uint4*)(fused + (long long)sid * fused_words);
            f[c] = word;
            for (int u = kRowWords / 4 + c; u < fused_words / 4; u += 8)
                f[u] = make_uint4(0u, 0u, 0u, 0u);
        }
    }
    // the rows no record reaches
    const long long n_used = (long long)base[l - 2] + (surv[l - 2] ? arity[l - 2] : 0);
    if (n_used < pool_rows) {
        zero_rows(nodes, root_offset + n_used, root_offset + (long long)pool_rows, kRowWords, gt,
                  stride);
        if (fused) zero_rows(fused, n_used, pool_rows, fused_words, gt, stride);
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
    const int lanes = 4 * leaf_size;  // 16-byte words of a triangle row
    const long long gt = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long j = gt / lanes;
    if (j >= leaf_rows) return;
    const int k = (int)(gt % lanes), c = k >> 2, part = k & 3;
    const int cnt = row_cnt[j], lid = leaf_newid[j];
    const bool used = lid >= 0 && lid < pool_rows;
    const bool valid = c < cnt;
    uint4 word = make_uint4(0u, 0u, 0u, 0u);
    if (part < 3) {
        const int slot = leaf_tids ? leaf_tids[j * leaf_size + c] : row_lo[j] + c;
        const long long tid = order[min(max(slot, 0), t - 1)];
        float w[9];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            const float x = v0[3 * tid + a];
            w[a] = valid ? x : 0.0f;
            w[3 + a] = valid ? v1[3 * tid + a] - x : 0.0f;
            w[6 + a] = valid ? v2[3 * tid + a] - x : 0.0f;
        }
        if (part == 0) {
            word = make_uint4(__float_as_uint(w[0]), __float_as_uint(w[1]), __float_as_uint(w[2]),
                              __float_as_uint(w[3]));
        } else if (part == 1) {
            word = make_uint4(__float_as_uint(w[4]), __float_as_uint(w[5]), __float_as_uint(w[6]),
                              __float_as_uint(w[7]));
        } else {
            word = make_uint4(__float_as_uint(w[8]), valid ? (unsigned)tid : 0xFFFFFFFFu, 0u, 0u);
        }
    }
    ((uint4*)(tri_rows + j * lanes * 4))[k] = word;
    if (!used) return;
    uint4* f = fused ? (uint4*)(fused + (long long)lid * fused_words) : nullptr;
    if (f) f[kRowWords / 4 + k] = word;
    // the leaf record: every word zero but the meta and count words
    const Layout L = layout(width);
    const unsigned meta = (unsigned)j | (1u << L.left_bits) | (kKindTris << 29);
    uint4* rec = (uint4*)(nodes + (long long)(lid + root_offset) * kRowWords);
    for (int u = k; u < kRowWords / 4; u += lanes) {
        unsigned r[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
            const int wi = 4 * u + a;
            r[a] = wi == L.meta ? meta : wi == L.leaf ? (unsigned)cnt : 0u;
        }
        const uint4 rw = make_uint4(r[0], r[1], r[2], r[3]);
        rec[u] = rw;
        if (f) f[u] = rw;
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
// vertices v0, v1, v2 (l, 3) float32.  Outputs, 16-byte aligned, every
// word written here: nodes (root_offset + pool_rows, 32) (row 0 is the
// caller's when root_offset = 1), tri_rows (leaf_rows, 16 * leaf_size),
// and fused (pool_rows, 32 + 16 * leaf_size), or null.  The topology's
// new ids must be dense, as the collapse gives them: records at 0 ..
// n_used - 1, and the leaf rows of the used ones below leaf_rows.
// Records whose new id lies outside [0, pool_rows) are dropped.  Returns
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
    // eight lanes a survivor row; at least one block for the zero rows
    const int nb = blocks(8LL * (n_surv > 0 ? n_surv : 1));
    if (width == 4) {
        pack_nodes_kernel<4><<<nb, kBlock, 0, s>>>(
            (const unsigned char*)surv, (const int*)ch_old, (const int*)arity, (const int*)base,
            (const int*)newid, (const int*)surv_idx, n_surv, (const float*)bmin,
            (const float*)bmax, l, root_offset, pool_rows, leaf_size, (unsigned*)nodes,
            (unsigned*)fused, fw);
    } else {
        pack_nodes_kernel<8><<<nb, kBlock, 0, s>>>(
            (const unsigned char*)surv, (const int*)ch_old, (const int*)arity, (const int*)base,
            (const int*)newid, (const int*)surv_idx, n_surv, (const float*)bmin,
            (const float*)bmax, l, root_offset, pool_rows, leaf_size, (unsigned*)nodes,
            (unsigned*)fused, fw);
    }
    pack_leaves_kernel<<<blocks(4LL * leaf_size * leaf_rows), kBlock, 0, s>>>(
        (const int*)order, (const int*)row_lo, (const int*)row_cnt, (const int*)leaf_tids,
        (const int*)leaf_newid,
        (const float*)v0, (const float*)v1, (const float*)v2, l, width, leaf_size, root_offset,
        pool_rows, leaf_rows, (unsigned*)nodes, (unsigned*)tri_rows, (unsigned*)fused, fw);
    return (int)cudaGetLastError();
}
