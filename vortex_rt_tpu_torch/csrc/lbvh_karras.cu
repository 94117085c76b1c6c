// lbvh_karras.cu — Morton codes and the Karras 2012 binary radix tree of
// the on-device LBVH build (kernel A of K5).
//
// Replaces `morton3d` and `_karras` of vortex_rt_tpu/accel/lbvh.py (:68,
// :112), which XLA runs as whole-array steps: 95 unrolled search steps
// over every node at once.  Here each thread owns one triangle (codes) or
// one internal node (tree) and runs the searches as real loops that end
// when they are done.
//
// morton_kernel: thread t computes the centroid of triangle t, normalizes
// it over the scene box and interleaves three 10-bit coordinates into a
// 30-bit code.  Same float operations in the same order as the plain
// version ((v0 + v1) + v2) / 3, (c - smin) / ext, c * 1024; the build has
// no a*b+c contraction), so the codes are equal.
//
// karras_kernel: thread i finds the range and the split of internal node
// i over the sorted codes: the direction from the two neighbours, the
// range end by doubling then bisection, the split by bisection.  The
// common-prefix length of equal codes is taken over the indices instead
// (32 + clz(i ^ j)), so keys are unique.  Returns lchild, rchild (old ids:
// internal k in [0, l-1), leaf j at (l-1)+j) and the inclusive leaf range
// lo, hi.
//
// What bounds them: bytes.  morton reads 36 B and writes 4 B a triangle;
// karras reads neighbouring codes (cached) and writes 16 B a node, about
// 2 log2(range) dependent cached loads deep.
//
// Built by vortex_rt_tpu_torch/runtime/kernels.py with nvcc into a shared
// library with a plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

__device__ __forceinline__ unsigned expand_bits(unsigned v) {
    v = (v * 0x00010001u) & 0xFF0000FFu;
    v = (v * 0x00000101u) & 0x0F00F00Fu;
    v = (v * 0x00000011u) & 0xC30C30C3u;
    v = (v * 0x00000005u) & 0x49249249u;
    return v;
}

__global__ void morton_kernel(const float* __restrict__ v0, const float* __restrict__ v1,
                              const float* __restrict__ v2, const float* __restrict__ smin,
                              const float* __restrict__ smax, int t, int* __restrict__ codes) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= t) return;
    unsigned q[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float cen = ((v0[3 * i + k] + v1[3 * i + k]) + v2[3 * i + k]) / 3.0f;
        const float ext = fmaxf(smax[k] - smin[k], 1e-30f);
        const float n = (cen - smin[k]) / ext;
        q[k] = (unsigned)fminf(fmaxf(n * 1024.0f, 0.0f), 1023.0f);
    }
    codes[i] = (int)(expand_bits(q[0]) * 4u + expand_bits(q[1]) * 2u + expand_bits(q[2]));
}

// common-prefix length of the keys (code, index) at i and j; -1 outside
__device__ __forceinline__ int delta(const unsigned* __restrict__ codes, int l, int i,
                                     unsigned ci, int j) {
    if (j < 0 || j >= l) return -1;
    const unsigned x = ci ^ codes[j];
    return x == 0u ? 32 + __clz(i ^ j) : __clz((int)x);
}

__global__ void karras_kernel(const unsigned* __restrict__ codes, int l,
                              int* __restrict__ lchild, int* __restrict__ rchild,
                              int* __restrict__ lo_out, int* __restrict__ hi_out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= l - 1) return;
    const unsigned ci = codes[i];
    const int d = delta(codes, l, i, ci, i + 1) >= delta(codes, l, i, ci, i - 1) ? 1 : -1;
    const int delta_min = delta(codes, l, i, ci, i - d);
    // the range's other end: double the reach while the prefix holds, then
    // bisect.  long long: i + lmax * d may leave int32 for l near 2^30
    long long lmax = 2;
    while (delta(codes, l, i, ci, (int)max(min((long long)i + lmax * d, (long long)l), -1LL)) >
           delta_min)
        lmax *= 2;
    int ln = 0;
    for (long long step = lmax / 2; step > 0; step /= 2) {
        const long long j = (long long)i + ((long long)ln + step) * d;
        if (j >= 0 && j < l && delta(codes, l, i, ci, (int)j) > delta_min) ln += (int)step;
    }
    const int j_end = i + ln * d;
    // the split: the last position that shares more than the node's prefix
    const int delta_node = delta(codes, l, i, ci, j_end);
    int s = 0;
    int step = ln;
    do {
        step = (step + 1) / 2;
        const int cand = s + step;
        if (cand < ln && delta(codes, l, i, ci, i + cand * d) > delta_node) s = cand;
    } while (step > 1);
    const int gamma = i + s * d + min(d, 0);
    const int lo = min(i, j_end), hi = max(i, j_end);
    lchild[i] = lo == gamma ? (l - 1) + gamma : gamma;
    rchild[i] = hi == gamma + 1 ? (l - 1) + gamma + 1 : gamma + 1;
    lo_out[i] = lo;
    hi_out[i] = hi;
}

inline int blocks(long long n) { return (int)((n + kBlock - 1) / kBlock); }

}  // namespace

extern "C" const char* vrt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// codes[i] = 30-bit Morton code of triangle i's centroid over the box
// [smin, smax] (device pointers to 3 floats each).  v0, v1, v2 are (t, 3)
// float32, codes (t,) int32.  Returns cudaGetLastError() (0 = ok).
extern "C" int vrt_lbvh_morton(const void* v0, const void* v1, const void* v2,
                               const void* smin, const void* smax, int t, void* codes,
                               void* stream) {
    if (t <= 0) return (int)cudaErrorInvalidValue;
    morton_kernel<<<blocks(t), kBlock, 0, (cudaStream_t)stream>>>(
        (const float*)v0, (const float*)v1, (const float*)v2, (const float*)smin,
        (const float*)smax, t, (int*)codes);
    return (int)cudaGetLastError();
}

// The radix tree over l sorted codes ((l,) int32, each below 2^30):
// lchild, rchild, lo, hi are (l-1,) int32.  Returns cudaGetLastError().
extern "C" int vrt_lbvh_karras(const void* codes, int l, void* lchild, void* rchild,
                               void* lo, void* hi, void* stream) {
    if (l < 2) return (int)cudaErrorInvalidValue;
    karras_kernel<<<blocks(l - 1), kBlock, 0, (cudaStream_t)stream>>>(
        (const unsigned*)codes, l, (int*)lchild, (int*)rchild, (int*)lo, (int*)hi);
    return (int)cudaGetLastError();
}
