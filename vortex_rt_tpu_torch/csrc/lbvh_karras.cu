// lbvh_karras.cu — the scene box, the Morton codes and the Karras 2012
// binary radix tree of the on-device LBVH build (kernel A of K5).
//
// Replaces the scene box, `morton3d` and `_karras` of
// vortex_rt_tpu/accel/lbvh.py (:68, :112), which XLA runs as whole-array
// steps: two reductions, then 95 unrolled search steps over every node at
// once.
//
// What bounds it: bytes (36 B of vertices in and 4 B of code out a
// triangle; 4 B of sorted code in and 16 B of tree out a node), but the
// searches are chains of dependent loads, about 3 log2(range) deep, and
// the scene box is a reduction across the whole grid.  So:
//
// box_morton_kernel: one cooperative, persistent launch (a grid sized by
//   the occupancy calculator, grid-stride loops).  Phase 1: each thread
//   reads its triangles once, folds their vertices into its part of the
//   box and keeps their centroids in registers (((v0 + v1) + v2) / 3, the
//   JAX order; past kKeep triangles a thread it reads them again in phase
//   2); each block writes its part of the box.  grid.sync().  Phase 2:
//   every block folds all the parts (no block reduces for the others, so
//   no second barrier) and interleaves three 10-bit coordinates of
//   (cen - smin) / ext into a 30-bit code; block 0 writes the box.  min
//   and max are exact in any order; a zero of either sign comes out as
//   +0 (x + 0.0f), as the plain version gives it, and the codes do not
//   depend on the sign of a zero.  The build has no a*b+c contraction, so
//   the codes equal the plain version's.
// karras_kernel: thread i finds the range and the split of internal node
//   i over the sorted codes: the direction from the two neighbours, the
//   range end by doubling then bisection, the split by bisection.  The
//   block first stages its 256 codes and kHalo more on each side in
//   shared memory; a probe inside that window reads shared memory, one
//   outside it the code array.  Most internals of a radix tree span a few
//   leaves, so nearly every probe of the dependent chains stays in shared
//   memory.  The common-prefix length of equal codes is taken over the
//   indices instead (32 + clz(i ^ j)), so keys are unique.  Returns
//   lchild, rchild (old ids: internal k in [0, l-1), leaf j at (l-1)+j)
//   and the inclusive leaf range lo, hi.
//
// Built by vortex_rt_tpu_torch/runtime/kernels.py with nvcc into a shared
// library with a plain C interface, loaded with ctypes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBlock = 256;
constexpr int kKeep = 8;    // centroids a thread keeps between the phases
constexpr int kHalo = 512;  // codes staged on each side of a block's own

__device__ __forceinline__ unsigned expand_bits(unsigned v) {
    v = (v * 0x00010001u) & 0xFF0000FFu;
    v = (v * 0x00000101u) & 0x0F00F00Fu;
    v = (v * 0x00000011u) & 0xC30C30C3u;
    v = (v * 0x00000005u) & 0x49249249u;
    return v;
}

// the 30-bit code of centroid c over the box (smin, ext)
__device__ __forceinline__ int morton(const float* c, const float* smin, const float* ext) {
    unsigned q[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float n = (c[k] - smin[k]) / ext[k];
        q[k] = (unsigned)fminf(fmaxf(n * 1024.0f, 0.0f), 1023.0f);
    }
    return (int)(expand_bits(q[0]) * 4u + expand_bits(q[1]) * 2u + expand_bits(q[2]));
}

// triangle i's vertices folded into (mn, mx), its centroid into cen
__device__ __forceinline__ void load_tri(const float* __restrict__ v0,
                                         const float* __restrict__ v1,
                                         const float* __restrict__ v2, int i, float* mn,
                                         float* mx, float* cen) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float a = v0[3 * i + k], b = v1[3 * i + k], d = v2[3 * i + k];
        mn[k] = fminf(mn[k], fminf(fminf(a, b), d));
        mx[k] = fmaxf(mx[k], fmaxf(fmaxf(a, b), d));
        cen[k] = ((a + b) + d) / 3.0f;
    }
}

// the block's min of mn and max of mx, in every thread
__device__ __forceinline__ void block_box(float* mn, float* mx, float (*s_red)[kBlock / 32]) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            mn[k] = fminf(mn[k], __shfl_xor_sync(0xffffffffu, mn[k], o));
            mx[k] = fmaxf(mx[k], __shfl_xor_sync(0xffffffffu, mx[k], o));
        }
    __syncthreads();  // s_red's previous readers are done
    if (lane == 0)
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            s_red[k][w] = mn[k];
            s_red[3 + k][w] = mx[k];
        }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int j = 0; j < kBlock / 32; ++j) {
            mn[k] = fminf(mn[k], s_red[k][j]);
            mx[k] = fmaxf(mx[k], s_red[3 + k][j]);
        }
}

__global__ void __launch_bounds__(kBlock, 4) box_morton_kernel(const float* __restrict__ v0,
                                                            const float* __restrict__ v1,
                                                            const float* __restrict__ v2,
                                                            int t, float* __restrict__ part,
                                                            float* __restrict__ box,
                                                            int* __restrict__ codes) {
    cg::grid_group grid = cg::this_grid();
    __shared__ float s_red[6][kBlock / 32];
    // (t < 2^26: positions and 3 t fit an int)
    const int gtid = blockIdx.x * kBlock + threadIdx.x, stride = gridDim.x * kBlock;
    float mn[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
    float mx[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};

    // 1. the triangles: the box's parts, and the centroids kept
    float cen[kKeep][3];
#pragma unroll
    for (int k = 0; k < kKeep; ++k)
        if (gtid + k * stride < t) load_tri(v0, v1, v2, gtid + k * stride, mn, mx, cen[k]);
    for (int i = gtid + kKeep * stride; i < t; i += stride) {
        float c[3];
        load_tri(v0, v1, v2, i, mn, mx, c);
    }
    block_box(mn, mx, s_red);
    if (threadIdx.x == 0)
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            part[6LL * blockIdx.x + k] = mn[k];
            part[6LL * blockIdx.x + 3 + k] = mx[k];
        }
    grid.sync();

    // 2. the box from every block's part (written in this launch: read
    // through L2), then the codes
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        mn[k] = CUDART_INF_F;
        mx[k] = -CUDART_INF_F;
    }
    for (int b = threadIdx.x; b < gridDim.x; b += kBlock)
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            mn[k] = fminf(mn[k], __ldcg(part + 6LL * b + k));
            mx[k] = fmaxf(mx[k], __ldcg(part + 6LL * b + 3 + k));
        }
    block_box(mn, mx, s_red);
    float ext[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        mn[k] = mn[k] + 0.0f;  // -0 -> +0
        mx[k] = mx[k] + 0.0f;
        ext[k] = fmaxf(mx[k] - mn[k], 1e-30f);
    }
    if (blockIdx.x == 0 && threadIdx.x == 0)
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            box[k] = mn[k];
            box[3 + k] = mx[k];
        }
#pragma unroll
    for (int k = 0; k < kKeep; ++k)
        if (gtid + k * stride < t) codes[gtid + k * stride] = morton(cen[k], mn, ext);
    for (int i = gtid + kKeep * stride; i < t; i += stride) {
        float unused_mn[3] = {0.0f, 0.0f, 0.0f}, unused_mx[3] = {0.0f, 0.0f, 0.0f}, c[3];
        load_tri(v0, v1, v2, i, unused_mn, unused_mx, c);
        codes[i] = morton(c, mn, ext);
    }
}

// common-prefix length of the keys (code, index) at i and j; -1 outside.
// Positions in [base, base + kBlock + 2 kHalo) read the block's staged
// codes, the rest the code array
struct Codes {
    const unsigned* g;
    const unsigned* s;
    int base, l;

    __device__ __forceinline__ int delta(int i, unsigned ci, int j) const {
        if (j < 0 || j >= l) return -1;
        const unsigned k = (unsigned)(j - base);
        const unsigned cj = k < (unsigned)(kBlock + 2 * kHalo) ? s[k] : __ldg(g + j);
        // (code, index) as one 64-bit key: equal codes give 32 + clz(i ^ j)
        return __clzll((long long)((unsigned long long)(ci ^ cj) << 32 | (unsigned)(i ^ j)));
    }
};

// I: the type of the reach arithmetic, int below 2^29 leaves (i + lmax d
// then fits), long long above
template <typename I>
__global__ void __launch_bounds__(kBlock) karras_kernel(const unsigned* __restrict__ codes, int l,
                                                        int* __restrict__ lchild,
                                                        int* __restrict__ rchild,
                                                        int* __restrict__ lo_out,
                                                        int* __restrict__ hi_out) {
    __shared__ unsigned s_code[kBlock + 2 * kHalo];
    const int base = blockIdx.x * kBlock - kHalo;
    for (int k = threadIdx.x; k < kBlock + 2 * kHalo; k += kBlock) {
        const int j = base + k;
        if (j >= 0 && j < l) s_code[k] = codes[j];
    }
    __syncthreads();
    const int i = blockIdx.x * kBlock + threadIdx.x;
    if (i >= l - 1) return;
    const Codes c{codes, s_code, base, l};
    const unsigned ci = s_code[i - base];
    const int d = c.delta(i, ci, i + 1) >= c.delta(i, ci, i - 1) ? 1 : -1;
    const int delta_min = c.delta(i, ci, i - d);
    // the range's other end: double the reach while the prefix holds, then
    // bisect.  long long above 2^29 leaves: i + lmax * d may leave int32.
    // (The plain version clamps the reach at 2^28; below 2^26 leaves the
    // doubling stops first, at a reach past the array's end.)
    I lmax = 2;
    while (c.delta(i, ci, (int)max(min((I)i + lmax * d, (I)l), (I)-1)) > delta_min) lmax *= 2;
    int ln = 0;
    for (I step = lmax / 2; step > 0; step /= 2) {
        const I j = (I)i + ((I)ln + step) * d;
        if (j >= 0 && j < l && c.delta(i, ci, (int)j) > delta_min) ln += (int)step;
    }
    const int j_end = i + ln * d;
    // the split: the last position that shares more than the node's prefix
    const int delta_node = c.delta(i, ci, j_end);
    int s = 0;
    int step = ln;
    do {
        step = (step + 1) / 2;
        const int cand = s + step;
        if (cand < ln && c.delta(i, ci, i + cand * d) > delta_node) s = cand;
    } while (step > 1);
    const int gamma = i + s * d + min(d, 0);
    const int lo = min(i, j_end), hi = max(i, j_end);
    lchild[i] = lo == gamma ? (l - 1) + gamma : gamma;
    rchild[i] = hi == gamma + 1 ? (l - 1) + gamma + 1 : gamma + 1;
    lo_out[i] = lo;
    hi_out[i] = hi;
}

}  // namespace

extern "C" const char* vrt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// Most blocks of the box and code launch for t triangles: the size of its
// `part` scratch is 6 floats a block.
extern "C" int vrt_lbvh_box_blocks(int t) { return (t + kBlock - 1) / kBlock; }

// The scene box and the codes, one cooperative launch on `stream`.
// v0, v1, v2 are (t, 3) float32; out: box (2, 3) float32 (min, then max),
// codes (t,) int32, codes[i] the 30-bit Morton code of triangle i's
// centroid over the box; part is 6 * vrt_lbvh_box_blocks(t) floats of
// scratch.  A refused launch (the cooperative grid among them) returns
// its error.  Returns 0 on success.
extern "C" int vrt_lbvh_box_morton(const void* v0, const void* v1, const void* v2, int t,
                                   void* part, void* box, void* codes, void* stream) {
    if (t <= 0 || t > (1 << 29)) return (int)cudaErrorInvalidValue;  // (3 t fits an int)
    // the grid the card holds at once, by device (asked once)
    static int most_by_dev[64];
    cudaError_t err;
    int dev = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if (dev >= 64) return (int)cudaErrorInvalidDevice;
    if (most_by_dev[dev] == 0) {
        int sms = 0, coop = 0, per_sm = 0;
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
        if (!coop) return (int)cudaErrorNotSupported;
        if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, box_morton_kernel, kBlock,
                                                                 0)) != cudaSuccess)
            return (int)err;
        if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
        most_by_dev[dev] = per_sm * sms;
    }
    const int need = vrt_lbvh_box_blocks(t);
    const int blocks = need < most_by_dev[dev] ? need : most_by_dev[dev];
    const float* a = (const float*)v0;
    const float* b = (const float*)v1;
    const float* c = (const float*)v2;
    float* p = (float*)part;
    float* bx = (float*)box;
    int* out = (int*)codes;
    void* args[] = {&a, &b, &c, &t, &p, &bx, &out};
    return (int)cudaLaunchCooperativeKernel((void*)box_morton_kernel, blocks, kBlock, args, 0,
                                            (cudaStream_t)stream);
}

// The radix tree over l sorted codes ((l,) int32, each below 2^30):
// lchild, rchild, lo, hi are (l-1,) int32.  Returns cudaGetLastError().
extern "C" int vrt_lbvh_karras(const void* codes, int l, void* lchild, void* rchild,
                               void* lo, void* hi, void* stream) {
    if (l < 2) return (int)cudaErrorInvalidValue;
    const int blocks = (l - 1 + kBlock - 1) / kBlock;
    if (l < (1 << 29))
        karras_kernel<int><<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
            (const unsigned*)codes, l, (int*)lchild, (int*)rchild, (int*)lo, (int*)hi);
    else
        karras_kernel<long long><<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
            (const unsigned*)codes, l, (int*)lchild, (int*)rchild, (int*)lo, (int*)hi);
    return (int)cudaGetLastError();
}
