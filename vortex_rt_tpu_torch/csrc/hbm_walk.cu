// hbm_walk.cu — k interleaved chained row fetches: the card's
// dependent-fetch latency probe.
//
// Replaces the Pallas TPU kernel `_walk_kernel`, launched by `run_walks`
// (tools/exp_pallas_hbm.py:57 and :85).  Same result: k walks, walk j
// starting at row j * (n / k), each step copying every walk's current row
// and replacing the walk's index with word 0 of that row
// (idx <- tab[idx, 0]) for `steps` steps; the output is the int32 sum of
// the k final indices.
//
// Design.  The TPU kernel starts k row copies (HBM -> VMEM scratch, one
// DMA semaphore each), waits for all of them, and reads word 0 of each
// copy.  Here one warp does the same with cp.async (global -> shared
// memory, cached in L2 only, not in L1): lane l copies bytes
// [16 l, 16 l + 16) of each of the k rows, so a step moves `words` words
// (4..128, a multiple of 4) of every row — 512 B per row at the TPU tool's
// full row width.  cp.async.wait_all and a __syncwarp() stand for the
// semaphore waits: no lane reads a next index before every lane's copies
// of the step have landed, so each step costs the latency of fetching
// whole rows, not one word.  One block of one warp: the probe measures
// latency, not bandwidth, so nothing else shares the memory system's
// queue.  k is a template parameter (1, 4, 8, 16, 32) and the copy loop is
// unrolled over it, so the k copies of a step are issued back to back; the
// step loop itself is kept rolled so no copy of a later step is scheduled
// among them.
//
// What bounds it: exactly the latency it measures — one dependent row
// fetch per step, k of them overlapped.  ns/step/walk falls with k until
// the memory system's outstanding-request limit for one warp is reached.
//
// Built by vortex_rt_tpu_torch/runtime/kernels.py with nvcc into a shared
// library with a plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxVecs = 32;  // 16-byte vectors per row copy: 512 B

__device__ __forceinline__ void copy16(void* smem, const void* gmem) {
    unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(gmem) : "memory");
}

template <int K>
__global__ void hbm_walk_kernel(const int4* __restrict__ tab, long long row_vecs,
                                int n_rows, int vecs, int steps,
                                int* __restrict__ out) {
    __shared__ int4 rows[K][kMaxVecs];  // the TPU kernel's VMEM scratch
    const int lane = threadIdx.x;
    int idx[K];
#pragma unroll
    for (int j = 0; j < K; ++j) idx[j] = j * (n_rows / K);
    // not unrolled over t: unrolled, the compiler may issue a walk's next
    // copy right behind its last instead of the k copies of one step
    // together
#pragma unroll 1
    for (int t = 0; t < steps; ++t) {
        if (lane < vecs) {
#pragma unroll
            for (int j = 0; j < K; ++j)
                copy16(&rows[j][lane], tab + (long long)idx[j] * row_vecs + lane);
        }
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncwarp();  // every lane's part of every row has landed
#pragma unroll
        for (int j = 0; j < K; ++j) idx[j] = rows[j][0].x;
        __syncwarp();  // all lanes have read before the next step's copies
    }
    if (lane == 0) {
        // int32 sum with wrap-around, as the TPU kernel's i32 adds
        unsigned int acc = 0u;
#pragma unroll
        for (int j = 0; j < K; ++j) acc += (unsigned int)idx[j];
        out[0] = (int)acc;
    }
}

template <int K>
int launch(const int4* tab, long long row_vecs, int n_rows, int vecs, int steps,
           int* out, cudaStream_t stream) {
    hbm_walk_kernel<K><<<1, 32, 0, stream>>>(tab, row_vecs, n_rows, vecs, steps, out);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* vrt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// Launches the k-walk probe on `stream` and returns cudaGetLastError()
// (0 = ok).  `tab` is a 16-byte aligned device pointer to a contiguous
// (n_rows, row_words) int32 table whose word 0 of every row lies in
// [0, n_rows); row_words is a multiple of 4.  Each step copies the first
// `words` words of every walk's row (a multiple of 4, at most 128 and at
// most row_words).  `out` is a device int32.
extern "C" int vrt_hbm_walk(const void* tab, int n_rows, int row_words, int words,
                            int steps, int k, void* out, void* stream) {
    if (n_rows <= 0 || row_words <= 0 || row_words % 4 != 0 || words <= 0 ||
        words % 4 != 0 || words > row_words || words > 4 * kMaxVecs ||
        steps < 0 || k > n_rows || ((uintptr_t)tab & 15) != 0) {
        return (int)cudaErrorInvalidValue;
    }
    const int4* t = (const int4*)tab;
    const long long rv = row_words / 4;
    const int v = words / 4;
    int* o = (int*)out;
    cudaStream_t s = (cudaStream_t)stream;
    switch (k) {
        case 1: return launch<1>(t, rv, n_rows, v, steps, o, s);
        case 4: return launch<4>(t, rv, n_rows, v, steps, o, s);
        case 8: return launch<8>(t, rv, n_rows, v, steps, o, s);
        case 16: return launch<16>(t, rv, n_rows, v, steps, o, s);
        case 32: return launch<32>(t, rv, n_rows, v, steps, o, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
