// ploc_collapse.cu — the PLOC tree's ids, parents and depth-stride wide
// collapse in one launch (kernel K4b).
//
// Replaces the creation-order remap of `build_ploc_topo` of
// vortex_rt_tpu/accel/ploc.py (:393-406, scatters) and `_collapse_ploc`
// (:223), which finds node depths by ready propagation from the root (a
// while_loop of whole-array steps, :247), builds the child lists with
// stacked selects and numbers the wide children with a cumsum.
//
// What bounds it: not its bytes (about 100 B a node at width 8) but its
// steps.  Done as three kernels, two fills, a zero fill and a prefix sum
// issued from the host, a build paid about nine launches for 0.01-0.11 ms
// of kernels.  Here one cooperative, persistent launch (a grid sized by
// the occupancy calculator, grid-stride loops) does it all, with
// grid.sync() between four phases:
//
// 0. the words no later phase need write: parent 0 and newid -1 of every
//    node (newid[0] = 0), max_depth 0;
// 1. the remap: old id o < n_int takes the record created as
//    k = n_int-1-o (the root, created last, becomes 0; children encoded
//    -(k'+1) become n_int-1-k'), its children, creation round and box, and
//    writes itself as the parent of its two children.  Rows n_int.. (never
//    created) are zero, as the JAX scatter leaves them;
// 2. the expansion: a live internal walks its parents to the root for its
//    binary depth (a thread's walks four at a time, their dependent loads
//    in flight together) — the value the JAX propagation gives every node it
//    reaches within its 256 rounds (a deeper node keeps 0 there, and here)
//    — and survives at depth % 2 == 0 (width 4) or % 3 == 0 (width 8).
//    Every internal, live or not (the JAX arrays carry the dead rows too),
//    gets the list of descendants two (three) levels down where a leaf row
//    (id >= l-1) takes one slot (ch_old, arity); the deepest live node's
//    depth goes to one atomicMax (the tree's real depth, ROADMAP H8).  A
//    block owns a contiguous run of nodes and writes the sum of its
//    survivors' arities;
// 3. the numbering: each block sums the totals of the blocks before it
//    (its offset; no block scans for the others, so no fourth barrier),
//    scans its run's arities with warp shuffles into base = 1 + the
//    exclusive prefix sum, and the thread of survivor i gives child
//    ch_old[i][t] its new id base[i] + t.  Every node is the wide child of
//    exactly one survivor, so all targets are distinct.
//
// All integers: the topology equals the JAX package's field for field.
// Words that another block wrote in this launch are read with ld.global.cg
// (L2, coherent), never through the read-only path.
//
// Built by vortex_rt_tpu_torch/runtime/kernels.py with nvcc into a shared
// library with a plain C interface, loaded with ctypes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBlock = 256;
constexpr int kDepthCap = 256;  // rounds of the JAX ready propagation
constexpr int kWalks = 4;       // a thread's depth walks in flight together

struct Collapse {
    const int *lk, *rk, *lvl;
    const float *bmn, *bmx;
    const int* n_int;
    int l;
    int *lchild, *rchild, *level;
    float *imin, *imax;
    int* parent;
    unsigned char* surv;
    int *ch_old, *arity, *base, *newid, *max_depth, *totals;
};

// descendants of internal n two levels down; a leaf row takes one slot
__device__ __forceinline__ int expand4(const Collapse& g, int n, int* out) {
    const int l = g.l;
    int k = 0;
    const int lc = __ldcg(g.lchild + n), rc = __ldcg(g.rchild + n);
    if (lc >= l - 1) {
        out[k++] = lc;
    } else {
        out[k++] = __ldcg(g.lchild + lc);
        out[k++] = __ldcg(g.rchild + lc);
    }
    if (rc >= l - 1) {
        out[k++] = rc;
    } else {
        out[k++] = __ldcg(g.lchild + rc);
        out[k++] = __ldcg(g.rchild + rc);
    }
    return k;
}

// the block's sum of v (every thread gets it)
__device__ __forceinline__ int block_sum(int v, int* s_warp) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
    __syncthreads();  // s_warp's previous readers are done
    if (lane == 0) s_warp[w] = v;
    __syncthreads();
    int t = 0;
#pragma unroll
    for (int k = 0; k < kBlock / 32; ++k) t += s_warp[k];
    return t;
}

// exclusive prefix sum of v over the block's threads, and the block's total
__device__ __forceinline__ int block_scan(int v, int& total, int* s_warp) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    int inc = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, inc, d);
        if (lane >= d) inc += y;
    }
    __syncthreads();
    if (lane == 31) s_warp[w] = inc;
    __syncthreads();
    int before = 0;
    total = 0;
#pragma unroll
    for (int k = 0; k < kBlock / 32; ++k) {
        const int x = s_warp[k];
        if (k < w) before += x;
        total += x;
    }
    return before + inc - v;
}

template <int W>
__global__ void __launch_bounds__(kBlock) remap_collapse_kernel(Collapse g) {
    cg::grid_group grid = cg::this_grid();
    __shared__ int s_warp[kBlock / 32];
    const int l = g.l, ni = l - 1, n = *g.n_int;
    const long long nodes = 2LL * l - 1;
    const int gtid = blockIdx.x * kBlock + threadIdx.x, stride = gridDim.x * kBlock;

    // 0. the words no later phase need write
    for (long long x = gtid; x < nodes; x += stride) {
        g.parent[x] = 0;
        g.newid[x] = x == 0 ? 0 : -1;
    }
    if (gtid == 0) *g.max_depth = 0;
    grid.sync();

    // 1. the remap, and the parents of the live internals' children
    for (int o = gtid; o < ni; o += stride) {
        if (o >= n) {
            g.lchild[o] = g.rchild[o] = g.level[o] = 0;
#pragma unroll
            for (int a = 0; a < 3; ++a) g.imin[3LL * o + a] = g.imax[3LL * o + a] = 0.0f;
            continue;
        }
        const int k = n - 1 - o;
        int lc = g.lk[k], rc = g.rk[k];
        lc = lc >= l - 1 ? lc : n + lc;
        rc = rc >= l - 1 ? rc : n + rc;
        g.lchild[o] = lc;
        g.rchild[o] = rc;
        g.level[o] = g.lvl[k];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            g.imin[3LL * o + a] = g.bmn[3LL * k + a];
            g.imax[3LL * o + a] = g.bmx[3LL * k + a];
        }
        g.parent[lc] = o;
        g.parent[rc] = o;
    }
    grid.sync();

    // 2. the expansion, over the block's run of chunks
    const int chunks = (ni + kBlock - 1) / kBlock;
    const int per = (chunks + gridDim.x - 1) / gridDim.x;
    const int c0 = blockIdx.x * per, c1 = min(c0 + per, chunks);
    int sum = 0;
    for (int cb = c0; cb < c1; cb += kWalks) {
        // the depth walks of up to kWalks of the thread's nodes, their
        // dependent loads in flight together
        int p[kWalks], d[kWalks];
#pragma unroll
        for (int k = 0; k < kWalks; ++k) {
            const int o = (cb + k) * kBlock + threadIdx.x;
            p[k] = cb + k < c1 && o < n ? o : 0;  // (0: no walk)
            d[k] = 0;
        }
        bool walking = true;
        while (walking) {
            walking = false;
#pragma unroll
            for (int k = 0; k < kWalks; ++k)
                if (p[k] != 0 && d[k] <= kDepthCap) {
                    p[k] = __ldcg(g.parent + p[k]);
                    ++d[k];
                    walking = true;
                }
        }
#pragma unroll 1
        for (int k = 0; k < kWalks && cb + k < c1; ++k) {
            const int o = (cb + k) * kBlock + threadIdx.x;
            if (o >= ni) break;
            const bool live = o < n;
            int depth = 0;
            if (live) {
                const bool reached = p[k] == 0 && d[k] <= kDepthCap;
                depth = reached ? d[k] : 0;
                atomicMax(g.max_depth, reached ? d[k] : kDepthCap + 1);
            }
            const bool sv = live && depth % (W == 4 ? 2 : 3) == 0;
            int ch[W];
            int a = 0;
            if (W == 4) {
                a = expand4(g, o, ch);
            } else {
                const int c2[2] = {__ldcg(g.lchild + o), __ldcg(g.rchild + o)};
#pragma unroll
                for (int s = 0; s < 2; ++s) {
                    if (c2[s] >= l - 1) {
                        ch[a++] = c2[s];
                    } else {
                        int sub[4];
                        const int m = expand4(g, c2[s], sub);
                        for (int t = 0; t < m; ++t) ch[a++] = sub[t];
                    }
                }
            }
            for (int t = 0; t < W; ++t) g.ch_old[(long long)o * W + t] = t < a ? ch[t] : -1;
            g.surv[o] = sv ? 1 : 0;
            g.arity[o] = a;
            sum += sv ? a : 0;
        }
    }
    const int total = block_sum(sum, s_warp);
    if (threadIdx.x == 0) g.totals[blockIdx.x] = total;
    grid.sync();

    // 3. the block's offset, base, and the new ids of the survivors'
    // children (the thread reads back what it wrote in phase 2)
    int off = 0;
    for (int b = threadIdx.x; b < blockIdx.x; b += kBlock) off += __ldcg(g.totals + b);
    off = 1 + block_sum(off, s_warp);
    for (int c = c0; c < c1; ++c) {
        const int o = c * kBlock + threadIdx.x;
        const bool in = o < ni;
        const bool sv = in && g.surv[o];
        const int a = in ? g.arity[o] : 0;
        int run;
        const int ex = block_scan(sv ? a : 0, run, s_warp);
        if (in) {
            const int base = off + ex;
            g.base[o] = base;
            if (sv)
                for (int t = 0; t < a; ++t) g.newid[g.ch_old[(long long)o * W + t]] = base + t;
        }
        off += run;
    }
}

template <int W>
int launch(Collapse& g, int l, cudaStream_t s) {
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
        if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &per_sm, remap_collapse_kernel<W>, kBlock, 0)) != cudaSuccess)
            return (int)err;
        if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
        most_by_dev[dev] = per_sm * sms;
    }
    // no more blocks than chunks of internals (the size of `totals`)
    const long long chunks = (l - 1 + kBlock - 1) / kBlock;
    const int blocks = (int)(chunks < most_by_dev[dev] ? chunks : most_by_dev[dev]);
    void* args[] = {&g};
    return (int)cudaLaunchCooperativeKernel((void*)remap_collapse_kernel<W>, blocks, kBlock, args,
                                            0, s);
}

}  // namespace

extern "C" const char* vrt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// The remap and the collapse on `stream`, one cooperative launch.  Inputs
// in creation order: lk, rk, lvl (l-1,) int32, bmn, bmx (l-1, 3) float32;
// n_int a device int32.  Outputs, every word written: in old ids lchild,
// rchild, level (l-1,) int32, imin, imax (l-1, 3) float32, parent (2l-1,);
// surv (l-1,) bytes 0/1, ch_old (l-1, width), arity, base (l-1,) int32,
// newid (2l-1,), max_depth a device int32.  `totals` is ceil((l-1)/256)
// int32 of scratch.  A refused launch (the cooperative grid among them)
// returns its error.  Returns 0 on success.
extern "C" int vrt_ploc_remap_collapse(const void* lk, const void* rk, const void* lvl,
                                       const void* bmn, const void* bmx, const void* n_int,
                                       int l, int width, void* lchild, void* rchild,
                                       void* level, void* imin, void* imax, void* parent,
                                       void* surv, void* ch_old, void* arity, void* base,
                                       void* newid, void* max_depth, void* totals,
                                       void* stream) {
    if (l < 2 || (width != 4 && width != 8)) return (int)cudaErrorInvalidValue;
    Collapse g{(const int*)lk,    (const int*)rk,      (const int*)lvl,   (const float*)bmn,
               (const float*)bmx, (const int*)n_int,   l,                 (int*)lchild,
               (int*)rchild,      (int*)level,         (float*)imin,      (float*)imax,
               (int*)parent,      (unsigned char*)surv, (int*)ch_old,     (int*)arity,
               (int*)base,        (int*)newid,         (int*)max_depth,   (int*)totals};
    cudaStream_t s = (cudaStream_t)stream;
    return width == 4 ? launch<4>(g, l, s) : launch<8>(g, l, s);
}
