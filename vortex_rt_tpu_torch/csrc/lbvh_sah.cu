// lbvh_sah.cu — one level of the sweep-SAH binary tree over the Morton
// order on Hopper (`_sah_sweep_tree`, `method="sah"` of the LBVH build).
//
// Replaces the XLA while_loop of `_sah_sweep_tree`,
// vortex_rt_tpu/accel/lbvh.py:170 (loop :280, body :222-273).  Every
// position i of the l sorted leaf boxes carries its contiguous range
// [seg_lo, seg_hi] and the internal node id of that range.  A level splits
// every range longer than one at its SAH-cheapest position inside the
// middle half (both sides >= max(1, len // 4)):
//   cost(i) = half_area(box[seg_lo..i]) * (i - seg_lo + 1)
//           + half_area(box[i+1..seg_hi']) * (seg_hi - i),
// where seg_hi' is the range end of position i+1 (JAX's shifted suffix);
// the cheapest position wins, the lower one on equal cost.  The range's
// first position then records the split at its internal node (children
// allocated by an exclusive cumsum of each range's new internal count, in
// position order), and every position moves into its half.
//
// Kernels, in stream order, per level (the host loop runs the levels; it
// reads one flag a level, "a range longer than one is left", and stops at
// 96 levels as JAX does):
//   vrt_sah_split:  tiles_kernel  segmented prefix and suffix box scans
//                                 inside tiles of 1024 positions (warp
//                                 shuffles, then the 32 warp aggregates);
//                   carry_kernel  one block: the segmented scan of the tile
//                                 aggregates (a chunk per thread, then the
//                                 block), forward and backward;
//                   cost_kernel   the carries applied, the SAH cost, and the
//                                 argmin per range: a 64-bit key (cost bits
//                                 << 32 | position) min-reduced within each
//                                 warp's part of the range and folded into
//                                 the range's first position by atomicMin
//                                 (costs are >= 0, so their bits order as
//                                 the floats do; the key's low word breaks
//                                 ties to the lower position);
//                   split_kernel  each range's new internal count;
//   torch.cumsum between them (the JAX package's jnp.cumsum);
//   vrt_sah_assign: assign_kernel records and moves every range.
// Float min and max are exact in any order, so only the cost arithmetic
// keeps JAX's order: ((e0*e1 + e1*e2) + e2*e0) per box, then
// sa_pre*cnt_l + sa_next*cnt_r, no FMA (-fmad=false).  The counts are
// converted to float32 as XLA converts them, and compared with minside as
// float32, as JAX's promotion does.  A cost of -0 is made +0 before it
// becomes a key.
//
// What bounds it on this card: each level reads every position's box and
// range and writes the range back, a few operations a word (bytes), and a
// level is five launches, a scan and a 4-byte read (launches, at small l).
//
// Built by vortex_rt_tpu_torch/runtime/kernels.py with nvcc into a shared
// library with a plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

#define VRT_TILE 1024
#define VRT_BLOCK 256
#define VRT_INVALID_COST 3e38f
#define VRT_FULL 0xffffffffu
#define VRT_NONE 0x7fffffff

namespace {

struct Box {
    float v[6];  // min xyz, max xyz
};

// the union of two boxes of one range, p before q
__device__ __forceinline__ Box comb(const Box& p, const Box& q) {
    Box r;
#pragma unroll
    for (int k = 0; k < 3; ++k) r.v[k] = fminf(p.v[k], q.v[k]);
#pragma unroll
    for (int k = 3; k < 6; ++k) r.v[k] = fmaxf(p.v[k], q.v[k]);
    return r;
}

__device__ __forceinline__ Box load_box(const float* mn, const float* mx,
                                        int i) {
    Box b;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        b.v[k] = mn[3 * i + k];
        b.v[k + 3] = mx[3 * i + k];
    }
    return b;
}

__device__ __forceinline__ Box load6(const float* a, int i) {
    Box b;
#pragma unroll
    for (int k = 0; k < 6; ++k) b.v[k] = a[6 * i + k];
    return b;
}

__device__ __forceinline__ void store6(float* a, int i, const Box& b) {
#pragma unroll
    for (int k = 0; k < 6; ++k) a[6 * i + k] = b.v[k];
}

__device__ __forceinline__ float half_area(const Box& b) {
    const float e0 = fmaxf(b.v[3] - b.v[0], 0.0f);
    const float e1 = fmaxf(b.v[4] - b.v[1], 0.0f);
    const float e2 = fmaxf(b.v[5] - b.v[2], 0.0f);
    return (e0 * e1 + e1 * e2) + e2 * e0;
}

// Inclusive segmented scan over the block's threads, which hold elements
// in increasing position: element `pos` covers a contiguous run of
// positions ending at `pos`, and belongs to the range starting at `lo`.
// An earlier element joins when its run ends at or after `lo`.  Invalid
// threads (after the valid ones) carry pos = lo = VRT_NONE.
__device__ Box block_scan(Box v, int pos, int lo, Box* sh_box, int* sh_pos,
                          int* sh_lo) {
    const int lane = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
#pragma unroll
    for (int k = 1; k < 32; k <<= 1) {
        Box nb;
#pragma unroll
        for (int m = 0; m < 6; ++m) nb.v[m] = __shfl_up_sync(VRT_FULL, v.v[m], k);
        const int np = __shfl_up_sync(VRT_FULL, pos, k);
        if (lane >= k && np >= lo) v = comb(nb, v);
    }
    if (lane == 31) {
        sh_box[w] = v;
        sh_pos[w] = pos;
        sh_lo[w] = lo;
    }
    __syncthreads();
    if (w == 0) {
        Box u = v;
        int upos = VRT_NONE, ulo = VRT_NONE;
        if (lane < nw) {
            u = sh_box[lane];
            upos = sh_pos[lane];
            ulo = sh_lo[lane];
        }
#pragma unroll
        for (int k = 1; k < 32; k <<= 1) {
            Box nb;
#pragma unroll
            for (int m = 0; m < 6; ++m) nb.v[m] = __shfl_up_sync(VRT_FULL, u.v[m], k);
            const int np = __shfl_up_sync(VRT_FULL, upos, k);
            if (lane >= k && np >= ulo) u = comb(nb, u);
        }
        if (lane < nw) sh_box[lane] = u;
    }
    __syncthreads();
    if (w > 0 && sh_pos[w - 1] >= lo) v = comb(sh_box[w - 1], v);
    __syncthreads();
    return v;
}

struct SplitArgs {
    const float* lmin; const float* lmax;   // (l, 3) sorted leaf boxes
    const int* seg_lo; const int* seg_hi;   // (l,)
    float* pre; float* suf;                 // (l, 6) in-tile scans
    float* agg_box;                         // (2, nt, 6) tile aggregates
    int* agg_pos; int* agg_lo;              // (2, nt)
    unsigned long long* keys;               // (l,) argmin keys
    int* contrib;                           // (l,) new internals per range
    int l, nt;
};

// The in-tile scans: forward over positions, backward over the reversed
// positions (logical p = l-1-i, a range [lo, hi] becomes [l-1-hi, l-1-lo]),
// so both are the same prefix scan.
__global__ void __launch_bounds__(VRT_TILE) tiles_kernel(const SplitArgs a) {
    __shared__ Box sh_box[32];
    __shared__ int sh_pos[32], sh_lo[32];
    const int p = blockIdx.x * VRT_TILE + threadIdx.x;
    const bool valid = p < a.l;
    if (valid) a.keys[p] = ~0ull;
    const int last = min(blockIdx.x * VRT_TILE + VRT_TILE - 1, a.l - 1);
    for (int dir = 0; dir < 2; ++dir) {
        const int i = dir ? a.l - 1 - p : p;
        Box v;
        int lo = VRT_NONE, pos = VRT_NONE;
        if (valid) {
            v = load_box(a.lmin, a.lmax, i);
            lo = dir ? a.l - 1 - a.seg_hi[i] : a.seg_lo[i];
            pos = p;
        } else {
#pragma unroll
            for (int k = 0; k < 6; ++k) v.v[k] = 0.0f;
        }
        v = block_scan(v, pos, lo, sh_box, sh_pos, sh_lo);
        if (valid) store6(dir ? a.suf : a.pre, i, v);
        if (p == last) {
            const int t = dir * a.nt + blockIdx.x;
            store6(a.agg_box, t, v);
            a.agg_pos[t] = p;
            a.agg_lo[t] = lo;
        }
    }
}

// The segmented inclusive scan of the tile aggregates, in place: after it
// aggregate t covers its tile's last position's range from the range's
// start (within the scanned direction).
__global__ void __launch_bounds__(VRT_TILE) carry_kernel(const SplitArgs a) {
    __shared__ Box sh_box[32];
    __shared__ int sh_pos[32], sh_lo[32];
    __shared__ Box th_box[VRT_TILE];
    __shared__ int th_pos[VRT_TILE];
    const int c = (a.nt + VRT_TILE - 1) / VRT_TILE;
    const int j = threadIdx.x;
    const int b0 = j * c;
    const int b1 = min(b0 + c, a.nt);
    for (int dir = 0; dir < 2; ++dir) {
        float* box = a.agg_box + 6 * dir * a.nt;
        const int* apos = a.agg_pos + dir * a.nt;
        const int* alo = a.agg_lo + dir * a.nt;
        Box s;
#pragma unroll
        for (int k = 0; k < 6; ++k) s.v[k] = 0.0f;
        int spos = VRT_NONE, slo = VRT_NONE;
        for (int b = b0; b < b1; ++b) {
            const Box x = load6(box, b);
            s = (b > b0 && alo[b] <= spos) ? comb(s, x) : x;
            spos = apos[b];
            slo = alo[b];
            store6(box, b, s);
        }
        const Box t = block_scan(s, spos, slo, sh_box, sh_pos, sh_lo);
        th_box[j] = t;
        th_pos[j] = spos;
        __syncthreads();
        if (j > 0 && b0 < b1) {
            const Box carry = th_box[j - 1];
            const int cpos = th_pos[j - 1];
            for (int b = b0; b < b1; ++b) {
                if (alo[b] <= cpos) store6(box, b, comb(carry, load6(box, b)));
            }
        }
        __syncthreads();
    }
}

__global__ void __launch_bounds__(VRT_BLOCK) cost_kernel(const SplitArgs a) {
    const int i = blockIdx.x * VRT_BLOCK + threadIdx.x;
    const int lane = threadIdx.x & 31;
    unsigned long long key = ~0ull;
    int lo = -1, hi = -1;
    if (i < a.l) {
        lo = a.seg_lo[i];
        hi = a.seg_hi[i];
        Box pre = load6(a.pre, i);
        const int t = i / VRT_TILE;
        if (lo < t * VRT_TILE) pre = comb(load6(a.agg_box, t - 1), pre);
        float sa_next = 0.0f;
        if (i + 1 < a.l) {
            const int jp = i + 1;
            const int q = a.l - 1 - jp;
            const int tq = q / VRT_TILE;
            Box suf = load6(a.suf, jp);
            if (a.l - 1 - a.seg_hi[jp] < tq * VRT_TILE) {
                suf = comb(load6(a.agg_box, a.nt + tq - 1), suf);
            }
            sa_next = half_area(suf);
        }
        const float sa_pre = half_area(pre);
        const float cnt_l = (float)(i - lo + 1);
        const float cnt_r = (float)(hi - i);
        float cost = sa_pre * cnt_l + sa_next * cnt_r;
        const int len = hi - lo + 1;
        const float minside = (float)max(1, len / 4);
        const bool ok = len > 1 && i < hi && cnt_l >= minside
                        && cnt_r >= minside;
        cost = ok ? cost + 0.0f : VRT_INVALID_COST;
        key = ((unsigned long long)__float_as_uint(cost) << 32)
              | (unsigned long long)(unsigned)i;
    }
    // min over this warp's part of each range (suffix doubling), then one
    // atomic per range part
#pragma unroll
    for (int k = 1; k < 32; k <<= 1) {
        const unsigned long long nb = __shfl_down_sync(VRT_FULL, key, k);
        if (lane + k < 32 && i + k <= hi && nb < key) key = nb;
    }
    if (i < a.l && (lane == 0 || i == lo)) atomicMin(a.keys + lo, key);
}

__global__ void __launch_bounds__(VRT_BLOCK) split_kernel(const SplitArgs a) {
    const int i = blockIdx.x * VRT_BLOCK + threadIdx.x;
    if (i >= a.l) return;
    const int lo = a.seg_lo[i], hi = a.seg_hi[i];
    int n = 0;
    if (i == lo && hi > lo) {
        const int split = (int)(unsigned)(a.keys[lo] & 0xffffffffull);
        n = (split > lo ? 1 : 0) + (hi > split + 1 ? 1 : 0);
    }
    a.contrib[i] = n;
}

struct AssignArgs {
    const unsigned long long* keys;
    const int* incl; const int* contrib;   // inclusive cumsum, counts
    const int* next_in; int* next_out;     // () next free internal id
    int* seg_lo; int* seg_hi; int* node;   // (l,) updated in place
    int* lch; int* rch; int* nlo; int* nhi;  // (l-1,) the tree
    int* flag;                             // () set if a range is left
    int l;
};

__global__ void __launch_bounds__(VRT_BLOCK)
assign_kernel(const AssignArgs a) {
    const int i = blockIdx.x * VRT_BLOCK + threadIdx.x;
    if (i >= a.l) return;
    const int nxt = a.next_in[0];
    if (i == 0) a.next_out[0] = nxt + a.incl[a.l - 1];
    const int lo = a.seg_lo[i], hi = a.seg_hi[i];
    if (hi <= lo) return;
    const int split = (int)(unsigned)(a.keys[lo] & 0xffffffffull);
    const int base = nxt + a.incl[lo] - a.contrib[lo];
    const int left_int = split > lo ? 1 : 0;
    const bool right_int = hi > split + 1;
    const int lid = left_int ? base : (a.l - 1) + lo;
    const int rid = right_int ? base + left_int : (a.l - 1) + hi;
    const int nd = a.node[i];
    if (i == lo && nd < a.l - 1) {
        a.lch[nd] = lid;
        a.rch[nd] = rid;
        a.nlo[nd] = lo;
        a.nhi[nd] = hi;
    }
    const bool left = i <= split;
    const int lo2 = left ? lo : split + 1;
    const int hi2 = left ? split : hi;
    a.seg_lo[i] = lo2;
    a.seg_hi[i] = hi2;
    a.node[i] = left ? lid : rid;
    if (hi2 > lo2) a.flag[0] = 1;
}

}  // namespace

extern "C" const char* vrt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// The level's split positions and each range's new internal count:
// four kernels on `stream`; returns the first CUDA error (0 = ok).
extern "C" int vrt_sah_split(
        const void* lmin, const void* lmax, const void* seg_lo,
        const void* seg_hi, void* pre, void* suf, void* agg_box,
        void* agg_pos, void* agg_lo, void* keys, void* contrib, int l,
        void* stream) {
    if (l < 2) return (int)cudaErrorInvalidValue;
    SplitArgs a;
    a.lmin = (const float*)lmin; a.lmax = (const float*)lmax;
    a.seg_lo = (const int*)seg_lo; a.seg_hi = (const int*)seg_hi;
    a.pre = (float*)pre; a.suf = (float*)suf; a.agg_box = (float*)agg_box;
    a.agg_pos = (int*)agg_pos; a.agg_lo = (int*)agg_lo;
    a.keys = (unsigned long long*)keys; a.contrib = (int*)contrib;
    a.l = l; a.nt = (l + VRT_TILE - 1) / VRT_TILE;
    cudaStream_t s = (cudaStream_t)stream;
    const int grid = (l + VRT_BLOCK - 1) / VRT_BLOCK;
    tiles_kernel<<<a.nt, VRT_TILE, 0, s>>>(a);
    carry_kernel<<<1, VRT_TILE, 0, s>>>(a);
    cost_kernel<<<grid, VRT_BLOCK, 0, s>>>(a);
    split_kernel<<<grid, VRT_BLOCK, 0, s>>>(a);
    return (int)cudaGetLastError();
}

// Records every range's split and moves every position into its half;
// one kernel on `stream`.
extern "C" int vrt_sah_assign(
        const void* keys, const void* incl, const void* contrib,
        const void* next_in, void* next_out, void* seg_lo, void* seg_hi,
        void* node, void* lch, void* rch, void* nlo, void* nhi, void* flag,
        int l, void* stream) {
    if (l < 2) return (int)cudaErrorInvalidValue;
    AssignArgs a;
    a.keys = (const unsigned long long*)keys;
    a.incl = (const int*)incl; a.contrib = (const int*)contrib;
    a.next_in = (const int*)next_in; a.next_out = (int*)next_out;
    a.seg_lo = (int*)seg_lo; a.seg_hi = (int*)seg_hi; a.node = (int*)node;
    a.lch = (int*)lch; a.rch = (int*)rch; a.nlo = (int*)nlo;
    a.nhi = (int*)nhi; a.flag = (int*)flag; a.l = l;
    const int grid = (l + VRT_BLOCK - 1) / VRT_BLOCK;
    assign_kernel<<<grid, VRT_BLOCK, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
