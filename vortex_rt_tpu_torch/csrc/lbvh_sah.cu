// lbvh_sah.cu — the sweep-SAH binary tree over the Morton order on Hopper
// (`_sah_sweep_tree`, `method="sah"` of the LBVH build), every level in one
// cooperative launch.
//
// Replaces the XLA while_loop of `_sah_sweep_tree`,
// vortex_rt_tpu/accel/lbvh.py:170 (loop :280, body :222-273).  Every
// position i of the l sorted leaf boxes carries its contiguous range
// [seg_lo, seg_hi].  A level splits every range longer than one at its
// SAH-cheapest position inside the middle half (both sides >=
// max(1, len // 4)):
//   cost(i) = half_area(box[seg_lo..i]) * (i - seg_lo + 1)
//           + half_area(box[i+1..seg_hi]) * (seg_hi - i);
// the cheapest position wins, the lower one on equal cost.  The range's
// first position then records the split at its internal node (children
// allocated by an exclusive scan of each range's new internal count, in
// position order), and every position moves into its half.
//
// Design.  One persistent cooperative launch (a grid sized by the occupancy
// calculator, grid.sync() between phases) runs every level, until no range
// longer than one is left or 96 levels (the JAX cap) have run; the host
// reads the level count once, after it.  Block b owns a contiguous chunk
// of positions, cut into sub-tiles of 1,024: blocks of 512 threads, two
// adjacent positions a thread (half the shuffles and barriers a position
// of one), two blocks an SM (each at most 64 registers a thread); a
// sub-tile whose positions all sit in ranges of length one skips every
// later level.  Only the block reads its positions' ranges, so they (and each
// position's split) live in its shared memory where the chunk fits beside
// the other block of its SM (up to about 8,000 positions a block, 2.1 M
// leaf boxes on 132 SMs); past that they live in global memory and the
// grid stays at two blocks an SM.  A level is
// two phases:
//   cost:   the block's cross-block carries (the boxes of a range before
//           and after the chunk: the other blocks' chunk aggregates, one
//           warp a direction), the sub-tile carries (a chain over the
//           sub-tile aggregates in shared memory), then per sub-tile the
//           forward and backward segmented box scans at once (a thread's
//           pair, warp shuffles, then the 32 warp aggregates, a warp a
//           direction), the cost, and the argmin per range:
//           a 64-bit key (cost bits << 32 | position) min-reduced within
//           each warp's part of the range, then in shared memory, then
//           stored (a range inside the sub-tile) or folded into the
//           range's first position by atomicMin (costs are >= 0, so their
//           bits order as the floats do; the key's low word breaks ties to
//           the lower position);
//   move:   each warp's new internal count (ballots), their exclusive
//           scan over the block, the block's sum published with the level
//           as a tag; every block reads the others' sums (its offset in
//           position order), records each split at its node, hands the
//           children their node ids, moves every position into its half,
//           and makes the next level's sub-tile aggregates (warp unions
//           folded into shared memory by atomics on order-keeping ints)
//           and chunk aggregates (the boxes of the range of a chunk's first
//           and last positions).
// The node of a range is kept at its first position (`node_at`).  Only the
// tile aggregates cross blocks; no prefix or suffix array is written.
// Float min and max are exact in any order, so only the cost arithmetic
// keeps JAX's order: ((e0*e1 + e1*e2) + e2*e0) per box, then
// sa_pre*cnt_l + sa_next*cnt_r, no FMA (-fmad=false).  The counts are
// converted to float32 as XLA converts them, and compared with minside as
// float32, as JAX's promotion does.  A cost of -0 is made +0 before it
// becomes a key.
//
// What bounds it on this card: a level reads every live position's box,
// a few operations a word (bytes; the range state stays on chip where it
// fits);
// in practice the latency of each sub-tile's chain of loads, scans,
// barriers and the argmin, which two blocks an SM overlap.
//
// Built by vortex_rt_tpu_torch/runtime/kernels.py with nvcc into a shared
// library with a plain C interface, loaded with ctypes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define VRT_TILE 512                       // threads a block
#define VRT_SUB (2 * VRT_TILE)             // positions a sub-tile: two a thread
#define VRT_MIN_BLOCKS (1024 / VRT_TILE)   // blocks an SM must hold (64 registers)
#define VRT_SMEM_MAX (96 * 1024)           // dynamic shared memory a block may take:
                                           // two blocks an SM
#define VRT_MAX_LEVELS 96
#define VRT_INVALID_COST 3e38f
#define VRT_FULL 0xffffffffu
#define VRT_NONE 0x7fffffff

namespace {

struct Box {
    float v[6];  // min xyz, max xyz
};

__device__ __forceinline__ Box empty_box() {
    Box b;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        b.v[k] = __int_as_float(0x7f800000);        // +inf
        b.v[k + 3] = __int_as_float(0xff800000);    // -inf
    }
    return b;
}

// the union of two boxes (min and max are exact in any order)
__device__ __forceinline__ Box comb(const Box& p, const Box& q) {
    Box r;
#pragma unroll
    for (int k = 0; k < 3; ++k) r.v[k] = fminf(p.v[k], q.v[k]);
#pragma unroll
    for (int k = 3; k < 6; ++k) r.v[k] = fmaxf(p.v[k], q.v[k]);
    return r;
}

__device__ __forceinline__ Box shfl_box(const Box& b, int k, bool down) {
    Box r;
#pragma unroll
    for (int m = 0; m < 6; ++m) {
        r.v[m] = down ? __shfl_down_sync(VRT_FULL, b.v[m], k)
                      : __shfl_up_sync(VRT_FULL, b.v[m], k);
    }
    return r;
}

__device__ __forceinline__ float half_area(const Box& b) {
    const float e0 = fmaxf(b.v[3] - b.v[0], 0.0f);
    const float e1 = fmaxf(b.v[4] - b.v[1], 0.0f);
    const float e2 = fmaxf(b.v[5] - b.v[2], 0.0f);
    return (e0 * e1 + e1 * e2) + e2 * e0;
}

struct Sweep {
    const float* lmin; const float* lmax;  // (l, 3) sorted leaf boxes
    int* seg_lo; int* seg_hi;              // (l,) each position's range, and
    int* split;                            // its range's split: the block's
                                           // own words, in global memory only
                                           // where shared memory is too small
    int* node_at;                          // (l,) a live range's node, at its first position
    unsigned long long* keys;              // (2, l) argmin keys, a buffer a level parity
    float* bfa; float* bba;                // (grid, 6) chunk aggregates
    unsigned long long* tags;              // (grid,) level << 32 | new internals of the chunk
    int* live;                             // (VRT_MAX_LEVELS + 1,) positions in live ranges
    int* levels;                           // () the levels run
    int* lch; int* rch; int* nlo; int* nhi;  // (l-1,) the tree
    int l, chunk, nsub;
    int state_in_smem;     // seg_lo, seg_hi, split of the chunk in shared memory
};

// Floats as ints that order as the floats do (for min / max by atomics in
// shared memory; the map is its own inverse).
__device__ __forceinline__ int ford(float f) {
    const int i = __float_as_int(f);
    return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float funord(int i) {
    return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// the shared memory of a block: its sub-tiles' aggregates and carries
struct SubTiles {
    Box* fcar; Box* bcar;    // the boxes of the range of the first (last)
                             // position before (after) the sub-tile
    int* fagg; int* bagg;    // (6 ordered ints each) the boxes of the range
                             // of the last (first) position inside it
    int* lo_last; int* hi_first;
    int* needf; int* needb;  // that range goes on past the sub-tile
    int* live; int* nlive;   // a position in a range longer than one
    int* wcnt;               // (32 a sub-tile) new internals of each warp,
                             // then their exclusive scan over the block
};

// bytes of shared memory a block takes for `nsub` sub-tiles
__host__ __device__ inline size_t dyn_bytes(int nsub) {
    return (size_t)nsub * (2 * sizeof(Box) + 12 * sizeof(int) + 6 * sizeof(int)
                           + 32 * sizeof(int));
}

struct Scratch {
    Box box[32], bbox[32];
    int pos[32], bnd[32], bpos[32], bbnd[32];
    unsigned long long key[VRT_SUB];
    Box cf, cb;              // the chunk's cross-block carries
    int i0, i2, i3;
};

// The inclusive segmented scans over the block's threads, which hold
// positions in increasing order (two each; invalid threads after the
// valid ones carry VRT_NONE positions, lo = VRT_NONE, hi = -1), both
// directions at once: forward, vf (the thread's own part, its last
// position at pf, its range's first lo) becomes the boxes from lo to pf;
// backward, vb (its first position at pb, its range's last hi) the boxes
// from pb to hi.  Warp shuffles, then the 32 warp aggregates (warp 0
// forward, warp 1 backward).  After it sh.box[w] holds warp w's last
// thread's forward scan and sh.bbox[w] its first thread's backward scan.
// Two barriers; the caller passes a third before the next call.
__device__ void seg_scans(Box& vf, Box& vb, int pf, int lo, int pb, int hi, Scratch& sh) {
    const int lane = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
#pragma unroll
    for (int k = 1; k < 32; k <<= 1) {
        const Box nf = shfl_box(vf, k, false);
        const Box nb = shfl_box(vb, k, true);
        const int qf = __shfl_up_sync(VRT_FULL, pf, k);
        const int qb = __shfl_down_sync(VRT_FULL, pb, k);
        if (lane >= k && qf >= lo) vf = comb(nf, vf);
        if (lane + k < 32 && qb <= hi) vb = comb(nb, vb);
    }
    if (lane == 31) {
        sh.box[w] = vf;
        sh.pos[w] = pf;
        sh.bnd[w] = lo;
    }
    if (lane == 0) {
        sh.bbox[w] = vb;
        sh.bpos[w] = pb;
        sh.bbnd[w] = hi;
    }
    __syncthreads();
    if (w < 2) {
        const bool bwd = w == 1;
        Box u = empty_box();
        int upos = VRT_NONE, ubnd = bwd ? -1 : VRT_NONE;
        if (lane < nw) {
            u = bwd ? sh.bbox[lane] : sh.box[lane];
            upos = bwd ? sh.bpos[lane] : sh.pos[lane];
            ubnd = bwd ? sh.bbnd[lane] : sh.bnd[lane];
        }
#pragma unroll
        for (int k = 1; k < 32; k <<= 1) {
            const Box nu = shfl_box(u, k, bwd);
            const int np = bwd ? __shfl_down_sync(VRT_FULL, upos, k)
                               : __shfl_up_sync(VRT_FULL, upos, k);
            const bool join = bwd ? (lane + k < nw && np <= ubnd)
                                  : (lane >= k && np >= ubnd);
            if (join) u = comb(nu, u);
        }
        if (lane < nw) {
            if (bwd) sh.bbox[lane] = u; else sh.box[lane] = u;
        }
    }
    __syncthreads();
    if (w > 0 && sh.pos[w - 1] >= lo) vf = comb(sh.box[w - 1], vf);
    if (w + 1 < nw && sh.bpos[w + 1] <= hi) vb = comb(sh.bbox[w + 1], vb);
}

__device__ __forceinline__ Box load_box(const Sweep& g, int i) {
    Box b;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        b.v[k] = g.lmin[3 * i + k];
        b.v[k + 3] = g.lmax[3 * i + k];
    }
    return b;
}

// The slots of sub-tile s's aggregates set to the empty box (threads 0-11).
__device__ __forceinline__ void clear_aggregates(const SubTiles& t, int s) {
    const int k = threadIdx.x;
    if (k < 12) {
        int* a = k < 6 ? t.fagg + 6 * s : t.bagg + 6 * s;
        a[k % 6] = k % 6 < 3 ? ford(__int_as_float(0x7f800000))
                             : ford(__int_as_float(0xff800000));
    }
}

// The next level's aggregates of sub-tile s from its positions' new
// ranges (the sub-tile's lo_last, hi_first, needf and needb set): the
// boxes of the last position's range inside the sub-tile where that range
// goes on past it (needf), the first position's where it began before it
// (needb); a thread's two positions, a warp's part by shuffles, then into
// the slots by atomics.
__device__ void warp_aggregates(const Sweep& g, const SubTiles& t, int s, int p0,
                                bool v0, bool v1) {
    const bool nf = t.needf[s] != 0, nb = t.needb[s] != 0;
    if (!nf && !nb) return;
    const int lo_last = t.lo_last[s], hi_first = t.hi_first[s];
    Box f = empty_box(), b = empty_box();
    bool any = false;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
        const int p = p0 + e;
        const bool in_f = (e ? v1 : v0) && nf && p >= lo_last;
        const bool in_b = (e ? v1 : v0) && nb && p <= hi_first;
        if (in_f || in_b) {
            const Box x = load_box(g, p);
            if (in_f) f = comb(f, x);
            if (in_b) b = comb(b, x);
            any = true;
        }
    }
    if (!__any_sync(VRT_FULL, any)) return;
#pragma unroll
    for (int k = 16; k >= 1; k >>= 1) {
        f = comb(f, shfl_box(f, k, true));
        b = comb(b, shfl_box(b, k, true));
    }
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            if (nf) {
                atomicMin(t.fagg + 6 * s + k, ford(f.v[k]));
                atomicMax(t.fagg + 6 * s + k + 3, ford(f.v[k + 3]));
            }
            if (nb) {
                atomicMin(t.bagg + 6 * s + k, ford(b.v[k]));
                atomicMax(t.bagg + 6 * s + k + 3, ford(b.v[k + 3]));
            }
        }
    }
}

__device__ __forceinline__ Box agg_box(const int* a) {
    Box b;
#pragma unroll
    for (int k = 0; k < 6; ++k) b.v[k] = funord(a[k]);
    return b;
}

// The chunk aggregates of block b from its sub-tiles' (thread 0).
__device__ void chunk_aggregates(const Sweep& g, const SubTiles& t, int c0,
                                 int c1) {
    const int last = (c1 - c0) / VRT_SUB;
    int s = last;
    Box f = agg_box(t.fagg + 6 * s);
    while (s > 0 && t.lo_last[s] < c0 + s * VRT_SUB) {
        --s;
        f = comb(f, agg_box(t.fagg + 6 * s));
    }
    s = 0;
    Box b = agg_box(t.bagg);
    while (s < last && t.hi_first[s] > min(c0 + s * VRT_SUB + VRT_SUB - 1, c1)) {
        ++s;
        b = comb(b, agg_box(t.bagg + 6 * s));
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) {
        g.bfa[6 * blockIdx.x + k] = f.v[k];
        g.bba[6 * blockIdx.x + k] = b.v[k];
    }
}

// (words other blocks wrote before the last grid barrier are read from L2)
__device__ __forceinline__ int split_of(const unsigned long long* keys, int lo) {
    return (int)(unsigned)(__ldcg(keys + lo) & 0xffffffffull);
}

// The range [lo2, hi2] position p moves into, its range [lo, hi] split
// at `split`.
__device__ __forceinline__ void move_to(int p, int lo, int hi, int split, int& lo2,
                                        int& hi2) {
    const bool left = p <= split;
    lo2 = left ? lo : split + 1;
    hi2 = left ? split : hi;
}

// The SAH key of position p in [lo, hi]: the cost bits and the position,
// ~0 where no split may fall.
__device__ __forceinline__ unsigned long long sah_key(int p, int lo, int hi,
                                                      float sa_pre, float sa_next) {
    const float cnt_l = (float)(p - lo + 1);
    const float cnt_r = (float)(hi - p);
    float cost = sa_pre * cnt_l + sa_next * cnt_r;
    const int len = hi - lo + 1;
    const float minside = (float)max(1, len / 4);
    const bool ok = len > 1 && p < hi && cnt_l >= minside && cnt_r >= minside;
    cost = ok ? cost + 0.0f : VRT_INVALID_COST;
    return ((unsigned long long)__float_as_uint(cost) << 32) | (unsigned long long)(unsigned)p;
}

__global__ void __launch_bounds__(VRT_TILE, VRT_MIN_BLOCKS) sweep_kernel(const Sweep g) {
    cg::grid_group grid = cg::this_grid();
    extern __shared__ __align__(16) unsigned char dyn[];
    __shared__ Scratch sh;
    SubTiles t;
    t.fcar = (Box*)dyn;
    t.bcar = t.fcar + g.nsub;
    t.fagg = (int*)(t.bcar + g.nsub);
    t.bagg = t.fagg + 6 * g.nsub;
    t.lo_last = t.bagg + 6 * g.nsub;
    t.hi_first = t.lo_last + g.nsub;
    t.needf = t.hi_first + g.nsub;
    t.needb = t.needf + g.nsub;
    t.live = t.needb + g.nsub;
    t.nlive = t.live + g.nsub;
    t.wcnt = t.nlive + g.nsub;

    const int l = g.l;
    const int b = blockIdx.x;
    const int nb = gridDim.x;
    const int c0 = b * g.chunk;
    const int c1 = min(c0 + g.chunk, l) - 1;          // the chunk [c0, c1]
    const int ns = (c1 - c0) / VRT_SUB + 1;            // its sub-tiles
    const int tid = threadIdx.x;
    const int lane = tid & 31, w = tid >> 5;
    const unsigned lt = (1u << lane) - 1u;
    // the chunk's range state, indexed by position - c0: no other block
    // reads it
    int* slo = g.state_in_smem ? (int*)(dyn + dyn_bytes(g.nsub)) : g.seg_lo + c0;
    int* shi = g.state_in_smem ? slo + g.chunk : g.seg_hi + c0;
    int* ssp = g.state_in_smem ? shi + g.chunk : g.split + c0;

    // ---- set-up: the root range everywhere, the tree zeroed
    for (int i = tid; i <= c1 - c0; i += VRT_TILE) {
        slo[i] = 0;
        shi[i] = l - 1;
    }
    for (long long i = (long long)b * VRT_TILE + tid; i < l - 1; i += (long long)nb * VRT_TILE) {
        g.lch[i] = 0; g.rch[i] = 0; g.nlo[i] = 0; g.nhi[i] = 0;
    }
    if (b == 0) {
        for (int d = tid; d <= VRT_MAX_LEVELS; d += VRT_TILE) g.live[d] = d == 0 ? l : 0;
        if (tid == 0) {
            g.keys[0] = ~0ull;
            g.node_at[0] = 0;
        }
    }
    if (tid == 0) g.tags[b] = ~0ull;
    sh.key[tid] = ~0ull;
    sh.key[tid + VRT_TILE] = ~0ull;
    for (int s = 0; s < ns; ++s) {
        const int start = c0 + s * VRT_SUB, end = min(start + VRT_SUB - 1, c1);
        clear_aggregates(t, s);
        if (tid == 0) {
            t.live[s] = 1;
            t.lo_last[s] = 0;
            t.hi_first[s] = l - 1;
            t.needf[s] = l - 1 > end;
            t.needb[s] = start > 0;
        }
    }
    __syncthreads();
    for (int s = 0; s < ns; ++s) {
        const int start = c0 + s * VRT_SUB, end = min(start + VRT_SUB - 1, c1);
        const int p0 = start + 2 * tid;
        warp_aggregates(g, t, s, p0, p0 <= end, p0 + 1 <= end);
    }
    __syncthreads();
    if (tid == 0) chunk_aggregates(g, t, c0, c1);
    int next_free = 1;     // the next internal node id
    int d = 0;
    grid.sync();

    for (;;) {
        unsigned long long* keys = g.keys + (size_t)(d & 1) * l;
        unsigned long long* keys_next = g.keys + (size_t)((d + 1) & 1) * l;
        bool any = false;
        for (int s = 0; s < ns; ++s) any |= t.live[s] != 0;

        // ---- cost: carries, scans, costs, the argmin of every range
        if (any) {
            if (w < 2) {
                // w 0: the boxes of the chunk's first range before the
                // chunk; w 1: of its last range after it
                const int bound = w == 0 ? slo[0] : shi[c1 - c0];
                Box u = empty_box();
                const bool cross = w == 0 ? bound < c0 : bound > c1;
                if (cross) {
                    for (int j0 = 0;; j0 += 32) {
                        const int o = w == 0 ? b - 1 - j0 - lane : b + 1 + j0 + lane;
                        const bool in = w == 0
                            ? (o >= 0 && min(o * g.chunk + g.chunk, l) - 1 >= bound)
                            : (o < nb && o * g.chunk <= bound);
                        if (in) {
                            const float* a = (w == 0 ? g.bfa : g.bba) + 6 * o;
                            Box x;
#pragma unroll
                            for (int k = 0; k < 6; ++k) x.v[k] = __ldcg(a + k);
                            u = comb(u, x);
                        }
                        if (!__any_sync(VRT_FULL, in) || j0 + 32 >= nb) break;
                    }
#pragma unroll
                    for (int k = 16; k >= 1; k >>= 1) u = comb(u, shfl_box(u, k, true));
                }
                if (lane == 0) {
                    if (w == 0) sh.cf = u; else sh.cb = u;
                }
            }
            __syncthreads();
            if (tid == 0) {
                Box r = sh.cf;
                for (int s = 0; s < ns; ++s) {
                    t.fcar[s] = r;
                    const Box a = agg_box(t.fagg + 6 * s);
                    r = t.lo_last[s] < c0 + s * VRT_SUB ? comb(r, a) : a;
                }
            } else if (tid == 32) {
                Box r = sh.cb;
                for (int s = ns - 1; s >= 0; --s) {
                    t.bcar[s] = r;
                    const int end = min(c0 + s * VRT_SUB + VRT_SUB - 1, c1);
                    const Box a = agg_box(t.bagg + 6 * s);
                    r = t.hi_first[s] > end ? comb(r, a) : a;
                }
            }
            __syncthreads();
            for (int s = 0; s < ns; ++s) {
                if (!t.live[s]) continue;
                const int start = c0 + s * VRT_SUB, end = min(start + VRT_SUB - 1, c1);
                const int p0 = start + 2 * tid, p1 = p0 + 1;
                const bool v0 = p0 <= end, v1 = p1 <= end;
                int lo0 = VRT_NONE, hi0 = -1, lo1 = VRT_NONE, hi1 = -1;
                Box x0 = empty_box(), x1 = empty_box();
                if (v0) {
                    lo0 = slo[p0 - c0];
                    hi0 = shi[p0 - c0];
                    x0 = load_box(g, p0);
                }
                if (v1) {
                    lo1 = slo[p1 - c0];
                    hi1 = shi[p1 - c0];
                    x1 = load_box(g, p1);
                }
                // the thread's own part: forward at its last position,
                // backward at its first
                const int pf = v1 ? p1 : (v0 ? p0 : VRT_NONE);
                const int lof = v1 ? lo1 : lo0;
                const int pb = v0 ? p0 : VRT_NONE;
                Box vf = v1 ? (lo1 <= p0 ? comb(x0, x1) : x1) : x0;
                Box vb = (v1 && hi0 >= p1) ? comb(x0, x1) : x0;
                seg_scans(vf, vb, pf, lof, pb, hi0, sh);
                // the scans at p0 - 1 (forward) and p1 + 1 (backward), in
                // the sub-tile
                const Box fprev0 = shfl_box(vf, 1, false);
                const Box bnext0 = shfl_box(vb, 1, true);
                Box fprev = lane > 0 ? fprev0 : (w > 0 ? sh.box[w - 1] : empty_box());
                Box bnext = lane < 31 ? bnext0
                    : (w + 1 < (VRT_TILE >> 5) ? sh.bbox[w + 1] : empty_box());
                const Box fcar = t.fcar[s], bcar = t.bcar[s];
                // the prefix at p0 and p1, the suffix at p0 and p1, the
                // suffix at p1 + 1, each with the sub-tile's carry where its
                // range goes on past the sub-tile
                Box pre0 = lo0 < p0 ? comb(x0, fprev) : x0;
                if (lo0 < start) pre0 = comb(pre0, fcar);
                if (v1 && lof < start) vf = comb(vf, fcar);
                Box suf1 = hi1 > p1 ? comb(x1, bnext) : x1;
                if (hi1 > end) suf1 = comb(suf1, bcar);
                if (hi1 > end) bnext = comb(bnext, bcar);
                const float sa_next1 = p1 == end ? half_area(bcar) : half_area(bnext);
                const float sa_next0 = p0 == end ? half_area(bcar) : half_area(suf1);
                unsigned long long key = ~0ull;
                if (v0) key = sah_key(p0, lo0, hi0, half_area(pre0), sa_next0);
                if (v1) {
                    const unsigned long long k1 = sah_key(p1, lo1, hi1, half_area(vf), sa_next1);
                    key = k1 < key ? k1 : key;
                }
                // a thread's valid keys lie in the range of its last
                // position (p0 starts no split where p1's range begins at
                // p1): min over this warp's part of each range (suffix
                // doubling), then over the sub-tile's part in shared
                // memory (its slot cleared again by the thread that reads
                // it)
                const int klo = v1 ? lo1 : lo0, khi = v1 ? hi1 : hi0;
#pragma unroll
                for (int k = 1; k < 32; k <<= 1) {
                    const unsigned long long o = __shfl_down_sync(VRT_FULL, key, k);
                    const int q = __shfl_down_sync(VRT_FULL, pf, k);
                    if (lane + k < 32 && q <= khi && o < key) key = o;
                }
                const int first = max(klo, start);
                const bool owns = v0 && first >= p0;     // the range's first thread here
                if (v0 && khi > klo && (lane == 0 || owns)) {
                    atomicMin(&sh.key[first - start], key);
                }
                __syncthreads();
                if (owns && khi > klo) {
                    const unsigned long long m = sh.key[first - start];
                    sh.key[first - start] = ~0ull;
                    if (klo >= start && khi <= end) keys[klo] = m;
                    else atomicMin(&keys[klo], m);
                }
            }
        }
        grid.sync();

        // ---- move: each warp's new internals; the sub-tiles' new ends
        if (tid == 0) sh.i0 = 0;
        for (int s = 0; s < ns; ++s) {
            if (!t.live[s]) {               // (block-uniform)
                if (tid < 32) t.wcnt[32 * s + tid] = 0;
                continue;
            }
            const int start = c0 + s * VRT_SUB, end = min(start + VRT_SUB - 1, c1);
            int n = 0;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int p = start + 2 * tid + e;
                bool li = false, ri = false;
                if (p <= end) {
                    const int lo = slo[p - c0], hi = shi[p - c0];
                    int lo2 = lo, hi2 = hi;
                    if (hi > lo) {
                        const int split = split_of(keys, lo);
                        ssp[p - c0] = split;
                        li = p == lo && split > lo;
                        ri = p == lo && hi > split + 1;
                        move_to(p, lo, hi, split, lo2, hi2);
                    }
                    if (p == end) {
                        t.lo_last[s] = lo2;
                        t.needf[s] = hi2 > end;
                    }
                    if (p == start) {
                        t.hi_first[s] = hi2;
                        t.needb[s] = lo2 < start;
                    }
                }
                n += __popc(__ballot_sync(VRT_FULL, li)) + __popc(__ballot_sync(VRT_FULL, ri));
            }
            if (lane == 0) t.wcnt[32 * s + w] = n;
            clear_aggregates(t, s);
            if (tid == 0) t.nlive[s] = 0;
        }
        __syncthreads();
        if (w == 0) {
            // the exclusive scan of the warps' counts in position order,
            // then the block's sum published with the level
            int run = 0;
            for (int s = 0; s < ns; ++s) {
                const int own = lane < (VRT_TILE >> 5) ? t.wcnt[32 * s + lane] : 0;
                int x = own;
#pragma unroll
                for (int k = 1; k < 32; k <<= 1) {
                    const int o = __shfl_up_sync(VRT_FULL, x, k);
                    if (lane >= k) x += o;
                }
                t.wcnt[32 * s + lane] = run + x - own;
                run += __shfl_sync(VRT_FULL, x, 31);
            }
            if (lane == 0) {
                __threadfence();
                atomicExch(&g.tags[b], ((unsigned long long)d << 32) | (unsigned)run);
                sh.i2 = 0;
                sh.i3 = 0;
            }
        }
        __syncthreads();
        for (int j = tid; j < nb; j += VRT_TILE) {
            const volatile unsigned long long* tg = g.tags;
            unsigned long long v;
            do {
                v = tg[j];
            } while ((unsigned)(v >> 32) != (unsigned)d);
            const int x = (int)(unsigned)(v & 0xffffffffull);
            atomicAdd(&sh.i3, x);
            if (j < b) atomicAdd(&sh.i2, x);
        }
        __syncthreads();
        const int base = next_free + sh.i2;
        const int total = sh.i3;
        for (int s = 0; s < ns; ++s) {
            if (!t.live[s]) continue;
            const int start = c0 + s * VRT_SUB, end = min(start + VRT_SUB - 1, c1);
            const int p0 = start + 2 * tid;
            // the warp's new internals before each of this thread's positions
            int off = base + t.wcnt[32 * s + w];
            int nl = 0;
            unsigned bl[2], br[2];
            int los[2], his[2], sps[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int p = p0 + e;
                los[e] = p;
                his[e] = p;
                sps[e] = 0;
                if (p <= end) {
                    los[e] = slo[p - c0];
                    his[e] = shi[p - c0];
                    if (his[e] > los[e]) sps[e] = ssp[p - c0];
                }
                const bool rep = p <= end && p == los[e] && his[e] > los[e];
                bl[e] = __ballot_sync(VRT_FULL, rep && sps[e] > los[e]);
                br[e] = __ballot_sync(VRT_FULL, rep && his[e] > sps[e] + 1);
            }
            off += __popc(bl[0] & lt) + __popc(br[0] & lt) + __popc(bl[1] & lt)
                   + __popc(br[1] & lt);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int p = p0 + e;
                const int lo = los[e], hi = his[e], split = sps[e];
                const bool valid = p <= end;
                const bool li = (bl[e] >> lane) & 1u, ri = (br[e] >> lane) & 1u;
                if (valid && p == lo && hi > lo) {
                    const int lid = li ? off : (l - 1) + lo;
                    const int rid = ri ? off + (li ? 1 : 0) : (l - 1) + hi;
                    const int nd = __ldcg(g.node_at + lo);
                    g.lch[nd] = lid;
                    g.rch[nd] = rid;
                    g.nlo[nd] = lo;
                    g.nhi[nd] = hi;
                    if (li) g.node_at[lo] = lid;
                    if (ri) g.node_at[split + 1] = rid;
                }
                off += (li ? 1 : 0) + (ri ? 1 : 0);
                if (valid && hi > lo) {
                    int lo2, hi2;
                    move_to(p, lo, hi, split, lo2, hi2);
                    if (p <= split) shi[p - c0] = hi2; else slo[p - c0] = lo2;
                    if (p == lo2 && hi2 > lo2) keys_next[p] = ~0ull;
                    nl += hi2 > lo2 ? 1 : 0;
                }
            }
            const unsigned lv0 = __ballot_sync(VRT_FULL, nl > 0);
            const int cnt = __reduce_add_sync(VRT_FULL, (unsigned)nl);
            if (lane == 0 && lv0) {
                t.nlive[s] = 1;
                atomicAdd(&sh.i0, cnt);
            }
            warp_aggregates(g, t, s, p0, p0 <= end, p0 + 1 <= end);
        }
        __syncthreads();
        if (tid == 0) {
            for (int s = 0; s < ns; ++s) {
                if (t.live[s]) t.live[s] = t.nlive[s];
            }
            if (any) chunk_aggregates(g, t, c0, c1);
            if (sh.i0 > 0) atomicAdd(&g.live[d + 1], sh.i0);
        }
        next_free += total;
        ++d;
        grid.sync();
        const int left = *(volatile int*)&g.live[d];
        if (left == 0 || d >= VRT_MAX_LEVELS) break;
    }
    if (b == 0 && tid == 0) g.levels[0] = d;
}

// the chunk's range state (seg_lo, seg_hi, split) fits in shared memory
inline bool state_in_smem(int chunk, int nsub) {
    return dyn_bytes(nsub) + 12ull * chunk <= VRT_SMEM_MAX;
}

// the dynamic shared memory of a launch
inline size_t launch_bytes(int chunk, int nsub) {
    return dyn_bytes(nsub) + (state_in_smem(chunk, nsub) ? 12ull * chunk : 0);
}

// the blocks an SM holds with `dyn` bytes of shared memory
int blocks_per_sm(size_t dyn, int& out) {
    cudaError_t err = cudaFuncSetAttribute(
        sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, VRT_SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out, sweep_kernel, VRT_TILE, dyn);
    return (int)err;
}

}  // namespace

extern "C" const char* vrt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// The int32 scratch of a launch for l leaf boxes and `blocks` blocks, in
// words: the keys (2, l) u64, the tags (blocks,) u64, seg_lo, seg_hi,
// split, node_at (l,), the chunk aggregates (2, blocks, 6) float32, then
// the live counts (97,) and the level count, which
// vrt_sah_live_offset(l, blocks) words in are read together after the
// launch.
extern "C" long long vrt_sah_live_offset(int l, int blocks) {
    return 4LL * l + 2LL * blocks + 4LL * l + 12LL * blocks;
}

extern "C" long long vrt_sah_scratch(int l, int blocks) {
    return vrt_sah_live_offset(l, blocks) + (VRT_MAX_LEVELS + 1) + 1;
}

// The grid of the launch for l leaf boxes, or minus a CUDA error.
extern "C" int vrt_sah_blocks(int l) {
    int dev = 0, sms = 0, coop = 0, per_sm = 0, err = 0;
    if (l < 2) return -(int)cudaErrorInvalidValue;
    if ((err = (int)cudaGetDevice(&dev)) != 0) return -err;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (!coop) return -(int)cudaErrorNotSupported;
    int g = (int)(((long long)l + VRT_SUB - 1) / VRT_SUB);
    for (int it = 0; it < 8; ++it) {
        const int chunk = (int)(((long long)l + g - 1) / g);
        const int nsub = (chunk + VRT_SUB - 1) / VRT_SUB;
        if (dyn_bytes(nsub) > VRT_SMEM_MAX) return -(int)cudaErrorInvalidValue;
        if ((err = blocks_per_sm(launch_bytes(chunk, nsub), per_sm)) != 0) return -err;
        if (per_sm < 1) return -(int)cudaErrorCooperativeLaunchTooLarge;
        if (g <= per_sm * sms) return (int)(((long long)l + chunk - 1) / chunk);
        g = per_sm * sms;
    }
    return -(int)cudaErrorInvalidConfiguration;
}

// The sweep-SAH tree on `stream`, one cooperative launch of `blocks`
// blocks (vrt_sah_blocks(l)).  Inputs: lmin, lmax (l, 3) float32, the
// Morton-sorted leaf boxes.  Outputs, every word written: lch, rch, nlo,
// nhi (l-1,) int32 (an internal node the 96 levels do not reach stays 0),
// and in scratch (vrt_sah_scratch(l, blocks) int32, 8-byte aligned),
// vrt_sah_live_offset(l, blocks) words in, the positions in ranges longer
// than one at the start of each level (97,) and the levels run (1,).
// Returns 0 on success.
extern "C" int vrt_sah_sweep(const void* lmin, const void* lmax, int l, int blocks,
                             void* lch, void* rch, void* nlo, void* nhi, void* scratch,
                             void* stream) {
    if (l < 2 || blocks < 1) return (int)cudaErrorInvalidValue;
    Sweep g;
    g.lmin = (const float*)lmin;
    g.lmax = (const float*)lmax;
    g.l = l;
    g.chunk = (int)(((long long)l + blocks - 1) / blocks);
    g.nsub = (g.chunk + VRT_SUB - 1) / VRT_SUB;
    if ((long long)g.chunk * (blocks - 1) >= l) return (int)cudaErrorInvalidValue;
    if (((uintptr_t)scratch) & 7) return (int)cudaErrorInvalidValue;
    int* s = (int*)scratch;
    g.keys = (unsigned long long*)s;
    g.tags = g.keys + 2LL * l;
    g.seg_lo = (int*)(g.tags + blocks);
    g.seg_hi = g.seg_lo + l;
    g.split = g.seg_hi + l;
    g.node_at = g.split + l;
    g.bfa = (float*)(g.node_at + l);
    g.bba = g.bfa + 6LL * blocks;
    g.live = s + vrt_sah_live_offset(l, blocks);
    g.levels = g.live + VRT_MAX_LEVELS + 1;
    g.lch = (int*)lch;
    g.rch = (int*)rch;
    g.nlo = (int*)nlo;
    g.nhi = (int*)nhi;
    g.state_in_smem = state_in_smem(g.chunk, g.nsub);
    void* args[] = {&g};
    return (int)cudaLaunchCooperativeKernel((void*)sweep_kernel, blocks, VRT_TILE, args,
                                            launch_bytes(g.chunk, g.nsub),
                                            (cudaStream_t)stream);
}
