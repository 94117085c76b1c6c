// ploc_merge.cu — the whole PLOC merge loop on the card (kernel K4a).
//
// Replaces `_ploc_merge` of vortex_rt_tpu/accel/ploc.py (:89, XLA
// while_loop at :218).  There every round runs over all l positions as
// whole-array steps: radius shifted copies of the boxes for the window
// costs, two select chains for the nearest neighbour, scatters for the
// records and one stable argsort to compact the survivors.  Positions at
// or past the live count m never reach an output, so here a round runs
// over the m live clusters only.  A round:
//
// nearest neighbour: each live cluster scans `radius` neighbours forward
//   and backward for the smallest union half area, (e0*e1 + e1*e2) +
//   e2*e0 as the JAX package evaluates it.  Ties keep the smallest offset
//   (strictly smaller cost wins) and the backward neighbour is taken only
//   when strictly cheaper; a pair's cost is computed with the lower
//   position's box first, as the JAX costs are.
// mutual test: mutual nearest neighbours; the lower one merges, the
//   higher one is absorbed.  Any merge sets the round's flag.
// plan: with no mutual merge (cost ties) or from round 128 on, the
//   even/odd fallback pairs neighbours instead.  Then what each merge
//   does: two leaf clusters that fit one leaf join their lists, any other
//   merge writes the leaf rows of its leaf-cluster sides and makes an
//   internal node.  Three counts a position: leaf rows, internals,
//   survivors.
// write: leaf rows at k_leaf + their exclusive sum, internal records at
//   k_int + theirs (creation order, i before j), the merged cluster in the
//   lower position, and every survivor moved to its exclusive sum of
//   survivors: exactly the JAX stable argsort of the dead flags over the
//   live prefix.
//
// The rounds never come back to the host.  Two kernels:
//
// merge_grid_kernel (one cooperative launch, a persistent grid sized by
//   the occupancy calculator): the rounds while m > T.  Phases apart by
//   grid.sync(): (A) each block takes tiles of kTile positions, loads the
//   tile's boxes with 2 * radius more on each side into shared memory,
//   finds the nearest neighbour of the tile and of `radius` positions on
//   each side (so the mutual test needs no other block), and sums the
//   tile's three counts for both plans (mutual and fallback); (B) block 0
//   chooses the plan, scans the tile totals into tile offsets and writes
//   the next round's counters and the round log; (C) each tile scans its
//   counts with warp shuffles, adds its tile offset and writes.  The
//   cluster state (boxes, count, internal id, and the home of its id
//   list) is double-buffered by round parity; the id lists stay where
//   they started (a leaf merge appends j's list to i's in place), so a
//   survivor moves 36 B, not 36 + 4 * lmax.
// merge_tail_kernel (one block of 1024 threads): the rounds once m <= T,
//   with the cluster state and the id lists in shared memory and
//   __syncthreads() between phases.  A cluster holds 32 + 4 * lmax B of
//   state there (box, count, internal id, id list) and 12 B more (its
//   list's home, nearest neighbour, plan bits), so T = what one block's
//   227 KB hold (accel/ploc.py::tail_size).  Survivors move down in place,
//   a chunk of 1024 positions at a time (reads before the chunk's scan,
//   writes after it: a survivor's new position is never above its old).
//   It reads the live count and round from the card, and always runs:
//   it writes the final counters the host may read.
//
// All integers and exact min/max, and the cost in the JAX order with no
// FMA contraction (-fmad=false): the outputs equal the JAX package's word
// for word.  What bounds it: bytes — a round reads and writes each live
// cluster's state a few times, and a tile reads its boxes once into shared
// memory for the 2 * radius window scans.  At the ladder's meshes the
// bytes do not set the time: a grid round costs at least its three
// grid-wide barriers and a tile's chain of dependent loads and block scans
// (tools/merge_rounds.py times each phase).  Data that one block writes
// and another reads inside the launch is read with ld.global.cg (L2,
// coherent), never through the read-only path.
//
// Built by vortex_rt_tpu_torch/runtime/kernels.py with nvcc into a shared
// library with a plain C interface, loaded with ctypes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 256;        // positions of a grid-phase tile = its block's threads
constexpr int kTailThreads = 1024;
constexpr float kBig = 3e38f;     // the JAX package's "no neighbour" cost
constexpr int kFallbackRound = 128;

// mutual-test bits
constexpr int kMg = 1, kAbsorbed = 2;

// state words (accel/ploc.py mirrors them): rounds run, the any-merge flag
// by round parity, this round's fallback flag, the counters by round
// parity [live, internals, leaf rows, -], the final counters [live,
// internals, rounds, -], then the round log (the live count at the start
// of each round)
constexpr int kIt = 0, kAny = 1, kMode = 3, kCtr = 4, kFinal = 12, kLog = 16;
constexpr int cLive = 0, cInt = 1, cLeaf = 2;

struct Box {
    float mn[3], mx[3];
};

// half area of the union of a (the lower position) and b
__device__ __forceinline__ float union_cost(const Box& a, const Box& b) {
    float e[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) e[k] = fmaxf(fmaxf(a.mx[k], b.mx[k]) - fminf(a.mn[k], b.mn[k]), 0.0f);
    return (e[0] * e[1] + e[1] * e[2]) + e[2] * e[0];
}

__device__ __forceinline__ void join(Box& u, const Box& b) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        u.mn[k] = fminf(u.mn[k], b.mn[k]);
        u.mx[k] = fmaxf(u.mx[k], b.mx[k]);
    }
}

// the nearest neighbour of p among the m live positions; box_at(q) reads
// the box at position q
template <class BoxAt>
__device__ __forceinline__ int nearest(const BoxAt& box_at, int p, int m, int l, int radius) {
    const Box a = box_at(p);
    float f_cost = kBig;
    int f_off = 0;
    for (int o = 1; o <= radius && p + o < m; ++o) {  // past m: _BIG, never better
        const float c = union_cost(a, box_at(p + o));
        if (c < f_cost) {
            f_cost = c;
            f_off = o;
        }
    }
    float b_cost = kBig;
    int b_off = 0;
    for (int o = 1; o <= radius && p - o >= 0; ++o) {
        const float c = union_cost(box_at(p - o), a);
        if (c < b_cost) {
            b_cost = c;
            b_off = o;
        }
    }
    const int q = b_cost < f_cost ? p - b_off : p + f_off;
    return min(max(q, 0), l - 1);
}

// one cluster buffer in device memory
struct Clusters {
    float* cmin;  // (l, 3)
    float* cmax;
    int* cnt;     // (l,)
    int* nid;     // internal id, -1 for a leaf cluster
    int* home;    // row of its id list in `tids`
};

struct Records {
    int* lk;
    int* rk;
    int* lvl;
    float* bmn;
    float* bmx;
    int* row_tids;
    int* row_cnt;
};

struct Merge {
    Clusters buf[2];  // by round parity
    int* tids;        // (l, lmax) id lists by home, appended to in place
    int* nn;          // (l,) nearest neighbour of each live position
    int* code;        // (l,) mutual-test bits
    int* tile_tot;    // (tiles, 6) a tile's counts, mutual plan then fallback
    int* tile_off;    // (tiles, 3) the chosen plan's exclusive tile sums
    int* state;
    Records out;
    int l, lmax, radius, cap, tail;
};

// what one position does this round
struct Plan {
    int j;                        // the partner (p itself when not merging)
    bool mg, keep, stay, mk, need_i, need_j, i_leaf, j_leaf;
    int cnt_i, cnt_j, nid_i, nid_j, home_i, home_j;
    __device__ int rows() const { return (int)need_i + (int)need_j; }
};

// load(p) -> (cnt, nid, home) of position p
template <class Load>
__device__ __forceinline__ Plan make_plan(const Load& load, int p, int m, int l, int lmax,
                                          bool fallback, int q, int code) {
    Plan r;
    bool ab;
    if (fallback) {
        r.mg = (p % 2 == 0) && (p + 1 < m);
        ab = p % 2 == 1;
        q = min(p + 1, l - 1);
    } else {
        r.mg = code & kMg;
        ab = code & kAbsorbed;
    }
    r.keep = !ab;
    r.j = r.mg ? q : p;
    load(p, r.cnt_i, r.nid_i, r.home_i);
    if (r.mg) {
        load(r.j, r.cnt_j, r.nid_j, r.home_j);
    } else {
        r.cnt_j = r.cnt_i;
        r.nid_j = r.nid_i;
        r.home_j = r.home_i;
    }
    r.i_leaf = r.nid_i < 0;
    r.j_leaf = r.nid_j < 0;
    const int u_cnt = r.cnt_i + (r.mg ? r.cnt_j : 0);
    r.stay = r.mg && r.i_leaf && r.j_leaf && u_cnt <= lmax;
    r.mk = r.mg && !r.stay;
    r.need_i = r.mk && r.i_leaf;
    r.need_j = r.mk && r.j_leaf;
    return r;
}

// exclusive block-wide sums of N counts a thread (threads = NW warps);
// tot gets the block's totals.  s_warp: NW * N ints of shared memory
template <int NW, int N>
__device__ __forceinline__ void block_scan(const int (&v)[N], int (&ex)[N], int (&tot)[N],
                                           int* s_warp) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    int inc[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
        inc[k] = v[k];
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, inc[k], d);
            if (lane >= d) inc[k] += y;
        }
        if (lane == 31) s_warp[w * N + k] = inc[k];
    }
    __syncthreads();
    if (w == 0) {
#pragma unroll
        for (int k = 0; k < N; ++k) {
            int x = lane < NW ? s_warp[lane * N + k] : 0;
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const int y = __shfl_up_sync(0xffffffffu, x, d);
                if (lane >= d) x += y;
            }
            __syncwarp();
            if (lane < NW) s_warp[lane * N + k] = x;
        }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < N; ++k) {
        ex[k] = (w > 0 ? s_warp[(w - 1) * N + k] : 0) + inc[k] - v[k];
        tot[k] = s_warp[(NW - 1) * N + k];
    }
    __syncthreads();  // s_warp is reused by the next call
}

// the leaf rows and the internal record of one position's merge (leaf row
// r -> child (l-1)+r, internal k -> -(k+1)); tid_at(home, s) reads slot s
// of an id list
template <class TidAt>
__device__ __forceinline__ void write_records(const Records& out, const Plan& r, const Box& u,
                                              int row_i, int k, int l, int lmax, int it,
                                              const TidAt& tid_at) {
    const int row_j = row_i + (r.need_i ? 1 : 0);
    if (r.need_i) {
        for (int s = 0; s < lmax; ++s)
            out.row_tids[(long long)row_i * lmax + s] = tid_at(r.home_i, s);
        out.row_cnt[row_i] = r.cnt_i;
    }
    if (r.need_j) {
        for (int s = 0; s < lmax; ++s)
            out.row_tids[(long long)row_j * lmax + s] = tid_at(r.home_j, s);
        out.row_cnt[row_j] = r.cnt_j;
    }
    if (r.mk) {
        out.lk[k] = r.i_leaf ? (l - 1) + row_i : -(r.nid_i + 1);
        out.rk[k] = r.j_leaf ? (l - 1) + row_j : -(r.nid_j + 1);
        out.lvl[k] = it;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            out.bmn[3LL * k + a] = u.mn[a];
            out.bmx[3LL * k + a] = u.mx[a];
        }
    }
}

// ------------------------------------------------------------ grid phase

__device__ __forceinline__ Box ldcg_box(const Clusters& c, int p) {
    Box b;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        b.mn[k] = __ldcg(c.cmin + 3LL * p + k);
        b.mx[k] = __ldcg(c.cmax + 3LL * p + k);
    }
    return b;
}

__global__ void __launch_bounds__(kTile) merge_grid_kernel(Merge g) {
    cg::grid_group grid = cg::this_grid();
    extern __shared__ float s_dyn[];
    const int r = g.radius, span = kTile + 4 * r;  // boxes a tile loads
    float* s_box = s_dyn;                          // 6 arrays of span
    int* s_nn = (int*)(s_dyn + 6 * span);          // kTile + 2r
    __shared__ int s_warp[(kTile / 32) * 7];
    const int tid = threadIdx.x;
    int it = __ldcg(g.state + kIt);
    for (;;) {
        const int par = it & 1;
        const int* ctr = g.state + kCtr + 4 * par;
        const int m = __ldcg(ctr + cLive);
        if (m <= max(g.tail, 1) || it >= g.cap) break;
        const Clusters cur = g.buf[par], nxt = g.buf[par ^ 1];
        const int tiles = (m + kTile - 1) / kTile;
        auto load = [&](int p, int& cnt, int& nid, int& home) {
            cnt = __ldcg(cur.cnt + p);
            nid = __ldcg(cur.nid + p);
            home = __ldcg(cur.home + p);
        };

        // (A) nearest neighbours, mutual test, both plans' tile totals
        for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
            const int base = t * kTile, lo = base - 2 * r;
            for (int i = tid; i < span; i += kTile) {
                const int q = lo + i;
                if (q >= 0 && q < m) {
#pragma unroll
                    for (int k = 0; k < 3; ++k) {
                        s_box[k * span + i] = __ldcg(cur.cmin + 3LL * q + k);
                        s_box[(3 + k) * span + i] = __ldcg(cur.cmax + 3LL * q + k);
                    }
                }
            }
            __syncthreads();
            auto box_at = [&](int q) {
                Box b;
#pragma unroll
                for (int k = 0; k < 3; ++k) {
                    b.mn[k] = s_box[k * span + (q - lo)];
                    b.mx[k] = s_box[(3 + k) * span + (q - lo)];
                }
                return b;
            };
            for (int i = tid; i < kTile + 2 * r; i += kTile) {
                const int q = base - r + i;
                if (q >= 0 && q < m) s_nn[i] = nearest(box_at, q, m, g.l, r);
            }
            __syncthreads();
            const int p = base + tid;
            int v[7] = {0, 0, 0, 0, 0, 0, 0};
            if (p < m) {
                const int q = s_nn[tid + r];  // |q - p| <= r
                const bool mutual = q < m && s_nn[q - base + r] == p;
                const int c = mutual && q > p ? kMg : mutual && q < p ? kAbsorbed : 0;
                g.nn[p] = q;
                g.code[p] = c;
                const Plan a = make_plan(load, p, m, g.l, g.lmax, false, q, c);
                const Plan b = make_plan(load, p, m, g.l, g.lmax, true, q, c);
                v[0] = a.rows();
                v[1] = a.mk;
                v[2] = a.keep;
                v[3] = b.rows();
                v[4] = b.mk;
                v[5] = b.keep;
                v[6] = (c & kMg) ? 1 : 0;
            }
            int ex[7], tot[7];
            block_scan<kTile / 32, 7>(v, ex, tot, s_warp);
            if (tid == 0) {
#pragma unroll
                for (int k = 0; k < 6; ++k) g.tile_tot[6LL * t + k] = tot[k];
                if (tot[6] > 0) g.state[kAny + par] = 1;  // every writer writes 1
            }
        }
        grid.sync();

        // (B) block 0: the plan, tile offsets, next counters, the log
        if (blockIdx.x == 0) {
            const bool fallback = it >= kFallbackRound || __ldcg(g.state + kAny + par) == 0;
            const int mo = fallback ? 3 : 0;
            const int per = (tiles + kTile - 1) / kTile, t0 = tid * per;
            const int t1 = min(t0 + per, tiles);
            int v[3] = {0, 0, 0};
            for (int t = t0; t < t1; ++t)
#pragma unroll
                for (int k = 0; k < 3; ++k) v[k] += __ldcg(g.tile_tot + 6LL * t + mo + k);
            int ex[3], tot[3];
            block_scan<kTile / 32, 3>(v, ex, tot, s_warp);
            for (int t = t0; t < t1; ++t)
#pragma unroll
                for (int k = 0; k < 3; ++k) {
                    g.tile_off[3LL * t + k] = ex[k];
                    ex[k] += __ldcg(g.tile_tot + 6LL * t + mo + k);
                }
            if (tid == 0) {
                int* ctr_next = g.state + kCtr + 4 * (par ^ 1);
                ctr_next[cLive] = tot[2];
                ctr_next[cInt] = __ldcg(ctr + cInt) + tot[1];
                ctr_next[cLeaf] = __ldcg(ctr + cLeaf) + tot[0];
                g.state[kMode] = fallback ? 1 : 0;
                g.state[kAny + (par ^ 1)] = 0;
                g.state[kLog + it] = m;
                g.state[kIt] = it + 1;
            }
        }
        grid.sync();

        // (C) write: records, leaf rows, the survivors into the next buffer
        const bool fallback = __ldcg(g.state + kMode) != 0;
        const int k_int = __ldcg(ctr + cInt), k_leaf = __ldcg(ctr + cLeaf);
        for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
            const int p = t * kTile + tid;
            Plan a;
            int v[3] = {0, 0, 0};
            if (p < m) {
                a = make_plan(load, p, m, g.l, g.lmax, fallback, __ldcg(g.nn + p),
                              __ldcg(g.code + p));
                v[0] = a.rows();
                v[1] = a.mk;
                v[2] = a.keep;
            }
            int ex[3], tot[3];
            block_scan<kTile / 32, 3>(v, ex, tot, s_warp);
            if (p < m) {
#pragma unroll
                for (int k = 0; k < 3; ++k) ex[k] += __ldcg(g.tile_off + 3LL * t + k);
                Box u = ldcg_box(cur, p);
                if (a.mg) join(u, ldcg_box(cur, a.j));
                const int k = k_int + ex[1];
                write_records(g.out, a, u, k_leaf + ex[0], k, g.l, g.lmax, it,
                              [&](int home, int s) {
                                  return __ldcg(g.tids + (long long)home * g.lmax + s);
                              });
                if (a.keep) {
                    const int d = ex[2];
#pragma unroll
                    for (int c = 0; c < 3; ++c) {
                        nxt.cmin[3LL * d + c] = u.mn[c];
                        nxt.cmax[3LL * d + c] = u.mx[c];
                    }
                    nxt.cnt[d] = a.cnt_i + (a.mg ? a.cnt_j : 0);
                    nxt.nid[d] = a.mk ? k : a.nid_i;
                    nxt.home[d] = a.home_i;
                    if (a.stay) {  // j's list after i's, in i's home
                        for (int s = a.cnt_i; s < g.lmax; ++s)
                            g.tids[(long long)a.home_i * g.lmax + s] =
                                __ldcg(g.tids + (long long)a.home_j * g.lmax + (s - a.cnt_i));
                    }
                }
            }
        }
        grid.sync();
        ++it;
    }
}

// ------------------------------------------------------------ tail phase

// shared-memory layout of the tail: per position 6 box floats, count,
// internal id, home, nearest neighbour, plan bits (44 B), then the id
// lists by home (4 * lmax B a position)
constexpr int kTailWords = 11;

__global__ void __launch_bounds__(kTailThreads, 1) merge_tail_kernel(Merge g) {
    extern __shared__ float s_dyn[];
    const int T = g.tail, L = g.lmax, tid = threadIdx.x;
    float* s_mn = s_dyn;            // [3][T]
    float* s_mx = s_dyn + 3 * T;    // [3][T]
    int* s_cnt = (int*)(s_dyn + 6 * T);
    int* s_nid = s_cnt + T;
    int* s_home = s_nid + T;
    int* s_nn = s_home + T;
    int* s_code = s_nn + T;
    int* s_tids = s_code + T;       // [T][lmax] by home
    __shared__ int s_warp[(kTailThreads / 32) * 3];
    __shared__ int s_any;

    int it = g.state[kIt];
    const int* ctr = g.state + kCtr + 4 * (it & 1);
    int m = ctr[cLive], k_int = ctr[cInt], k_leaf = ctr[cLeaf];
    if (m > 1 && it < g.cap) {
        const Clusters cur = g.buf[it & 1];
        for (int p = tid; p < m; p += kTailThreads) {
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                s_mn[k * T + p] = cur.cmin[3LL * p + k];
                s_mx[k * T + p] = cur.cmax[3LL * p + k];
            }
            s_cnt[p] = cur.cnt[p];
            s_nid[p] = cur.nid[p];
            s_home[p] = p;
            const int h = cur.home[p];
            for (int s = 0; s < L; ++s) s_tids[p * L + s] = g.tids[(long long)h * L + s];
        }
    }
    __syncthreads();
    auto box_at = [&](int q) {
        Box b;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            b.mn[k] = s_mn[k * T + q];
            b.mx[k] = s_mx[k * T + q];
        }
        return b;
    };
    auto load = [&](int p, int& cnt, int& nid, int& home) {
        cnt = s_cnt[p];
        nid = s_nid[p];
        home = s_home[p];
    };
    while (m > 1 && it < g.cap) {
        if (tid == 0) {
            g.state[kLog + it] = m;
            s_any = 0;
        }
        for (int p = tid; p < m; p += kTailThreads) s_nn[p] = nearest(box_at, p, m, g.l, g.radius);
        __syncthreads();
        for (int p = tid; p < m; p += kTailThreads) {
            const int q = s_nn[p];
            const bool mutual = q < m && s_nn[q] == p;
            const int c = mutual && q > p ? kMg : mutual && q < p ? kAbsorbed : 0;
            s_code[p] = c;
            if (c & kMg) s_any = 1;
        }
        __syncthreads();
        const bool fallback = it >= kFallbackRound || s_any == 0;
        int carry[3] = {0, 0, 0};
        for (int base = 0; base < m; base += kTailThreads) {
            const int p = base + tid;
            Plan a;
            Box u;
            int v[3] = {0, 0, 0};
            if (p < m) {  // every read of this chunk's state before its scan
                a = make_plan(load, p, m, g.l, L, fallback, s_nn[p], s_code[p]);
                u = box_at(p);
                if (a.mg) join(u, box_at(a.j));
                v[0] = a.rows();
                v[1] = a.mk;
                v[2] = a.keep;
            }
            int ex[3], tot[3];
            block_scan<kTailThreads / 32, 3>(v, ex, tot, s_warp);
            if (p < m) {
                const int k = k_int + carry[1] + ex[1];
                write_records(g.out, a, u, k_leaf + carry[0] + ex[0], k, g.l, L, it,
                              [&](int home, int s) { return s_tids[home * L + s]; });
                if (a.keep) {  // d <= p: below every later chunk's reads
                    const int d = carry[2] + ex[2];
#pragma unroll
                    for (int c = 0; c < 3; ++c) {
                        s_mn[c * T + d] = u.mn[c];
                        s_mx[c * T + d] = u.mx[c];
                    }
                    s_cnt[d] = a.cnt_i + (a.mg ? a.cnt_j : 0);
                    s_nid[d] = a.mk ? k : a.nid_i;
                    s_home[d] = a.home_i;
                    if (a.stay) {
                        for (int s = a.cnt_i; s < L; ++s)
                            s_tids[a.home_i * L + s] = s_tids[a.home_j * L + (s - a.cnt_i)];
                    }
                }
            }
#pragma unroll
            for (int k = 0; k < 3; ++k) carry[k] += tot[k];
        }
        m = carry[2];
        k_int += carry[1];
        k_leaf += carry[0];
        ++it;
        __syncthreads();
    }
    if (tid == 0) {
        g.state[kIt] = it;
        g.state[kFinal + 0] = m;
        g.state[kFinal + 1] = k_int;
        g.state[kFinal + 2] = it;
    }
}

size_t grid_smem(int radius) {
    return sizeof(float) * (6 * (kTile + 4 * (size_t)radius) + kTile + 2 * (size_t)radius);
}

}  // namespace

extern "C" const char* vrt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// The merge loop on `stream`: merge_grid_kernel (a cooperative launch)
// while more than `tail` clusters live, when m0 > tail, then
// merge_tail_kernel.  `work` (int32 words) holds, in this order: two
// cluster buffers of cmin (l, 3) float, cmax (l, 3) float, cnt, nid, home
// (l,) — buffer 0 filled by the caller with the m0 start clusters (count
// 1, internal id -1, home = position) —; the id lists tids (l, lmax) by
// home; nn, code (l,); tile totals (tiles, 6) and offsets (tiles, 3),
// tiles = ceil(l / 256).  state (16 + cap,) int32: zeros but the first
// counters [m0, 0, 0] at word 4.  Records (creation order): lk, rk, lvl
// (l-1,) int32, bmn, bmx (l-1, 3) float32; leaf rows row_tids (l, lmax),
// row_cnt (l,); the caller fills the words no round writes.  `tail`
// clusters must fit one block's shared memory (tail * (44 + 4 * lmax)
// B); a refused launch (the cooperative grid among them) returns its
// error.  Returns 0 on success.
extern "C" int vrt_ploc_merge(void* work, void* state, void* lk, void* rk, void* lvl, void* bmn,
                              void* bmx, void* row_tids, void* row_cnt, int m0, int l, int lmax,
                              int radius, int cap, int tail, void* stream) {
    if (l < 2 || m0 < 1 || m0 > l || lmax < 1 || radius < 1 || cap < 0 || tail < 2)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    Merge g;
    int* w = (int*)work;
    const long long L = l;
    for (int b = 0; b < 2; ++b) {
        g.buf[b] = Clusters{(float*)w, (float*)(w + 3 * L), w + 6 * L, w + 7 * L, w + 8 * L};
        w += 9 * L;
    }
    g.tids = w;
    w += L * lmax;
    g.nn = w;
    g.code = w + L;
    w += 2 * L;
    const long long tiles = (L + kTile - 1) / kTile;
    g.tile_tot = w;
    g.tile_off = w + 6 * tiles;
    g.state = (int*)state;
    g.out = Records{(int*)lk, (int*)rk, (int*)lvl, (float*)bmn, (float*)bmx, (int*)row_tids,
                    (int*)row_cnt};
    g.l = l;
    g.lmax = lmax;
    g.radius = radius;
    g.cap = cap;
    g.tail = tail;
    cudaError_t err;
    if (m0 > tail) {
        int dev = 0, sms = 0, coop = 0, per_sm = 0;
        if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
        if (!coop) return (int)cudaErrorNotSupported;
        const size_t smem = grid_smem(radius);
        if ((err = cudaFuncSetAttribute(merge_grid_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)smem)) != cudaSuccess)
            return (int)err;
        if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, merge_grid_kernel, kTile,
                                                                 smem)) != cudaSuccess)
            return (int)err;
        if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
        // no more blocks than the first round has tiles
        const long long most = (long long)per_sm * sms, first = ((long long)m0 + kTile - 1) / kTile;
        const int blocks = (int)(first < most ? first : most);
        void* args[] = {&g};
        if ((err = cudaLaunchCooperativeKernel((void*)merge_grid_kernel, blocks, kTile, args,
                                               smem, s)) != cudaSuccess)
            return (int)err;
    }
    const size_t tsmem = sizeof(int) * (size_t)tail * (kTailWords + lmax);
    if ((err = cudaFuncSetAttribute(merge_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)tsmem)) != cudaSuccess)
        return (int)err;
    merge_tail_kernel<<<1, kTailThreads, tsmem, s>>>(g);
    return (int)cudaGetLastError();
}
