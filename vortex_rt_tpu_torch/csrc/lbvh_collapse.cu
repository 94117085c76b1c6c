// lbvh_collapse.cu — subtree cut and depth-stride collapse of the binary
// LBVH tree (Karras or sweep-SAH) to 4- or 8-wide nodes, with the refit
// kernel's plan, in one launch (kernel B of K5).
//
// Replaces `_collapse_wide` of vortex_rt_tpu/accel/lbvh.py (:326), which
// finds node depths with a fixed-point sweep over whole arrays (loop at
// :361), builds the child lists with stacked selects and numbers the wide
// children and the leaf rows with two prefix sums.  It also makes what
// csrc/lbvh_refit.cu needs of a topology (its plan: accel/lbvh.py's
// RefitPlan, whose plain version is `_refit_plan`), so a build's first
// refit is one launch like every later one.
//
// What bounds it: not its bytes (about 100 B a node at width 8, plan
// included) but its steps: the depth walks' chains of dependent loads,
// and three counts numbered in order (survivor arities, leaf rows,
// treelet starts).  Enqueued from the host as kernels around prefix sums,
// fills and a search, a build paid for every operation at the host's
// pace.  Here one cooperative, persistent launch (a grid sized by the
// occupancy calculator) does it all, with grid.sync() between four phases.
// The items are numbered in three orders: internals (l-1), nodes (2l-1:
// internals, then sorted leaves) and sorted positions (l).  A block owns a
// contiguous run of 256-item chunks in each, so it can number its items
// in order after summing the counts of the blocks before it.
//
// Treelets are the refit plan's: the maximal subtrees of at most `cap`
// leaves (cap = the refit's tile / 2).  Leaves p-1 and p lie in one
// treelet exactly when their lowest common ancestor, the internal whose
// split gap (last sorted position of its left child) is p-1, has at most
// `cap` leaves; so position p starts a treelet when that internal is
// larger (and position 0 always does).
//
// 1. parents: internal x writes itself as the parent of its two children
//    (the root keeps 0), and as their treelet parent when it has at most
//    `cap` leaves (-1 otherwise); the treelet-start flag at its split gap
//    + 1; its climb counter 0.
// 2. depths: a small internal (at most `cap` leaves) walks its treelet
//    parents to its treelet's root (the depth below it, one dependent load
//    a level); a treelet's root, and an internal above the treelets, walk
//    their parents on to the tree's root (a thread's walks kWalks at a
//    time, their loads in flight together).  A treelet's root (internal or
//    leaf) writes its id at its first leaf, and the first start at or
//    after each multiple of `cap` its range reaches (the refit's block
//    windows).  Each block counts its maximal leafish nodes and its
//    treelet starts.
// 3. per internal: the binary depth (the depth below the treelet's root
//    plus the root's), the cut (a node of at most max_leaf triangles is
//    leafish), survival at depth % 2 == 0 (width 4) or % 3 == 0 (width
//    8), the descendants two (three) levels down clipped at the cut
//    (ch_old, arity), the plan's record at its split gap and its block
//    start (gstart); each block counts its survivors' arities.  Per node:
//    its leaf row (first sorted slot, count) when it is a maximal leafish
//    node, numbered in node-id order.  Per position: its treelet's row
//    (root, slot) when a treelet starts there, numbered in position order,
//    and at every multiple of `cap` the refit's block table.
// 4. numbering: base = 1 + the exclusive prefix sum of the survivors'
//    arities; the thread of survivor i gives child ch_old[i][t] its new id
//    base[i] + t, and when that child is a leaf row, the row's new id.
//
// Each block sums the counts of the blocks before it itself (no block
// scans for the others: no fourth barrier).  Every output word is written
// by exactly one thread: the defaults (-1 or 0) of a word no numbering
// reaches by the thread that owns it, once the counts are known.  All
// integers: the topology equals the JAX package's field for field, and
// the plan `_refit_plan`'s word for word.  A word written in an earlier
// phase is read with a plain load after the grid barrier, whose fence
// makes it visible: through L1, where the walks' shared ancestors and
// neighbouring nodes hit (read from L2 with ld.global.cg, the walks took
// 7x longer at config 5's mesh: tools/collapse_phases.py); never through
// the read-only path, which the tree's own arrays take.
//
// Built by vortex_rt_tpu_torch/runtime/kernels.py with nvcc into a shared
// library with a plain C interface, loaded with ctypes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBlock = 256;
constexpr int kWalks = 4;             // a thread's depth walks in flight together
constexpr int kMaxSteps = 1 << 12;    // a walk's bound (a tree is far shallower)
constexpr int kTop = (int)0x80000000;  // a record's bit: above the treelets
constexpr int kLeafRef = 1 << 10;     // a record's child slot that is a leaf

struct Collapse {
    const int *lchild, *rchild, *lo, *hi;  // the binary tree (l-1,)
    int l, max_leaf, cap;
    // the topology
    int* parent;
    unsigned char* surv;
    int *ch_old, *arity, *base, *newid, *row_lo, *row_cnt, *leaf_newid;
    long long* num_leaves;
    // the refit plan
    int *rec, *blocks, *roots, *gstart, *arrived;
    // scratch: by internal its words (lchild, rchild, lo, hi) in one
    // vector; by internal (its treelet's root, its depth below it), or
    // for a treelet's root and an internal above the treelets (itself, its
    // binary depth); the treelet-start flags by position; the treelet
    // parents by node; the root of the treelet starting at a position; the
    // first start of each block window; the leaf row of each maximal node;
    // by internal, which of its wide children are leaf rows (bits); three
    // counts a block
    int4* tree;
    int2* aux;
    int *tpar, *root_at, *wmin, *row_of, *totals;
    unsigned char *start, *leaves;
};

// the chunks [c0, c1) of a block in an order of n items
struct Run {
    int c0, c1;
    __device__ Run(long long n) {
        const int chunks = (int)((n + kBlock - 1) / kBlock);
        const int per = (chunks + gridDim.x - 1) / gridDim.x;
        c0 = min(blockIdx.x * per, chunks);
        c1 = min(c0 + per, chunks);
    }
};

__device__ __forceinline__ int size_of(const Collapse& g, int x) {
    return x >= g.l - 1 ? 1 : __ldg(g.hi + x) - __ldg(g.lo + x) + 1;
}
__device__ __forceinline__ bool leafish(const Collapse& g, int x) {
    return size_of(g, x) <= g.max_leaf;
}
// a node of at most `cap` leaves: a treelet's node
__device__ __forceinline__ bool small(const Collapse& g, int x) { return size_of(g, x) <= g.cap; }
// the last sorted position of node c (a leaf's is its own)
__device__ __forceinline__ int end_of(const Collapse& g, int c) {
    return c >= g.l - 1 ? c - (g.l - 1) : __ldg(g.hi + c);
}
// the tree's words of node c (children, leaf range) from phase 1's copy, a
// vector load; read whether or not c is an internal (a leaf reads internal
// 0's, unused), so that the loads of a level of the expansion are
// in flight together
struct Node {
    int l, r, lo, hi;
};
__device__ __forceinline__ Node node(const Collapse& g, int c) {
    const int4 v = g.tree[c < g.l - 1 ? c : 0];
    return {v.x, v.y, v.z, v.w};
}
// node c (its words nd) becomes a wide leaf (triangle leaf or cut subtree)
__device__ __forceinline__ bool is_lf(const Collapse& g, int c, const Node& nd) {
    return c >= g.l - 1 || nd.hi - nd.lo + 1 <= g.max_leaf;
}
__device__ __forceinline__ bool lf_at(const Collapse& g, int c) { return is_lf(g, c, node(g, c)); }
// node x becomes a leaf row: maximal leafish (a triangle directly under
// the cut included); from phase 2 on
__device__ __forceinline__ bool is_max(const Collapse& g, int x) {
    const int p = g.parent[x];
    return (x >= g.l - 1 || leafish(g, x)) && !lf_at(g, p);
}
// A list of at most N node ids in registers (static indices only): ids
// v[0, n), -1 after; bit t of f set when v[t] is a wide leaf.
template <int N>
struct List {
    int v[N];
    unsigned f;
    int n;
};
// node c alone (flag lf), as a list of N
template <int N>
__device__ __forceinline__ List<N> one(int c, bool lf) {
    List<N> o;
#pragma unroll
    for (int t = 0; t < N; ++t) o.v[t] = t == 0 ? c : -1;
    o.f = lf;
    o.n = 1;
    return o;
}
// a, then b
template <int A, int B>
__device__ __forceinline__ List<A + B> cat(const List<A>& a, const List<B>& b) {
    List<A + B> o;
    o.f = a.f | b.f << a.n;
    o.n = a.n + b.n;
#pragma unroll
    for (int t = 0; t < A + B; ++t) {
        int v = -1;
#pragma unroll
        for (int u = 0; u < A; ++u) v = u == t && u < a.n ? a.v[u] : v;
#pragma unroll
        for (int u = 0; u < B; ++u) v = a.n + u == t && u < b.n ? b.v[u] : v;
        o.v[t] = v;
    }
    return o;
}
template <int N>
__device__ __forceinline__ List<N> pick(bool p, const List<N>& a, const List<N>& b) {
    return p ? a : b;
}
// the list into the row (16-byte vectors) and its flags -> its count
template <int N>
__device__ __forceinline__ int put(const List<N>& a, int* row, int* leaves) {
#pragma unroll
    for (int k = 0; k < N; k += 4) *(int4*)(row + k) = make_int4(a.v[k], a.v[k + 1], a.v[k + 2], a.v[k + 3]);
    *leaves = a.f;
    return a.n;
}

// The descendants of internal x (its words nx) two (W 4) or three (W 8)
// levels down, clipped at the cut, into the row out[0, W) (-1 padded,
// written as 16-byte vectors) -> their count; bit t of *leaves set when
// child t is a wide leaf (a leaf row).  Every level's words are read,
// leaf or not, before the next is chosen; the list is assembled in
// registers.
template <int W>
__device__ __forceinline__ int expand(const Collapse& g, const Node& nx, int* row, int* leaves) {
    const int c1[2] = {nx.l, nx.r};
    const Node n1[2] = {node(g, c1[0]), node(g, c1[1])};
    const int c2[4] = {n1[0].l, n1[0].r, n1[1].l, n1[1].r};
    if constexpr (W == 4) {
        const bool f2[4] = {lf_at(g, c2[0]), lf_at(g, c2[1]), lf_at(g, c2[2]), lf_at(g, c2[3])};
        List<2> h[2];
#pragma unroll
        for (int s = 0; s < 2; ++s)
            h[s] = pick(is_lf(g, c1[s], n1[s]), one<2>(c1[s], true),
                        cat(one<1>(c2[2 * s], f2[2 * s]), one<1>(c2[2 * s + 1], f2[2 * s + 1])));
        return put(cat(h[0], h[1]), row, leaves);
    } else {
        const Node n2[4] = {node(g, c2[0]), node(g, c2[1]), node(g, c2[2]), node(g, c2[3])};
        List<2> q[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
            q[k] = pick(is_lf(g, c2[k], n2[k]), one<2>(c2[k], true),
                        cat(one<1>(n2[k].l, lf_at(g, n2[k].l)), one<1>(n2[k].r, lf_at(g, n2[k].r))));
        List<4> h[2];
#pragma unroll
        for (int s = 0; s < 2; ++s)
            h[s] = pick(is_lf(g, c1[s], n1[s]), one<4>(c1[s], true), cat(q[2 * s], q[2 * s + 1]));
        return put(cat(h[0], h[1]), row, leaves);
    }
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

// the sum of count k of the blocks before this one, and of all blocks
__device__ __forceinline__ int offset(const Collapse& g, int k, int& all, int* s_warp) {
    int before = 0, sum = 0;
    for (int b = threadIdx.x; b < gridDim.x; b += kBlock) {
        const int v = __ldcg(g.totals + k * gridDim.x + b);
        sum += v;
        if (b < blockIdx.x) before += v;
    }
    all = block_sum(sum, s_warp);
    return block_sum(before, s_warp);
}

// (40 registers, six blocks an SM: measured faster than 64 registers and
// four, or 32 and eight with their spills; tools/collapse_phases.py)
template <int W>
__global__ void __launch_bounds__(kBlock, 6) collapse_kernel(Collapse g) {
    cg::grid_group grid = cg::this_grid();
    __shared__ int s_warp[kBlock / 32];
    const int l = g.l, n = l - 1, cap = g.cap;
    const long long nodes = 2LL * l - 1;
    const int gtid = blockIdx.x * kBlock + threadIdx.x, stride = gridDim.x * kBlock;
    const Run ra(n), rb(nodes), rc(l);

    // 1. parents, treelet parents, the treelet-start flags, the counters
#pragma unroll 4
    for (int x = gtid; x < n; x += stride) {
        const int lc = __ldg(g.lchild + x), rc_ = __ldg(g.rchild + x);
        const int tp = small(g, x) ? x : -1;
        g.tree[x] = make_int4(lc, rc_, __ldg(g.lo + x), __ldg(g.hi + x));
        g.parent[lc] = x;
        g.parent[rc_] = x;
        g.tpar[lc] = tp;
        g.tpar[rc_] = tp;
        g.start[end_of(g, lc) + 1] = tp < 0;
        g.arrived[x] = 0;
        if (x == 0) {
            g.parent[0] = 0;
            g.tpar[0] = -1;
            g.start[0] = 1;
        }
    }
    grid.sync();

    // 2. the depth walks over the block's internals, kWalks chunks at a
    // time: a small node up its treelet (mode 0), a treelet's root or a
    // large node up to the tree's root (mode 1)
    for (int cb = ra.c0; cb < ra.c1; cb += kWalks) {
        int x[kWalks], p[kWalks], d[kWalks], mode[kWalks];
#pragma unroll
        for (int k = 0; k < kWalks; ++k) {
            x[k] = (cb + k) * kBlock + threadIdx.x;
            if (cb + k >= ra.c1 || x[k] >= n) x[k] = -1;
            p[k] = x[k];
            d[k] = 0;
            mode[k] = x[k] < 0 ? 2 : small(g, x[k]) ? 0 : 1;  // (2: done)
        }
        bool walking = true;
        while (walking) {
            walking = false;
#pragma unroll
            for (int k = 0; k < kWalks; ++k) {
                if (mode[k] == 0) {
                    const int q = d[k] > kMaxSteps ? -1 : g.tpar[p[k]];
                    if (q >= 0) {
                        p[k] = q;
                        ++d[k];
                    } else {
                        mode[k] = p[k] == x[k] ? 1 : 2;  // a root walks on
                    }
                } else if (mode[k] == 1) {
                    if (p[k] == 0 || d[k] > kMaxSteps) {
                        mode[k] = 2;
                    } else {
                        p[k] = g.parent[p[k]];
                        ++d[k];
                    }
                }
                walking |= mode[k] != 2;
            }
        }
#pragma unroll
        for (int k = 0; k < kWalks; ++k) {
            if (x[k] < 0) continue;
            const bool root = small(g, x[k]) && g.tpar[x[k]] < 0;
            // (treelet root, depth below it), or (self, binary depth)
            g.aux[x[k]] = make_int2(small(g, x[k]) && !root ? p[k] : x[k], d[k]);
            if (!root) continue;
            const int lo = __ldg(g.lo + x[k]), hi = __ldg(g.hi + x[k]);
            g.root_at[lo] = x[k];
            if (lo % cap == 0) g.wmin[lo / cap] = lo;
            const int m = (lo / cap + 1) * cap;  // the window its range reaches
            if (m <= hi) g.wmin[m / cap] = hi + 1;
        }
    }
    // the counts of the block's leaf rows and treelet starts; the flags of
    // its first 32 chunks kept in registers for phase 3 (bit c - c0)
    int n_max = 0, n_start = 0;
    unsigned max_bits = 0, start_bits = 0;
#pragma unroll 4
    for (int c = rb.c0; c < rb.c1; ++c) {
        const int i = c * kBlock + threadIdx.x;
        const bool m = i < nodes && is_max(g, i);
        max_bits |= c - rb.c0 < 32 ? (unsigned)m << (c - rb.c0) : 0u;
        n_max += m;
    }
#pragma unroll 4
    for (int c = rc.c0; c < rc.c1; ++c) {
        const int j = c * kBlock + threadIdx.x;
        const bool st = j < l && g.start[j];
        start_bits |= c - rc.c0 < 32 ? (unsigned)st << (c - rc.c0) : 0u;
        n_start += st;
    }
    for (int c = rc.c0; c < rc.c1; ++c) {
        const int j = c * kBlock + threadIdx.x;
        if (j < l && g.tpar[n + j] < 0) {  // a leaf that is a treelet's root
            g.root_at[j] = n + j;
            if (j % cap == 0) g.wmin[j / cap] = j;
        }
    }
    n_max = block_sum(n_max, s_warp);
    n_start = block_sum(n_start, s_warp);
    if (threadIdx.x == 0) {
        g.totals[gridDim.x + blockIdx.x] = n_max;
        g.totals[2 * gridDim.x + blockIdx.x] = n_start;
    }
    grid.sync();

    // 3a. per internal: depth, cut, expansion, the plan's record.  (Every
    // load comes before the first store, three levels of them, so the
    // chains of one internal overlap: a store may alias a later plain
    // load.)
    const int stride_d = W == 4 ? 2 : 3;
    int sum = 0;
    unsigned contrib_bits = 0;  // survivor arities of the first 8 chunks, 4 bits each
    for (int c = ra.c0; c < ra.c1; ++c) {
        const int x = c * kBlock + threadIdx.x;
        if (x >= n) continue;
        const int2 a = g.aux[x];  // (this thread's own, from phase 2)
        const int px = g.parent[x];
        const Node nx = node(g, x);
        const bool sm = nx.hi - nx.lo < cap;
        const bool inner = sm && a.x != x;  // in a treelet, below its root
        const int depth = inner ? a.y + g.aux[a.x].y : a.y;
        const int t0 = sm ? g.wmin[(inner ? __ldg(g.lo + a.x) : nx.lo) / cap] : 0;
        const bool lf = nx.hi - nx.lo + 1 <= g.max_leaf;
        const bool mx = lf && !lf_at(g, px);
        const bool sv = !lf && depth % stride_d == 0;
        const long long q = end_of(g, nx.l);
        const int sl = nx.l >= n ? (nx.l - n - t0) | kLeafRef : end_of(g, node(g, nx.l).l) - t0;
        const int sr = nx.r >= n ? (nx.r - n - t0) | kLeafRef : end_of(g, node(g, nx.r).l) - t0;
        int leaves;
        const int ar = expand<W>(g, nx, g.ch_old + (long long)x * W, &leaves);
        g.leaves[x] = leaves;
        g.surv[x] = sv ? 1 : 0;
        g.arity[x] = ar;
        sum += sv ? ar : 0;
        contrib_bits |= c - ra.c0 < 8 && sv ? (unsigned)ar << 4 * (c - ra.c0) : 0u;
        // (its new id, when no survivor gives it one)
        if (x == 0)
            g.newid[0] = 0;
        else if (!sv && !mx)
            g.newid[x] = -1;
        // the plan: the record at the split gap; the block start of a
        // treelet's root
        if (!sm) {
            *(int2*)(g.rec + 2 * q) = make_int2(x | kTop, 0);
            g.gstart[x] = -1;
        } else {
            *(int2*)(g.rec + 2 * q) = make_int2(x, sl | sr << 11 | (inner ? a.y : 0) << 22);
            g.gstart[x] = inner ? -1 : t0;
        }
    }
    sum = block_sum(sum, s_warp);
    if (threadIdx.x == 0) g.totals[blockIdx.x] = sum;

    // 3b. per node: the leaf rows, numbered in node-id order
    int rows;
    int row = offset(g, 1, rows, s_warp);
    for (int c = rb.c0; c < rb.c1; ++c) {
        const int i = c * kBlock + threadIdx.x;
        const bool m = c - rb.c0 < 32 ? max_bits >> (c - rb.c0) & 1 : i < nodes && is_max(g, i);
        int run;
        const int r = row + block_scan(m, run, s_warp);
        if (m) {
            g.row_lo[r] = i < n ? __ldg(g.lo + i) : i - n;
            g.row_cnt[r] = size_of(g, i);
            g.row_of[i] = r;
        }
        if (i >= rows && i < l) {  // a row no node takes
            g.row_lo[i] = 0;
            g.row_cnt[i] = 0;
            g.leaf_newid[i] = -1;
        }
        if (i >= n && i < nodes && !m) g.newid[i] = -1;
        row += run;
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) *g.num_leaves = rows;

    // 3c. per position: the treelets' rows, numbered in position order,
    // and the refit's blocks (block k takes the treelets that start in
    // [k cap, (k+1) cap): its first leaf is the first start at or after
    // k cap, its first row the count of starts before k cap)
    int n_rows;
    int rank = offset(g, 2, n_rows, s_warp);
    const int nb = (l + cap - 1) / cap;
    for (int c = rc.c0; c < rc.c1; ++c) {
        const int p = c * kBlock + threadIdx.x;
        const bool st = c - rc.c0 < 32 ? start_bits >> (c - rc.c0) & 1 : p < l && g.start[p];
        const int root = st ? g.root_at[p] : 0;
        const int t0 = p < l ? g.wmin[p / cap] : 0;
        int run;
        const int r = rank + block_scan(st, run, s_warp);
        if (st) {
            g.roots[2 * r] = root;
            g.roots[2 * r + 1] = root >= n ? (p - t0) | kLeafRef : end_of(g, __ldg(g.lchild + root)) - t0;
        }
        if (p >= n_rows && p < l) {  // a row no treelet takes
            g.roots[2 * p] = -1;
            g.roots[2 * p + 1] = -1;
        }
        if (p < l && p % cap == 0) {
            const int k = p / cap, first = t0;
            g.blocks[4 * k] = first;
            g.blocks[4 * k + 2] = r;
            if (k > 0) {
                g.blocks[4 * (k - 1) + 1] = first - 1;
                g.blocks[4 * (k - 1) + 3] = r;
            }
            if (k == nb - 1) {
                g.blocks[4 * k + 1] = l - 1;
                g.blocks[4 * k + 3] = n_rows;
            }
        }
        rank += run;
    }
    grid.sync();

    // 4. the block's offset, base, and the new ids of the survivors'
    // children and of their leaf rows (the survivors' arities kept in
    // registers from phase 3; their rows read back)
    int all;
    int off = 1 + offset(g, 0, all, s_warp);
    for (int c = ra.c0; c < ra.c1; ++c) {
        const int x = c * kBlock + threadIdx.x;
        const bool in = x < n;
        // (a survivor has two children or more)
        const int ar = c - ra.c0 < 8 ? contrib_bits >> 4 * (c - ra.c0) & 15
                                     : in && g.surv[x] ? g.arity[x] : 0;
        const bool sv = ar > 0;
        int run;
        const int ex = block_scan(ar, run, s_warp);
        if (sv) {
            // the children and their leaf rows read first, then written
            int ch[W], row[W];
            const int leaves = g.leaves[x];
#pragma unroll
            for (int t = 0; t < W; t += 4) {
                const int4 v = *(const int4*)(g.ch_old + (long long)x * W + t);
                ch[t] = v.x;
                ch[t + 1] = v.y;
                ch[t + 2] = v.z;
                ch[t + 3] = v.w;
            }
#pragma unroll
            for (int t = 0; t < W; ++t) row[t] = leaves >> t & 1 ? g.row_of[ch[t]] : -1;
#pragma unroll
            for (int t = 0; t < W; ++t) {
                if (t >= ar) break;
                g.newid[ch[t]] = off + ex + t;
                if (row[t] >= 0) g.leaf_newid[row[t]] = off + ex + t;
            }
        }
        if (in) g.base[x] = off + ex;
        off += run;
    }
}

// the grid the card holds at once, by device and width (asked once)
template <int W>
int most_blocks(int& out) {
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
        if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, collapse_kernel<W>,
                                                                 kBlock, 0)) != cudaSuccess)
            return (int)err;
        if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
        most_by_dev[dev] = per_sm * sms;
    }
    out = most_by_dev[dev];
    return 0;
}

// blocks of the launch: no more than chunks of nodes (the size of `totals`)
inline int node_chunks(int l) { return (int)((2LL * l - 1 + kBlock - 1) / kBlock); }

}  // namespace

extern "C" const char* vrt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// Words of int32 scratch the launch takes for l leaves and treelets of at
// most `cap` leaves.
extern "C" long long vrt_lbvh_collapse_scratch(int l, int cap) {
    const long long n = l - 1, nb = (l + cap - 1) / cap;
    // (the tree, aux, tpar, root_at, wmin, row_of, totals; then the start
    // flags and the leaf-row bits in bytes)
    return 4 * n + 2 * n + (2LL * l - 1) + l + nb + (2LL * l - 1) + 3LL * node_chunks(l) +
           (l + n + 3) / 4;
}

// The collapse and the refit plan on `stream`, one cooperative launch.
// Inputs: lchild, rchild, lo, hi (l-1,) int32, the binary tree over l
// sorted leaves (old ids: internal k in [0, l-1), leaf j at (l-1)+j);
// max_leaf, the most triangles of a wide leaf; width 4 or 8; cap, the
// most leaves of a treelet (at most 1,024: a record's slots are 10 bits).
// Outputs, every word written: parent (2l-1,), surv (l-1,) bytes 0/1,
// ch_old (l-1, width), arity, base (l-1,), newid (2l-1,), row_lo,
// row_cnt, leaf_newid (l,) int32, num_leaves one int64 (the leaf rows in
// use); the plan: rec (l-1, 2), blocks (ceil(l / cap), 4), roots (l, 2),
// gstart and arrived (l-1,) int32.  scratch is
// vrt_lbvh_collapse_scratch(l, cap) int32, 16-byte aligned.  A refused
// launch (the cooperative grid among them) returns its error.  Returns 0
// on success.
extern "C" int vrt_lbvh_collapse(const void* lchild, const void* rchild, const void* lo,
                                 const void* hi, int l, int max_leaf, int width, int cap,
                                 void* parent, void* surv, void* ch_old, void* arity,
                                 void* base, void* newid, void* row_lo, void* row_cnt,
                                 void* leaf_newid, void* num_leaves, void* rec, void* blocks,
                                 void* roots, void* gstart, void* arrived, void* scratch,
                                 void* stream) {
    if (l < 2 || max_leaf < 1 || (width != 4 && width != 8) || cap < 1 || cap > 1024)
        return (int)cudaErrorInvalidValue;
    Collapse g{};
    g.lchild = (const int*)lchild;
    g.rchild = (const int*)rchild;
    g.lo = (const int*)lo;
    g.hi = (const int*)hi;
    g.l = l;
    g.max_leaf = max_leaf;
    g.cap = cap;
    g.parent = (int*)parent;
    g.surv = (unsigned char*)surv;
    g.ch_old = (int*)ch_old;
    g.arity = (int*)arity;
    g.base = (int*)base;
    g.newid = (int*)newid;
    g.row_lo = (int*)row_lo;
    g.row_cnt = (int*)row_cnt;
    g.leaf_newid = (int*)leaf_newid;
    g.num_leaves = (long long*)num_leaves;
    g.rec = (int*)rec;
    g.blocks = (int*)blocks;
    g.roots = (int*)roots;
    g.gstart = (int*)gstart;
    g.arrived = (int*)arrived;
    const long long n = l - 1;
    int* s = (int*)scratch;
    g.tree = (int4*)s;
    g.aux = (int2*)(s + 4 * n);
    g.tpar = s + 6 * n;
    g.root_at = g.tpar + (2LL * l - 1);
    g.wmin = g.root_at + l;
    g.row_of = g.wmin + (l + cap - 1) / cap;
    g.totals = g.row_of + (2LL * l - 1);
    g.start = (unsigned char*)(g.totals + 3LL * node_chunks(l));
    g.leaves = g.start + l;
    int most = 0, err;
    if ((err = width == 4 ? most_blocks<4>(most) : most_blocks<8>(most)) != 0) return err;
    const int grid = node_chunks(l) < most ? node_chunks(l) : most;
    void* args[] = {&g};
    return (int)cudaLaunchCooperativeKernel(
        width == 4 ? (void*)collapse_kernel<4> : (void*)collapse_kernel<8>, grid, kBlock, args, 0,
        (cudaStream_t)stream);
}
