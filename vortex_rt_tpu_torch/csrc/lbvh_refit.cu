// lbvh_refit.cu — boxes of every node of the binary LBVH tree (Karras or
// sweep-SAH) from the current vertices: the first half of the per-frame
// refit (kernel C of K5).
//
// Replaces `_leaf_boxes` and `_range_refit` of vortex_rt_tpu/accel/lbvh.py
// (:632, :284).  The TPU version answers every internal node's box as a
// range query over a sparse table of power-of-two windows (log2 T levels
// of T boxes: 480 MB at a million triangles), because gathers are dear
// there.  Here each internal node's box is the join of its two children's,
// bottom-up.  The result does not depend on the order of the joins (min
// and max are exact): it equals the sparse table's to the bit.
//
// What bounds it: not its bytes (36 B of vertices and 4 B of order in per
// triangle, 24 B of box out per node) but its chains of dependent steps.
// Climbed in global memory (a thread a leaf, an atomic counter a node:
// the whole-tree climb this kernel replaces), each level costs a
// dependent read of the topology and a fenced global atomic that waits on
// the stores before it, the climb's divergence serialises each warp, and
// the last thread to reach the root climbs the tree's whole depth.  So the
// work is split by a plan made once per topology and kept with it: by the
// collapse of the topology's build (csrc/lbvh_collapse.cu), or for a
// topology made elsewhere by refit_plan_kernel and
// accel/lbvh.py::_refit_plan at its first refit:
//
// treelets: the maximal subtrees of at most kTile/2 leaves.  They
//   partition the sorted leaves into ranges; a block takes consecutive
//   treelets of at most kTile leaves in all (half a tile a treelet lets
//   the packing fill the blocks: 851 leaves a 1,024-leaf block at config
//   5's mesh, against 422 with whole-tile treelets).  Each inner node of a
//   treelet has a record keyed by its split gap, the last sorted position
//   of its left child: every binary tree over contiguous sorted ranges has
//   exactly one internal node per gap in [0, l-2].  (Node ids do not
//   serve: the sweep-SAH tree numbers its nodes by level, so an id need
//   not lie in its node's range.)  A record holds the node's id, its
//   children as slots of the block (a leaf's position or an inner node's
//   gap, from the block's first leaf) and its depth below the treelet's
//   root.
// a block: loads its leaves' boxes into shared memory and its gaps'
//   records into registers, coalesced; joins its inner nodes deepest
//   first, one depth a step with a barrier between (a node's children are
//   deeper, so their boxes are in shared memory when it is joined: no
//   atomic, no global read); writes its leaves' boxes, coalesced, and its
//   inner nodes'.
// the climbs: above the treelets (a few thousand nodes at a million
//   triangles), each treelet's root writes its box and arrives at its
//   parent with one global atomic with release and acquire semantics at
//   device scope; the first arriver stops, the second joins the sibling's
//   box (through __ldcg), writes the parent's and climbs on, resetting the
//   counter to 0 for the next launch.
//
// kTile = 256 leaves, 128 threads of 2: measured against tiles of 512 and
// 1,024 leaves and 4 leaves a thread (tools/refit_phases.py), it keeps the
// most blocks in flight (sixteen an SM) for the latency of each stage.
// A frame's refit is one launch, with no fill.
//
// Built by vortex_rt_tpu_torch/runtime/kernels.py with nvcc into a shared
// library with a plain C interface, loaded with ctypes.

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPer = 2;                   // leaves and gaps a thread
constexpr int kTile = kThreads * kPer;    // most leaves of a block
constexpr int kTop = (int)0x80000000;     // a record's bit: above the treelets
constexpr int kLeafRef = 1 << 10;         // a child slot that is a leaf
// shared memory of a block: the leaves' boxes, then the inner nodes' (by
// gap), under the 48 KB a launch may take without asking
constexpr size_t kSmem = (size_t)(2 * kTile - 1) * 6 * sizeof(float);

struct Refit {
    const float *v0, *v1, *v2;
    const int *order, *lchild, *rchild, *parent, *lo, *hi;
    int l, cap;  // (the plan's: the most leaves of a treelet)
    // the plan: the first leaf of each treelet root's block (l-1,) by
    // node id (-1 elsewhere), records (l-1, 2) by gap; the blocks
    // (gridDim.x, 4: first and last leaf, first and end row of their
    // treelets' roots), the roots (id, slot); the arrival counters (l-1,)
    const int* gstart;
    int* rec;
    const int4* blocks;
    const int2* roots;
    int* arrived;
    float *bmin, *bmax;
};

__device__ __forceinline__ void put_box(const Refit& g, long long node, const float* mn,
                                        const float* mx) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        g.bmin[3 * node + k] = mn[k];
        g.bmax[3 * node + k] = mx[k];
    }
}

// the last sorted position of node c (a leaf's is its own)
__device__ __forceinline__ int end_of(const Refit& g, int c) {
    return c >= g.l - 1 ? c - (g.l - 1) : g.hi[c];
}

// child c of a node of the block whose first leaf is t0, as a slot
__device__ __forceinline__ int slot_of(const Refit& g, int c, int t0) {
    return c >= g.l - 1 ? (c - (g.l - 1) - t0) | kLeafRef : end_of(g, g.lchild[c]) - t0;
}

__global__ void __launch_bounds__(256) refit_plan_kernel(Refit g) {
    const int x = blockIdx.x * 256 + threadIdx.x;
    if (x >= g.l - 1) return;
    const long long q = end_of(g, g.lchild[x]);
    if (g.hi[x] - g.lo[x] >= g.cap) {  // above the treelets
        g.rec[2 * q] = x | kTop;
        g.rec[2 * q + 1] = 0;
        return;
    }
    // the treelet's root, the highest ancestor-or-self of at most `cap`
    // leaves, and the depth below it
    int d = 0, root = x;
    while (root != 0) {
        const int p = g.parent[root];
        if (g.hi[p] - g.lo[p] >= g.cap) break;
        root = p;
        ++d;
    }
    const int t0 = g.gstart[root];
    g.rec[2 * q] = x;
    g.rec[2 * q + 1] = slot_of(g, g.lchild[x], t0) | slot_of(g, g.rchild[x], t0) << 11 | d << 22;
}

// From treelet root `node`, box (mn, mx): write the box, then arrive at the
// parent with one atomic with release and acquire semantics at device
// scope; the first arriver stops, the second resets the counter, joins the
// sibling's box (through __ldcg: another block wrote it in this launch),
// writes the parent's and climbs on.
__device__ void climb(const Refit& g, int node, const float* bn, const float* bx) {
    float mn[3] = {bn[0], bn[1], bn[2]}, mx[3] = {bx[0], bx[1], bx[2]};
    put_box(g, node, mn, mx);
    int p = g.parent[node];
    while (true) {
        // (the topology's words in flight during the arrival)
        const int lc = g.lchild[p], rc = g.rchild[p], pp = g.parent[p];
        cuda::atomic_ref<int, cuda::thread_scope_device> arrived(g.arrived[p]);
        if (arrived.fetch_add(1, cuda::memory_order_acq_rel) == 0) return;
        arrived.store(0, cuda::memory_order_relaxed);  // ready for the next launch
        const long long sib = lc == node ? rc : lc;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            mn[c] = fminf(mn[c], __ldcg(&g.bmin[3 * sib + c]));
            mx[c] = fmaxf(mx[c], __ldcg(&g.bmax[3 * sib + c]));
        }
        put_box(g, p, mn, mx);
        if (p == 0) return;  // the root
        node = p;
        p = pp;
    }
}

__global__ void __launch_bounds__(kThreads) refit_tile_kernel(Refit g) {
    extern __shared__ float s_leaf[];    // (kTile, 6)
    float* s_node = s_leaf + kTile * 6;  // (kTile - 1, 6)
    __shared__ int s_dmin, s_dmax;
    const int tid = threadIdx.x;
    const int4 blk = g.blocks[blockIdx.x];
    const int t0 = blk.x, t1 = blk.y;    // the block's leaves
    const int leaf0 = g.l - 1;           // node id of sorted leaf 0
    if (tid == 0) {
        s_dmin = 1 << 30;
        s_dmax = -1;
    }

    // the leaves' boxes into shared memory, the gaps' records into
    // registers, the loads issued together
    float mn[kPer][3], mx[kPer][3];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
        const int j = t0 + k * kThreads + tid;
        if (j > t1) continue;
        const long long tri = g.order[j];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            const float a = g.v0[3 * tri + c], b = g.v1[3 * tri + c], d = g.v2[3 * tri + c];
            mn[k][c] = fminf(fminf(a, b), d);
            mx[k][c] = fmaxf(fmaxf(a, b), d);
        }
    }
    int rec[kPer][2];
    int dmin = 1 << 30, dmax = -1;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
        const int i = k * kThreads + tid;
        rec[k][0] = -1;
        if (i >= t1 - t0) continue;
        const int2 r = *(const int2*)(g.rec + 2LL * (t0 + i));
        rec[k][0] = r.x;
        rec[k][1] = r.y;
        if (r.x < 0) continue;  // a gap between two treelets: a node above
        dmin = min(dmin, (int)((unsigned)r.y >> 22));
        dmax = max(dmax, (int)((unsigned)r.y >> 22));
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
        const int i = k * kThreads + tid;
        if (t0 + i > t1) continue;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            s_leaf[6 * i + c] = mn[k][c];
            s_leaf[6 * i + 3 + c] = mx[k][c];
        }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        dmin = min(dmin, __shfl_xor_sync(0xffffffffu, dmin, o));
        dmax = max(dmax, __shfl_xor_sync(0xffffffffu, dmax, o));
    }
    __syncthreads();  // s_dmin, s_dmax set
    if ((tid & 31) == 0 && dmax >= 0) {
        atomicMin(&s_dmin, dmin);
        atomicMax(&s_dmax, dmax);
    }
    __syncthreads();  // the leaves and the depth range are in

    // the treelets' inner nodes, deepest first: a node's children are
    // deeper
    for (int d = s_dmax; d >= s_dmin; --d) {
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
            const int i = k * kThreads + tid;
            if (rec[k][0] < 0 || (int)((unsigned)rec[k][1] >> 22) != d) continue;  // (or above)
            const int lr = rec[k][1] & 0x7ff, rr = rec[k][1] >> 11 & 0x7ff;
            const float* lb = lr & kLeafRef ? s_leaf + 6 * (lr & 0x3ff) : s_node + 6 * lr;
            const float* rb = rr & kLeafRef ? s_leaf + 6 * (rr & 0x3ff) : s_node + 6 * rr;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                s_node[6 * i + c] = fminf(lb[c], rb[c]);
                s_node[6 * i + 3 + c] = fmaxf(lb[3 + c], rb[3 + c]);
            }
        }
        __syncthreads();
    }

    // the block's boxes: its leaves, coalesced, and its inner nodes
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
        const int j = t0 + k * kThreads + tid;
        if (j <= t1) put_box(g, leaf0 + j, mn[k], mx[k]);
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
        const int i = k * kThreads + tid;
        if (rec[k][0] >= 0) put_box(g, rec[k][0], s_node + 6 * i, s_node + 6 * i + 3);
    }

    // the climbs above the treelets, from their roots
    for (int k = blk.z + tid; k < blk.w; k += kThreads) {
        const int2 r = g.roots[k];
        const float* b = r.y & kLeafRef ? s_leaf + 6 * (r.y & 0x3ff) : s_node + 6 * r.y;
        if (r.x != 0) climb(g, r.x, b, b + 3);
    }
}

}  // namespace

extern "C" const char* vrt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// Most leaves of a block of the refit (its tile).
extern "C" int vrt_lbvh_refit_tile() { return kTile; }

// The plan's records (l-1, 2) by gap of the tree lchild, rchild, lo, hi
// (l-1,), parent (2l-1,), for treelets of at
// most `cap` leaves in blocks of at most 1,024 (a record's slots are 10
// bits) whose first leaves `gstart` gives by treelet root.  Returns
// cudaGetLastError().
extern "C" int vrt_lbvh_refit_plan(const void* lchild, const void* rchild, const void* parent,
                                   const void* lo, const void* hi, int l, int cap,
                                   const void* gstart, void* rec, void* stream) {
    if (l < 2 || cap < 1 || cap > 1024) return (int)cudaErrorInvalidValue;
    Refit g{};
    g.lchild = (const int*)lchild;
    g.rchild = (const int*)rchild;
    g.parent = (const int*)parent;
    g.lo = (const int*)lo;
    g.hi = (const int*)hi;
    g.l = l;
    g.cap = cap;
    g.gstart = (const int*)gstart;
    g.rec = (int*)rec;
    refit_plan_kernel<<<(l - 1 + 255) / 256, 256, 0, (cudaStream_t)stream>>>(g);
    return (int)cudaGetLastError();
}

// bmin, bmax ((2l-1, 3) float32, old ids: internals 0..l-2, then the
// sorted triangles) of the tree lchild, rchild (l-1,), parent (2l-1,)
// over the triangles v0, v1, v2 ((l, 3) float32) in the order `order`
// (l,), by its plan: records `rec` (l-1, 2), the `n_blocks` blocks
// `blocks` (n_blocks, 4), the treelets' roots `roots` (., 2) and the
// arrival counters `arrived` (l-1,), zero before and after.  Returns
// cudaGetLastError().
extern "C" int vrt_lbvh_refit_boxes(const void* v0, const void* v1, const void* v2,
                                    const void* order, const void* lchild, const void* rchild,
                                    const void* parent, int l, const void* rec,
                                    const void* blocks, const void* roots, int n_blocks,
                                    void* arrived, void* bmin, void* bmax, void* stream) {
    if (l < 2 || n_blocks < 1) return (int)cudaErrorInvalidValue;
    Refit g{};
    g.v0 = (const float*)v0;
    g.v1 = (const float*)v1;
    g.v2 = (const float*)v2;
    g.order = (const int*)order;
    g.lchild = (const int*)lchild;
    g.rchild = (const int*)rchild;
    g.parent = (const int*)parent;
    g.l = l;
    g.rec = (int*)rec;
    g.blocks = (const int4*)blocks;
    g.roots = (const int2*)roots;
    g.arrived = (int*)arrived;
    g.bmin = (float*)bmin;
    g.bmax = (float*)bmax;
    refit_tile_kernel<<<n_blocks, kThreads, kSmem, (cudaStream_t)stream>>>(g);
    return (int)cudaGetLastError();
}
