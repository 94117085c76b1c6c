// ploc_merge.cu — one round of the PLOC merge loop (kernel K4a).
//
// Replaces the body of `_ploc_merge` of vortex_rt_tpu/accel/ploc.py (:89,
// XLA while_loop at :218).  There every round runs over all l positions
// as whole-array steps: radius shifted copies of the boxes for the window
// costs, two select chains for the nearest neighbour, scatters for the
// records and one stable argsort to compact the survivors.  Positions at
// or past the live count m never reach an output, so here a round runs
// over the m live clusters only, and the work shrinks every round (about
// a third of the clusters merge each time):
//
// nn_kernel: one thread per live cluster scans `radius` neighbours forward
//   and backward for the smallest union half area, (e0*e1 + e1*e2) +
//   e2*e0 as the JAX package evaluates it.  Ties keep the smallest offset
//   (strictly smaller cost wins) and the backward neighbour is taken only
//   when strictly cheaper; a pair's cost is computed with the lower
//   position's box first, as the JAX costs are.
// mutual_kernel: mutual nearest neighbours; the lower one merges, the
//   higher one is absorbed.  Any merge sets the round's flag.
// plan_kernel: with no mutual merge (cost ties) or from round 128 on, the
//   even/odd fallback pairs neighbours instead.  Then what each merge
//   does: two leaf clusters that fit one leaf join their lists, any other
//   merge writes the leaf rows of its leaf-cluster sides and makes an
//   internal node.  It writes what the three prefix sums run over: leaf
//   rows, internals and survivors per position, as three rows of m laid
//   end to end.
// (the caller's torch.cumsum over those 3m counts: one 1-D scan, which
//   torch runs as a CUB device scan; a row's sums are the running sum
//   less its row's start)
// write_kernel: leaf rows at k_leaf + their exclusive sum, internal records
//   at k_int + theirs (creation order, i before j), the merged cluster in
//   the lower position, and every survivor scattered to its exclusive sum
//   of survivors: exactly the JAX stable argsort of the dead flags over
//   the live prefix.  The cluster state is double-buffered.  The last
//   live thread writes the next round's counters (live count, internals,
//   leaf rows), which the host reads: 4 bytes a round.
//
// All integers and exact min/max, and the cost in the JAX order with no
// FMA contraction (-fmad=false): the outputs equal the JAX package's word
// for word.  What bounds it: bytes — a round reads and writes each live
// cluster's state (24 B of box, 4 B count, 4 B internal id, 4 * leaf B of
// ids) a few times, and the window scan reads 2 * radius neighbour boxes
// per cluster (from L1/L2: neighbours are adjacent).  The host's read of
// the live count each round is a synchronisation; at 60-90 rounds that
// and the launch gaps, not the bytes, set the time at these sizes.
//
// Built by vortex_rt_tpu_torch/runtime/kernels.py with nvcc into a shared
// library with a plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr float kBig = 3e38f;  // the JAX package's "no neighbour" cost
constexpr int kFallbackRound = 128;

// per-position plan bits
constexpr int kMg = 1, kAbsorbed = 2, kStay = 4, kMakeInt = 8, kNeedI = 16, kNeedJ = 32,
              kILeaf = 64, kJLeaf = 128;
// round state words: live count, internals so far, leaf rows so far,
// any mutual merge this round
constexpr int kLive = 0, kInt = 1, kLeaf = 2, kAny = 3;

struct Box {
    float mn[3], mx[3];
};

__device__ __forceinline__ Box load_box(const float* __restrict__ cmin,
                                        const float* __restrict__ cmax, int p) {
    Box b;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        b.mn[k] = cmin[3LL * p + k];
        b.mx[k] = cmax[3LL * p + k];
    }
    return b;
}

// half area of the union of a (the lower position) and b
__device__ __forceinline__ float union_cost(const Box& a, const Box& b) {
    float e[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) e[k] = fmaxf(fmaxf(a.mx[k], b.mx[k]) - fminf(a.mn[k], b.mn[k]), 0.0f);
    return (e[0] * e[1] + e[1] * e[2]) + e[2] * e[0];
}

__global__ void nn_kernel(const float* __restrict__ cmin, const float* __restrict__ cmax, int m,
                          int l, int radius, int* __restrict__ nn) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= m) return;
    const Box a = load_box(cmin, cmax, p);
    float f_cost = kBig;
    int f_off = 0;
    for (int o = 1; o <= radius && p + o < m; ++o) {  // past m: _BIG, never better
        const float c = union_cost(a, load_box(cmin, cmax, p + o));
        if (c < f_cost) {
            f_cost = c;
            f_off = o;
        }
    }
    float b_cost = kBig;
    int b_off = 0;
    for (int o = 1; o <= radius && p - o >= 0; ++o) {
        const float c = union_cost(load_box(cmin, cmax, p - o), a);
        if (c < b_cost) {
            b_cost = c;
            b_off = o;
        }
    }
    const int q = b_cost < f_cost ? p - b_off : p + f_off;
    nn[p] = min(max(q, 0), l - 1);
}

__global__ void mutual_kernel(const int* __restrict__ nn, int m, int* __restrict__ code,
                              int* state) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= m) return;
    const int q = nn[p];
    const bool mutual = q < m && nn[q] == p;
    int c = 0;
    if (mutual && q > p) {
        c = kMg;
        state[kAny] = 1;  // every writer writes the same word
    } else if (mutual && q < p) {
        c = kAbsorbed;
    }
    code[p] = c;
}

__global__ void plan_kernel(const int* __restrict__ cnt, const int* __restrict__ nid,
                            int* __restrict__ nn, int* __restrict__ code, int m, int l, int lmax,
                            int it, const int* __restrict__ state, int* __restrict__ scan) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= m) return;
    const bool fallback = it >= kFallbackRound || state[kAny] == 0;
    bool mg, ab;
    int q;
    if (fallback) {
        mg = (p % 2 == 0) && (p + 1 < m);
        ab = p % 2 == 1;
        q = min(p + 1, l - 1);
    } else {
        const int c = code[p];
        mg = c & kMg;
        ab = c & kAbsorbed;
        q = nn[p];
    }
    const int j = mg ? q : p;
    const bool i_leaf = nid[p] < 0, j_leaf = nid[j] < 0;
    const int u_cnt = cnt[p] + (mg ? cnt[j] : 0);
    const bool stay = mg && i_leaf && j_leaf && u_cnt <= lmax;
    const bool mk = mg && !stay;
    const bool need_i = mk && i_leaf, need_j = mk && j_leaf;
    code[p] = (mg ? kMg : 0) | (ab ? kAbsorbed : 0) | (stay ? kStay : 0) | (mk ? kMakeInt : 0) |
              (need_i ? kNeedI : 0) | (need_j ? kNeedJ : 0) | (i_leaf ? kILeaf : 0) |
              (j_leaf ? kJLeaf : 0);
    nn[p] = j;  // the partner from here on (p itself when not merging)
    // three rows of m end to end: one 1-D prefix sum covers all three
    // (torch scans a 2-D tensor's rows, or its columns, far slower)
    scan[p] = (int)need_i + (int)need_j;
    scan[(long long)m + p] = mk ? 1 : 0;
    scan[2LL * m + p] = ab ? 0 : 1;
}

struct Clusters {
    float* cmin;
    float* cmax;
    int* cnt;
    int* tids;
    int* nid;
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

__global__ void write_kernel(Clusters cur, Clusters nxt, const int* __restrict__ jsel,
                             const int* __restrict__ code, const int* __restrict__ incl, int m,
                             int l, int lmax, int it, const int* __restrict__ st, int* st_next,
                             Records out) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= m) return;
    const int c = code[p];
    const int j = jsel[p];
    const bool mg = c & kMg, stay = c & kStay, mk = c & kMakeInt;
    const bool need_i = c & kNeedI, need_j = c & kNeedJ, i_leaf = c & kILeaf,
               j_leaf = c & kJLeaf, keep = !(c & kAbsorbed);
    const int k_int = st[kInt], k_leaf = st[kLeaf];
    // one running sum over the three rows: a row's inclusive sums are it
    // less the running sum where the row before it ends (end0, end1)
    const int end0 = incl[m - 1], end1 = incl[2LL * m - 1];
    const int ex_rows = incl[p] - ((int)need_i + (int)need_j);
    const int ex_int = incl[(long long)m + p] - end0 - (mk ? 1 : 0);
    const int ex_keep = incl[2LL * m + p] - end1 - (keep ? 1 : 0);
    const int cnt_i = cur.cnt[p];

    // leaf rows of the leaf-cluster sides, i before j
    const int row_i = k_leaf + ex_rows;
    const int row_j = row_i + (need_i ? 1 : 0);
    if (need_i) {
        for (int s = 0; s < lmax; ++s)
            out.row_tids[(long long)row_i * lmax + s] = cur.tids[(long long)p * lmax + s];
        out.row_cnt[row_i] = cnt_i;
    }
    if (need_j) {
        for (int s = 0; s < lmax; ++s)
            out.row_tids[(long long)row_j * lmax + s] = cur.tids[(long long)j * lmax + s];
        out.row_cnt[row_j] = cur.cnt[j];
    }

    Box u = load_box(cur.cmin, cur.cmax, p);
    if (mg) {
        const Box b = load_box(cur.cmin, cur.cmax, j);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            u.mn[k] = fminf(u.mn[k], b.mn[k]);
            u.mx[k] = fmaxf(u.mx[k], b.mx[k]);
        }
    }
    // the internal record, in creation order (children: leaf row r ->
    // (l-1)+r, internal k -> -(k+1))
    const int k = k_int + ex_int;
    if (mk) {
        out.lk[k] = i_leaf ? (l - 1) + row_i : -(cur.nid[p] + 1);
        out.rk[k] = j_leaf ? (l - 1) + row_j : -(cur.nid[j] + 1);
        out.lvl[k] = it;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            out.bmn[3LL * k + a] = u.mn[a];
            out.bmx[3LL * k + a] = u.mx[a];
        }
    }
    // the survivor, merged in place, at its compacted position
    if (keep) {
        const int d = ex_keep;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            nxt.cmin[3LL * d + a] = u.mn[a];
            nxt.cmax[3LL * d + a] = u.mx[a];
        }
        nxt.cnt[d] = cnt_i + (mg ? cur.cnt[j] : 0);
        for (int s = 0; s < lmax; ++s) {
            int v;
            if (!stay || s < cnt_i) {
                v = cur.tids[(long long)p * lmax + s];
            } else {  // slot s of the joined list: j's slot s - cnt_i
                v = cur.tids[(long long)j * lmax + (s - cnt_i)];
            }
            nxt.tids[(long long)d * lmax + s] = v;
        }
        nxt.nid[d] = mk ? k : cur.nid[p];
    }
    if (p == m - 1) {
        st_next[kLive] = incl[2LL * m + p] - end1;
        st_next[kInt] = k_int + end1 - end0;
        st_next[kLeaf] = k_leaf + end0;
        st_next[kAny] = 0;
    }
}

inline int blocks(long long n) { return (int)((n + kBlock - 1) / kBlock); }

}  // namespace

extern "C" const char* vrt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// nn_kernel, mutual_kernel, plan_kernel on `stream` over the m live
// clusters: boxes cmin, cmax (l, 3) float32, counts cnt and internal ids
// nid (l,) int32 (-1 for a leaf cluster).  state (4,) int32 is this
// round's [live, internals, leaf rows, any merge = 0].  Scratch: nn, code
// (l,); out: nn = each position's partner (itself when not merging), code
// the plan bits, scan (3 * l,) = rows of m [leaf rows | internal |
// survives] end to end.  Returns cudaGetLastError() (0 = ok).
extern "C" int vrt_ploc_round_plan(const void* cmin, const void* cmax, const void* cnt,
                                   const void* nid, int m, int l, int lmax, int radius, int it,
                                   void* state, void* nn, void* code, void* scan, void* stream) {
    if (m < 2 || m > l || lmax < 1 || radius < 1 || it < 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    nn_kernel<<<blocks(m), kBlock, 0, s>>>((const float*)cmin, (const float*)cmax, m, l, radius,
                                           (int*)nn);
    mutual_kernel<<<blocks(m), kBlock, 0, s>>>((const int*)nn, m, (int*)code, (int*)state);
    plan_kernel<<<blocks(m), kBlock, 0, s>>>((const int*)cnt, (const int*)nid, (int*)nn,
                                             (int*)code, m, l, lmax, it, (const int*)state,
                                             (int*)scan);
    return (int)cudaGetLastError();
}

// write_kernel on `stream`: the current cluster state (cmin, cmax, cnt,
// tids (l, lmax), nid) into the next one (compacted), partners jsel and
// plan bits code from vrt_ploc_round_plan, incl (3m,) the inclusive
// prefix sum of its scan[:3m]; state / state_next this round's and
// the next round's counters.  Records (creation order): lk, rk, lvl (l-1,)
// int32, bmn, bmx (l-1, 3) float32; leaf rows row_tids (l, lmax), row_cnt
// (l,).  Returns cudaGetLastError() (0 = ok).
extern "C" int vrt_ploc_round_write(const void* cmin, const void* cmax, const void* cnt,
                                    const void* tids, const void* nid, void* cmin2, void* cmax2,
                                    void* cnt2, void* tids2, void* nid2, const void* jsel,
                                    const void* code, const void* incl, int m, int l, int lmax,
                                    int it, const void* state, void* state_next, void* lk,
                                    void* rk, void* lvl, void* bmn, void* bmx, void* row_tids,
                                    void* row_cnt, void* stream) {
    if (m < 2 || m > l || lmax < 1 || it < 0) return (int)cudaErrorInvalidValue;
    const Clusters cur{(float*)cmin, (float*)cmax, (int*)cnt, (int*)tids, (int*)nid};
    const Clusters nxt{(float*)cmin2, (float*)cmax2, (int*)cnt2, (int*)tids2, (int*)nid2};
    const Records out{(int*)lk,        (int*)rk,       (int*)lvl,     (float*)bmn,
                      (float*)bmx,     (int*)row_tids, (int*)row_cnt};
    write_kernel<<<blocks(m), kBlock, 0, (cudaStream_t)stream>>>(
        cur, nxt, (const int*)jsel, (const int*)code, (const int*)incl, m, l, lmax, it,
        (const int*)state, (int*)state_next, out);
    return (int)cudaGetLastError();
}
