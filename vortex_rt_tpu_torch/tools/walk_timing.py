"""Time K6 (the megakernel's binary TLAS+BLAS walk) and K2 (the 4-wide
walk) on the card, for the copy of the port at ``--root`` (this checkout
by default, or another tree of it, to compare the two in turns: run the
tool once per tree, alternating, in one call).

Waves, each captured from a real frame of that tree's renderer:

- K6: MK-A's primary wave and its first bounce wave (config 2's scene in
  the TLAS layout, sphere at reflectivity 0.6, 512x512, spp 4, depth 3;
  the first sample pass, the bounce wave with its live mask) and MK-B's
  primary wave (``atrium()``'s TLAS over 29 BLASes, 1920x1080); and K6's
  device time in MK-A's whole frame of 12 launches (the profiler);
- K2: config 2's 4-wide 512x512 primary wave (flattened, ``bvh_width=4``),
  its frame's 8 waves (each timed, and summed; and K2's time in whole
  frames by the profiler); ladder row 6's primary wave on
  the textured atrium's 4-wide TLAS build in alpha mode (512x512); and
  the atrium's 4-wide TLAS build (MK-B's scene) at 1920x1080, 2,073,600
  rays;
- K1, unchanged, for the spread: config 2's 8-wide primary wave;
- K1's and K2's predicate modes (``--parts k1p,k2p``) on ladder row 6's
  scene with ``stateless_anyhit`` of the predicate ``--pred`` names
  (``bench_ladder.PREDICATES``: ``checker``, the default, or
  ``perforated``): the closest and shadow waves of its first sample
  pass at 512x512 (for K1 also the mixed wave of its shadow and primary
  rays; the bounce waves hold no live ray) and the 1080p primary wave,
  captured from the predicate frame (K1: the flat 8-wide build; K2: the
  4-wide TLAS build), each timed in turns (forwards, backwards) in
  predicate mode, with its slot classes less class 3 (``cls_no_uv``)
  and with every slot tested (``cls_all_test``), in alpha mode
  (``alpha_ref=0.30``) and without any-hit (K1: the fused rows without
  alpha fields, as ``k1a``'s) on the same rays, beside the predicate
  mode's bound (``k1_bound`` / ``k2_bound`` with the predicate's
  operations: the tests the classes leave, and every candidate's), its
  tests, texel reads and candidates by slot class, and the counters of
  a counting copy (``pred_counts``: candidates a lane's and a warp's
  leaf step, the warp-steps that test, the lanes testing and the
  distinct slots tested in them); ``--pred-variants`` (``PRED_VARIANTS``:
  the test skipped, the texel read skipped, float32 functions for the
  correctly rounded ops) join the turns;
- K1 at width 16 beside width 8 (``--parts w16``): ladder config 3's
  1080p primary wave (``blob(n=187)``) and the five waves of the first
  sample pass of config 4 (``atrium()``, 1920x1080, spp 8, depth 3,
  shadow rays, path traced), captured from the 16-wide frame
  (``RTConfig(bvh_width=16, flatten=True)``, host-built) and walked by
  both tables' K1 on the same rays (``k1_timing.width_pair_wave``: each
  against its plain walk, the counting instantiations' internal steps,
  the 16-wide hits against the 8-wide ones up to exact-t ties, CUDA
  events around the bare launch in turns, steps a ray and each width's
  bound); then both widths' frames of each config (ms a frame after a
  warm-up, in turns 16, 8, 8, 16, and their rays); and ladder row 6's
  512x512 primary waves in alpha mode and with the checker predicate
  (the textured atrium, flat 16- and 8-wide builds).  On every wave the
  counters of a counting copy of the 16-wide step (``W16_COUNTS``:
  children a step, hit children, ties between two hit keys, a lane's mean
  and a warp's maximum).  ``--old FILE`` (another ``traverse_packet.cu``
  with the same C interface, e.g. the tree's before a redesign of the
  16-wide step; repeat it for more) and ``--w16-variants``
  (``W16_VARIANTS``: copies with one design piece changed) join each
  wave's turns, held to the 16-wide kernel's hits and steps (timing
  copies excepted), and ``--old`` the frames' turns;
- K3 (``--parts k3``), on ladder row 6's scene (the textured atrium,
  ``alpha_test_anyhit(0.30)``) in the 4-wide TLAS build: the first
  suspension round of the 192x192 parity frame's primary wave (73,728
  lanes), launched as that tree's pool path launches it (in place where
  the tree's K3 walks in place, the state put back before each launch by
  copies the profiler keeps apart; else out of place);
  then whole pool frames (``RTConfig(packet_size=0)``) at 192x192 (row
  6's gate) and 512x512: their K3 launches, K3's summed kernel time
  (profiler) and the frame's wall time (host clock, host-paced); each
  frame's image hashed.

Each wave is timed by the profiler's kernel time (mean of ``--reps``
launches of the bare ``kernel_call`` after a warm-up; CUDA events around
them beside, which a launch shorter than its host call does not time),
beside its bound (``tools/walk_bounds``:
``k6_bound`` from ``rays_work``, ``k2_bound`` / ``k1_bound`` from the
plain walk's work) and, where the tree packs K6's records, the bytes
those records make the walk fetch (each visited node's 64-B record and
each tested slot's 48-B record once, and the rays in and out).  Each
wave's outputs (hits, steps, counters) are hashed, so two trees' runs
show whether they gave the same records.  Prints each kernel's ptxas line
(registers, stack frame, spills), MK-B's peak device memory (the
renderer made and one frame) and, last, one JSON line with the card's
name and power limit.

``--parts ptxas`` only builds K1 and K2, and their variants with row 6's
checker predicate (``kernels.load_pred``), and prints their ptxas lines by
entry (two trees' builds compared line by line).

``--variants`` (this tree only) also builds copies of ``traverse2.cu``,
``packet_walk.cu``, ``traverse_wide.cu`` and ``traverse_packet.cu`` with
one design piece changed each (``VARIANTS``: K1's alpha mode without its
slot classes, with the floored modulo by divisions, or, for timing
only, with every slot kept (the rows' cost); K3 with its row's loads in
two rounds (the meta quarter, then the boxes or the transform), or its
registers bounded for
5 or 6 blocks an SM; K6
with its registers bounded for 8 or 7 blocks an SM, its stack in local
memory, the boxes' loads made to wait for the header, one loop over all
kinds instead of while-while, or one of its two loops a single step an
iteration; K2 with int -> float byte decoding, its stack in local
memory, while-while instead of its one loop, or either of its steps
repeated while any lane is at such a node), holds each to the kernel's
outputs (the hashes) and times it beside the kernel in turns on the same
waves, and on the sum of config 2's 8 waves.

    python vortex_rt_tpu_torch/tools/walk_timing.py [--root DIR]
        [--parts k6,k2,k3,k1a,k1p,k2p,w16] [--reps 20] [--frames 4] [--variants]
        [--old FILE] [--w16-variants NAME,...] [--pred checker|perforated]
        [--pred-variants NAME,...] [--out FILE]

(run as a file, so that the package imported is the one at ``--root``).
Needs the card; the kernels build under ``DIR/build/torch_kernels/``.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

EYE2 = ([0.05, 0.02, -3.2], [0.0, -0.05, 0.0], [0, 1, 0], 45.0, 1.0)
LIGHT2 = (0.0, 0.8, -0.5)
HD = (1920, 1080)
KERNEL = {"traverse2": "traverse2_kernel", "packet_walk": "packet_walk_kernel",
          "traverse_packet": "traverse_packet_kernel",
          "traverse_wide": "traverse_wide_kernel"}
PART_LIBS = {"k6": ("traverse2",), "k2": ("packet_walk", "traverse_packet"),
             "k3": ("traverse_wide",), "k1a": ("traverse_packet",),
             "k1p": ("traverse_packet",), "k2p": ("packet_walk",),
             "w16": ("traverse_packet",),
             "ptxas": ("traverse_packet", "packet_walk")}
# variants whose outputs differ from the kernel's by design (timing copies)
TIMING_ONLY = {"k1a_rows"}
_ONE_LOOP_K6 = [("while (live && rec.h.x == KIND_INTERNAL) {",
                 "if (live && rec.h.x == KIND_INTERNAL) {"),
                ("while (live && rec.h.x != KIND_INTERNAL) {",
                 "if (live && rec.h.x != KIND_INTERNAL) {")]
# K2 steps an internal node, then a leaf or instance node, an iteration
_WHILE_K2 = [("if ((w3.z >> 29) == 0u) {",
              "while (alive && (w3.z >> 29) == 0u) {"),
             ("if (alive && (w3.z >> 29) != 0u) {",
              "while (alive && (w3.z >> 29) != 0u) {")]


def _local_stack(ty: str):
    return [("#define VRT_STK_STRIDE VRT_BLOCK", "#define VRT_STK_STRIDE 1"),
            (f"extern __shared__ {ty} stack_smem[];",
             f"{ty} stack_smem[VRT_STACK_MAX];"),
            ("stack_smem + threadIdx.x", "stack_smem")]


# copies with one design piece taken back: (library, [(text, new text)])
VARIANTS = {
    "k6_regs64": ("traverse2", [(
        "__launch_bounds__(VRT_BLOCK)\ntraverse2_kernel",
        "__launch_bounds__(VRT_BLOCK, 8)\ntraverse2_kernel")]),
    "k6_regs72": ("traverse2", [(
        "__launch_bounds__(VRT_BLOCK)\ntraverse2_kernel",
        "__launch_bounds__(VRT_BLOCK, 7)\ntraverse2_kernel")]),
    "k6_local_stack": ("traverse2", _local_stack("int")),
    # the boxes' addresses depend on the header's kind (>= 0): two rounds
    "k6_two_rounds": ("traverse2", [(
        "const int4 x = __ldg(r + 1), y = __ldg(r + 2), z = __ldg(r + 3);",
        "const int4* rb = r + (rec.h.x >> 31);\n"
        "    const int4 x = __ldg(rb + 1), y = __ldg(rb + 2), "
        "z = __ldg(rb + 3);")]),
    "k6_one_loop": ("traverse2", _ONE_LOOP_K6),
    "k6_leaf_if": ("traverse2", _ONE_LOOP_K6[1:]),
    "k6_internal_if": ("traverse2", _ONE_LOOP_K6[:1]),
    "k2_i2f": ("packet_walk", [(
        "return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650u | k))\n"
        "        - 8388608.0f;",
        "return (float)(int)((w >> (8 * k)) & 255u);")]),
    "k2_local_stack": ("packet_walk", _local_stack("int2")),
    "k2_while_while": ("packet_walk", _WHILE_K2),
    "k2_internal_while": ("packet_walk", _WHILE_K2[:1]),
    "k2_leaf_while": ("packet_walk", _WHILE_K2[1:]),
    # the meta quarter first, then the boxes or the transform and root
    "k3_two_rounds": ("traverse_wide", [
        ("""const uint4 w0 = __ldg(nrow + 0), w1 = __ldg(nrow + 1);
        const uint4 w2 = __ldg(nrow + 2), w3 = __ldg(nrow + 3);
        uint4 w4 = w3, w5 = w3, w6 = w3, w7 = w3;
        if (in_tlas) {
            w4 = __ldg(nrow + 4); w5 = __ldg(nrow + 5);
            w6 = __ldg(nrow + 6); w7 = __ldg(nrow + 7);
        }""", "const uint4 w3 = __ldg(nrow + 3);"),
        ("""// ---- internal: 4 slab tests, the 5-swap far -> near network
""", """// ---- internal: 4 slab tests, the 5-swap far -> near network
            const uint4 w0 = __ldg(nrow + 0), w1 = __ldg(nrow + 1);
            const uint4 w2 = __ldg(nrow + 2);
"""),
        ("""// ---- instance: world ray -> object space, on to the BLAS root
""", """// ---- instance: world ray -> object space, on to the BLAS root
            const uint4 w4 = __ldg(nrow + 4), w5 = __ldg(nrow + 5);
            const uint4 w6 = __ldg(nrow + 6), w7 = __ldg(nrow + 7);
""")]),
    # K1's alpha mode: no slot classes (every candidate tested)
    "k1a_no_classes": ("traverse_packet", [(
        "ALPHA && a.alpha_cls != nullptr ? __ldg(a.alpha_cls + node) : 0u;",
        "0u;")]),
    # the floored modulo by two divisions for every texture side (the
    # header before its power-of-two mask, inlined into the copy)
    "k1a_div_mod": ("traverse_packet", [(
        '#include "alpha_test.cuh"', lambda: (
            Path(__file__).resolve().parents[1] / "csrc" / "alpha_test.cuh"
        ).read_text().replace(
            "    if ((m & (m - 1)) == 0) return x & (m - 1);\n", ""))]),
    # timing only (its hits are the walk's without alpha): every slot
    # kept, no alpha test, over the same 512-B rows
    "k1a_rows": ("traverse_packet", [(
        "const uint32_t cls = (cls_w >> (2 * c)) & 3u;",
        "const uint32_t cls = 1u;")]),
    # registers bounded for 5 or 6 blocks of 128 an SM (102 or 85)
    "k3_blocks5": ("traverse_wide", [(
        "__global__ void __launch_bounds__(VRT_BLOCK) traverse_wide_kernel(",
        "__global__ void __launch_bounds__(VRT_BLOCK, 5) traverse_wide_kernel(")]),
    "k3_blocks6": ("traverse_wide", [(
        "__global__ void __launch_bounds__(VRT_BLOCK) traverse_wide_kernel(",
        "__global__ void __launch_bounds__(VRT_BLOCK, 6) traverse_wide_kernel(")]),
}


def _span(start: str, end: str, new: str):
    """An edit of a source: the text from ``start`` (once in it) to the
    end of the first ``end`` after it, replaced by ``new``."""
    def edit(text: str) -> str:
        if text.count(start) != 1:
            raise RuntimeError(f"{start!r} is not in the source once")
        i = text.index(start)
        j = text.index(end, i) + len(end)
        return text[:i] + new + text[j:]
    return edit


# K1 at width 16 (``--parts w16 --w16-variants ...``): copies of
# ``traverse_packet.cu`` with one design piece changed, built from
# ``--old`` (the tree before the redesign of the 16-wide internal step)
# or from this tree's source: {name: (base "old" or "this", edits)}.
# Those of the old step split its instruction issue: no network (the hit
# children in slot order, timing only: another visit order), the slab
# tests of a group of four children only where a lane of the warp has
# them, and registers bounded for 8 blocks of 128 an SM (64).
_W16_NET = ("    // the JAX body's 16-slot network (traverse_packet.py:78-102: "
            "Batcher's\n")
_W16_PACKED = "        perm |= (uint64_t)ix[c] << (4 * c);\n    }\n"
_W16_BOUNDS = ("__global__ void __launch_bounds__(VRT_BLOCK) "
               "traverse_packet16_kernel(")
W16_VARIANTS = {
    "w16_no_net": ("old", [_span(_W16_NET, _W16_PACKED, """\
    int m = 0;
    uint64_t perm = 0;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
        if (ds[c] > -VRT_LARGE) {
            perm |= (uint64_t)c << (4 * m);
            ++m;
        }
    }
""")]),
    "w16_slab_nch": ("old", [
        ("""#pragma unroll
    for (int c = 0; c < 16; ++c) {
        const float lx = gx + qbyte(ql[c], 0) * sx;""", """#pragma unroll
    for (int g = 0; g < 4; ++g) {
    const bool need = __any_sync(__activemask(), nch > 4 * g);
#pragma unroll
    for (int c = 4 * g; c < 4 * g + 4; ++c) {
        ds[c] = -VRT_LARGE;
        ix[c] = c;
        if (!need) continue;
        const float lx = gx + qbyte(ql[c], 0) * sx;"""),
        ("""        ds[c] = hit ? tmin : -VRT_LARGE;
        ix[c] = c;
    }
""", """        ds[c] = hit ? tmin : -VRT_LARGE;
        ix[c] = c;
    }
    }
""")]),
    "w16_regs64": ("old", [(_W16_BOUNDS, _W16_BOUNDS.replace(
        "(VRT_BLOCK)", "(VRT_BLOCK, 8)"))]),
}
# and of this tree's step, each with one piece taken back or added
W16_VARIANTS.update({
    "w16n_regs64": ("this", [(_W16_BOUNDS, _W16_BOUNDS.replace(
        "(VRT_BLOCK)", "(VRT_BLOCK, 8)"))]),
    "w16n_regs72": ("this", [(_W16_BOUNDS, _W16_BOUNDS.replace(
        "(VRT_BLOCK)", "(VRT_BLOCK, 7)"))]),
    "w16n_slab_nch": ("this", [
        ("""#pragma unroll
    for (int c = 0; c < 16; ++c) {
        const float lx = gx + qbyte(ql[c], 0) * sx;""", """#pragma unroll
    for (int g = 0; g < 4; ++g) {
    const bool need = __any_sync(__activemask(), nch > 4 * g);
#pragma unroll
    for (int c = 4 * g; c < 4 * g + 4; ++c) {
        ds[c] = -VRT_LARGE;
        if (!need) continue;
        const float lx = gx + qbyte(ql[c], 0) * sx;"""),
        ("""        hits |= hit ? (1u << c) : 0u;
    }
""", """        hits |= hit ? (1u << c) : 0u;
    }
    }
""")]),
})


def _sort16_edit(edits):
    """An edit of ``traverse_packet.cu`` that inlines ``sort16.cuh`` with
    ``edits`` ([(text, new text)], each once in the header) in place of
    its include."""
    def edit(text: str) -> str:
        hdr = (Path(__file__).resolve().parents[1] / "csrc"
               / "sort16.cuh").read_text()
        for a, b in edits:
            if hdr.count(a) != 1:
                raise RuntimeError(f"{a!r} is not in sort16.cuh once")
            hdr = hdr.replace(a, b)
        inc = '#include "sort16.cuh"\n'
        if text.count(inc) != 1:
            raise RuntimeError("traverse_packet.cu includes sort16.cuh "
                               "other than once")
        return text.replace(inc, hdr)
    return edit


# the ordering's drafts: one key a pass (15 fminf, then the slot taken
# out of the keys), and the exact keys dropped after packing (their low
# 4 bits kept for the network, so `ds` need not stay live)
_W16_TWO_A_PASS = """\
    float a, b;
    vrt_least2<false>(pk, 0.0f, a, b);
    int near = vrt_slot16(a);
    bool tie = false;
    for (int k = 0;; k += 2) {
        vrt_put16(w1, w2, m - 1 - k, vrt_slot16(a));
        if (k + 1 == m) break;
        if (vrt_trunc16(b) == vrt_trunc16(a)) {
            tie = true;
            break;
        }
        vrt_put16(w1, w2, m - 2 - k, vrt_slot16(b));
        if (k + 2 == m) break;
        const float last = b;
        vrt_least2<true>(pk, last, a, b);
        if (vrt_trunc16(a) == vrt_trunc16(last)) {
            tie = true;
            break;
        }
    }
"""
W16_VARIANTS.update({
    "w16n_one_key": ("this", [_sort16_edit([(_W16_TWO_A_PASS, """\
    int near = 0;
    float prev = 0.0f;
    bool tie = false;
    for (int k = 0; k < m; ++k) {
        float mn = pk[0];
#pragma unroll
        for (int c = 1; c < 16; ++c) mn = fminf(mn, pk[c]);
        const int s = vrt_slot16(mn);
        const float tv = vrt_trunc16(mn);
        if (k > 0 && tv == prev) {
            tie = true;
            break;
        }
        prev = tv;
        if (k == 0) near = s;
        vrt_put16(w1, w2, m - 1 - k, s);
#pragma unroll
        for (int c = 0; c < 16; ++c) pk[c] = (c == s) ? VRT_SORT16_INF : pk[c];
    }
""")])]),
    "w16n_exact_lo": ("this", [_sort16_edit([
        ("""    float pk[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) {
        pk[c] = ((hits >> c) & 1u)
            ? vrt_u2f((vrt_f2u(ds[c]) & ~15u) | (uint32_t)c)
            : VRT_SORT16_INF;
    }""", """    float pk[16];
    uint32_t lo1 = 0u, lo2 = 0u;
#pragma unroll
    for (int c = 15; c >= 0; --c) {
        const uint32_t u = vrt_f2u(ds[c]);
        pk[c] = ((hits >> c) & 1u) ? vrt_u2f((u & ~15u) | (uint32_t)c)
                                   : VRT_SORT16_INF;
        if (c >= 8) lo2 = (lo2 << 4) | (u & 15u);
        else lo1 = (lo1 << 4) | (u & 15u);
    }"""),
        ("""            d2[c] = ds[c];""", """            const uint32_t lo = ((c < 8 ? lo1 : lo2) >> (4 * (c & 7))) & 15u;
            d2[c] = ((hits >> c) & 1u)
                ? vrt_u2f((vrt_f2u(pk[c]) & ~15u) | lo) : -1e30f;""")])]),
})
W16_TIMING_ONLY = {"w16_no_net"}
# the counters of a copy of this tree's step (``w16_counts``, not timed;
# they count the walk, the same in every version that orders as the
# network does): per internal step of a lane and per warp's internal step
# (the lanes at an internal node that step together), the node's
# children, the hit children m (keys above -LARGE), ties between two hit
# keys, and m's histogram over lanes' steps
W16_COUNTERS = ("lane_steps", "nch", "warp_steps", "warp_max_nch", "m",
                "warp_max_m", "lane_ties", "warp_ties", "lane_m2",
                "warp_m2", "warp_max_groups", "lane_groups")
_W16_ORDER = "    uint32_t p1, p2;\n"
W16_COUNTS = ("this", [
    ("__device__ __forceinline__ int internal_step16(",
     "__device__ unsigned long long vrt_w16_cnt[32];\n\n"
     "__device__ __forceinline__ int internal_step16("),
    (_W16_ORDER, """\
    {
        const unsigned act = __activemask();
        int mh = 0, tie = 0;
#pragma unroll
        for (int c = 0; c < 16; ++c) {
            mh += ds[c] > -VRT_LARGE ? 1 : 0;
#pragma unroll
            for (int e = c + 1; e < 16; ++e)
                tie |= (ds[c] > -VRT_LARGE && ds[c] == ds[e]) ? 1 : 0;
        }
        const unsigned grp = (unsigned)(nch + 3) >> 2;
        const unsigned v[12] = {
            (unsigned)__popc(act), __reduce_add_sync(act, (unsigned)nch), 1u,
            __reduce_max_sync(act, (unsigned)nch),
            __reduce_add_sync(act, (unsigned)mh),
            __reduce_max_sync(act, (unsigned)mh),
            __reduce_add_sync(act, (unsigned)tie),
            __reduce_or_sync(act, (unsigned)tie),
            __reduce_add_sync(act, mh >= 2 ? 1u : 0u),
            __reduce_or_sync(act, mh >= 2 ? 1u : 0u),
            __reduce_max_sync(act, grp), __reduce_add_sync(act, grp)};
        if ((int)(threadIdx.x & 31) == __ffs(act) - 1) {
#pragma unroll
            for (int k = 0; k < 12; ++k)
                atomicAdd(&vrt_w16_cnt[k], (unsigned long long)v[k]);
        }
        atomicAdd(&vrt_w16_cnt[12 + mh], 1ull);
    }
""" + _W16_ORDER),
    ('extern "C" int vrt_traverse_packet_stack_max(void)', """\
extern "C" int vrt_w16_counts(unsigned long long* out, int reset) {
    cudaError_t e = cudaDeviceSynchronize();
    if (e == cudaSuccess)
        e = cudaMemcpyFromSymbol(out, vrt_w16_cnt, sizeof(vrt_w16_cnt));
    if (e == cudaSuccess && reset) {
        static const unsigned long long zero[32] = {0};
        e = cudaMemcpyToSymbol(vrt_w16_cnt, zero, sizeof(zero));
    }
    return (int)e;
}

extern "C" int vrt_traverse_packet_stack_max(void)""")])


# K1's and K2's predicate modes (``--parts k1p,k2p --pred-variants
# NAME,...``): copies of this tree's ``traverse_packet.cu`` or
# ``packet_walk.cu`` built with the predicate's header (or an edit of it),
# {name: (source edits, header edit or None)}.  Timing copies: the test
# skipped (every candidate kept: another walk, its hits differ; the
# ceiling of any design of the test), the texel read skipped (alpha 0.5:
# row 6's predicates keep every texel of its checker texture, so its hits
# stay), and the float64 sequences of the correctly rounded ops replaced
# by the float32 functions (sinf, cosf, powf ...; its hits may differ).
PRED_TIMING_ONLY = {"pred_no_test", "pred_f32"}
_CR_NAMES = ("sqrt", "sin", "cos", "tan", "asin", "acos", "atan", "sinh",
             "cosh", "tanh", "asinh", "acosh", "atanh", "exp", "exp2",
             "expm1", "log", "log2", "log10", "log1p", "erf", "erfc",
             "atan2", "hypot", "pow")


def _pred_no_texel(text: str, src_dir: Path) -> str:
    hdr = (src_dir / "alpha_test.cuh").read_text()
    for a, b in (("    alpha = __ldg(pool + idx);\n",
                  "    (void)idx; alpha = 0.5f;\n"),
                 ("    return __ldg(pool + idx);\n",
                  "    (void)idx; return 0.5f;\n")):
        if hdr.count(a) == 1:
            return text.replace('#include "alpha_test.cuh"',
                                hdr.replace(a, b))
    raise RuntimeError("alpha_test.cuh: the texel read is not there once")


def _pred_f32_header(text: str) -> str:
    text = re.sub(r"\b(%s)\(\(double\)" % "|".join(_CR_NAMES),
                  lambda m: f"{m.group(1)}f((float)", text)
    return text.replace("__double2float_rn(", "(")


_PREFETCH = """\
                if (MODE == VRT_MODE_PRED && (~(CLSW ^ (CLSW >> 1))
                        & 0x55555555u & (n_slots >= 16 ? 0xFFFFFFFFu
                                          : (1u << (2 * n_slots)) - 1u))) {
                    const char* p = reinterpret_cast<const char*>(FIELDS);
                    for (int b = 0; b < 32 * n_slots; b += 128)
                        asm volatile("prefetch.global.L1 [%0];" :: "l"(p + b));
                }
"""


def _prefetch_edits(lib_name: str):
    """(c) as an early load: the leaf row's alpha-field lines prefetched
    into L1 at the leaf step's start where a slot of the row is tested
    (classes 0 and 3), so each test's field load meets them there."""
    if lib_name == "traverse_packet":
        at = ("CLASSED && a.alpha_cls != nullptr ? "
              "__ldg(a.alpha_cls + node) : 0u;\n")
        fields = "reinterpret_cast<const float4*>(row) + a.alpha_vec4"
        return [(at, at + "#ifdef VRT_PRED_HEADER\n" + _PREFETCH.replace(
            "FIELDS", fields).replace("CLSW", "cls_w") + "#endif\n")]
    at = "&& a.pred_cls != nullptr ? __ldg(a.pred_cls + row_i) : 0u;\n"
    fields = "a.alpha_rows + (size_t)row_i * a.alpha_vec4"
    return [(at, at + _PREFETCH.replace("FIELDS", fields).replace(
        "CLSW", "cls_w"))]


# K1's predicate mode reading each slot's class byte in the slot loop (a
# load beside the slot's) instead of the row's class word once a leaf
# step, held in a register across the predicate's calls
_K1_CLS_BYTE = [
    ("const uint32_t cls = (cls_w >> (2 * c)) & 3u;\n",
     "uint32_t cls = (cls_w >> (2 * c)) & 3u;\n"
     "                    if (MODE == VRT_MODE_PRED && a.alpha_cls != nullptr)"
     "\n                        cls = (__ldg(reinterpret_cast<const uint8_t*>("
     "a.alpha_cls + node) + (c >> 2)) >> (2 * (c & 3))) & 3u;\n"),
    ("CLASSED && a.alpha_cls != nullptr ? __ldg(a.alpha_cls + node) : 0u;",
     "ALPHA && a.alpha_cls != nullptr ? __ldg(a.alpha_cls + node) : 0u;")]

# (variants of one library only)
PRED_VARIANT_LIB = {"pred_cls_byte": "traverse_packet"}
PRED_VARIANTS = {
    "pred_cls_byte": (_K1_CLS_BYTE, None),
    "pred_no_test": ([lambda t, d: re.sub(
        r"vrt_pred\(su, sv, [a-z_.]+\)", "true", t)], None),
    "pred_no_texel": ([_pred_no_texel], None),
    "pred_f32": ([], _pred_f32_header),
}
# the counters of a copy of the walk (``pred_counts``, not timed): per
# leaf step of a lane and per warp's leaf step (the lanes at a triangle
# leaf that step together), the candidates (triangles that pass
# Moller-Trumbore), the tests (predicate calls) and texel reads, the
# warp-steps holding a test, the lanes testing in them, the distinct
# slots tested in a warp-step (the chains of dependent reads the warp
# waits on) and the slot iterations
PRED_COUNTERS = ("lane_steps", "cand", "warp_steps", "warp_max_cand",
                 "warp_test_steps", "lanes_testing", "test_slots", "tests",
                 "texels", "warp_multi_slot", "slot_iters",
                 "warp_cand_steps")
_PRED_CNT_BLOCK = """\
                if (MODE == VRT_MODE_PRED) {
                    const unsigned act = __activemask();
                    const unsigned tst = vrt_tests > 0 ? 1u : 0u;
                    const unsigned orm = __reduce_or_sync(act, vrt_tmask);
                    const unsigned v[12] = {
                        (unsigned)__popc(act),
                        __reduce_add_sync(act, (unsigned)vrt_cand), 1u,
                        __reduce_max_sync(act, (unsigned)vrt_cand),
                        __reduce_or_sync(act, tst),
                        __reduce_add_sync(act, tst), (unsigned)__popc(orm),
                        __reduce_add_sync(act, (unsigned)vrt_tests),
                        __reduce_add_sync(act, (unsigned)vrt_texels),
                        __popc(orm) >= 2 ? 1u : 0u,
                        __reduce_max_sync(act, (unsigned)n_slots),
                        __reduce_or_sync(act, vrt_cand > 0 ? 1u : 0u)};
                    if ((int)(threadIdx.x & 31) == __ffs(act) - 1) {
#pragma unroll
                        for (int k = 0; k < 12; ++k)
                            atomicAdd(&vrt_pc_cnt[k],
                                      (unsigned long long)v[k]);
                    }
                }
"""
_PRED_CNT_EXPORT = """\
extern "C" int vrt_pc_counts(unsigned long long* out, int reset) {
    cudaError_t e = cudaDeviceSynchronize();
    if (e == cudaSuccess)
        e = cudaMemcpyFromSymbol(out, vrt_pc_cnt, sizeof(vrt_pc_cnt));
    if (e == cudaSuccess && reset) {
        static const unsigned long long zero[16] = {0};
        e = cudaMemcpyToSymbol(vrt_pc_cnt, zero, sizeof(zero));
    }
    return (int)e;
}

extern "C" const char* vrt_error_string(int err) {"""


def _pred_counts_edits(lib_name: str):
    k1 = lib_name == "traverse_packet"
    slots = ("const int n_slots = min(a.lmax, (int)w5.w);\n" if k1 else
             "const int n_slots = min(a.lmax, (int)w3.w);\n")
    after = ("                if (occ) {\n" if k1 else
             "            } else {\n"
             "                // ---- instance: world ray -> instance space")
    return [
        ("// Walks ray i;",
         "__device__ unsigned long long vrt_pc_cnt[16];\n\n// Walks ray i;"),
        (slots, slots + "                int vrt_cand = 0, vrt_tests = 0, "
         "vrt_texels = 0;\n                unsigned vrt_tmask = 0u;\n"),
        ("&& (t > VRT_EPS);\n", "&& (t > VRT_EPS);\n"
         "                    if (ok) ++vrt_cand;\n"),
        (after, _PRED_CNT_BLOCK + after),
        ('extern "C" const char* vrt_error_string(int err) {',
         _PRED_CNT_EXPORT),
        ("vrt_pred(su, sv, salpha)", "(vrt_tmask |= 1u << c, ++vrt_tests, "
         "vrt_pred(su, sv, salpha))"),
        lambda t, d: t.replace(
            "vrt_candidate_surface(__ldg(al),",
            "++vrt_texels; vrt_candidate_surface(__ldg(al),").replace(
            ": vrt_texel_alpha(f1, su, sv,",
            ": (++vrt_texels, vrt_texel_alpha)(f1, su, sv,"),
    ]


def pred_build(kernels, lib_name: str, names, pred) -> dict:
    """Copies of this tree's ``lib_name`` source (``PRED_VARIANTS`` and
    ``pred_counts`` of ``names``) built with predicate ``pred``'s header
    (or its edit), one nvcc a build, all at once: {name: library}."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    src = kernels.SRC_DIR / f"{lib_name}.cu"
    out_dir = kernels.BUILD_DIR.parent / "walk_variants" / "pred"
    out_dir.mkdir(parents=True, exist_ok=True)
    for hdr in src.parent.glob("*.cuh"):
        shutil.copy(hdr, out_dir / hdr.name)
    jobs = {}
    for name in names:
        edits, hdr_edit = ((_pred_counts_edits(lib_name), None)
                           if name == "pred_counts" else
                           (_prefetch_edits(lib_name), None)
                           if name == "pred_prefetch" else PRED_VARIANTS[name])
        text = src.read_text()
        for edit in edits:
            if callable(edit):
                text = edit(text, src.parent)
                continue
            a, b = edit
            if text.count(a) != 1:
                raise RuntimeError(f"{name}: {a!r} is not in {src.name} once")
            text = text.replace(a, b)
        path = out_dir / f"{lib_name}_{name}.cu"
        path.write_text(text)
        hdr = pred.write(kernels.PRED_DIR)
        if hdr_edit is not None:
            hdr = kernels.PRED_DIR / f"vrt_pred_{pred.digest}_{name}.cuh"
            hdr.write_text(hdr_edit(pred.text))
        jobs[name] = (path, hdr)
    with ThreadPoolExecutor(8) as ex:
        futs = {n: ex.submit(kernels.load_file, lib_name, path,
                             defines=(f"VRT_PRED_HEADER={hdr.name}",),
                             include_dirs=(kernels.PRED_DIR,), headers=(hdr,))
                for n, (path, hdr) in jobs.items()}
        return {n: f.result() for n, f in futs.items()}


def pred_through(kernels, lib_name: str, pred, lib, make):
    """``make()`` with ``lib`` as ``lib_name``'s library built with
    ``pred`` during it."""
    return _through(kernels, f"{lib_name}+pred-{pred.digest}", lib, make)


def pred_counts(lib, run) -> dict:
    """The counters (``PRED_COUNTERS``) over one ``run()`` of the
    counting copy ``lib``, and the means a lane's leaf step and a warp's
    that step 0 reads."""
    import ctypes

    buf = (ctypes.c_ulonglong * 16)()
    fn = lib.lib.vrt_pc_counts
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    for reset in (1, 0):
        if reset == 0:
            run()
        err = fn(ctypes.addressof(buf), reset)
        if err:
            raise RuntimeError(f"vrt_pc_counts: {lib.error_string(err)}")
    c = dict(zip(PRED_COUNTERS, list(buf)))
    lanes, warps = max(c["lane_steps"], 1), max(c["warp_steps"], 1)
    tw = max(c["warp_test_steps"], 1)
    return dict(counts=c, cand_per_lane_step=c["cand"] / lanes,
                cand_per_warp_step=c["cand"] / warps,
                warp_max_cand=c["warp_max_cand"] / warps,
                lanes_per_warp_step=c["lane_steps"] / warps,
                test_warp_share=c["warp_test_steps"] / warps,
                lanes_testing_per_test_step=c["lanes_testing"] / tw,
                test_slots_per_test_step=c["test_slots"] / tw,
                multi_slot_share=c["warp_multi_slot"] / tw,
                tests_per_cand=c["tests"] / max(c["cand"], 1),
                texels_per_cand=c["texels"] / max(c["cand"], 1),
                slot_iters_per_warp_step=c["slot_iters"] / warps)


def _events_ms(torch, fn, reps: int) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _variant_libs(kernels, libs=None) -> dict:
    """Build ``VARIANTS`` (of the libraries ``libs``, all by default) from
    this tree's sources under ``build/walk_variants/`` (headers copied
    beside): {name: library}."""
    import shutil

    out_dir = kernels.BUILD_DIR.parent / "walk_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    for hdr in kernels.SRC_DIR.glob("*.cuh"):
        shutil.copy(hdr, out_dir / hdr.name)
    built = {}
    for name, (lib, edits) in VARIANTS.items():
        if libs is not None and lib not in libs:
            continue
        text = (kernels.SRC_DIR / f"{lib}.cu").read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in {lib}.cu once")
            text = text.replace(old, new() if callable(new) else new)
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        built[name] = kernels.load_file(lib, src)
    return built


def _through(kernels, name: str, lib, make):
    """``make()`` with kernel library ``name`` taken from ``lib`` (None:
    the tree's own) for every load during it: a launcher made so keeps
    that library."""
    if lib is None:
        return make()
    saved = kernels._loaded.get(name)
    kernels._loaded[name] = lib
    try:
        return make()
    finally:
        if saved is None:
            kernels._loaded.pop(name)
        else:
            kernels._loaded[name] = saved


def pool_lanes(cam, w: int, h: int, spp: int, dev):
    """The ray lanes of a pool frame's first wave (every sample of every
    pixel, a pixel's samples adjacent, tile-major), as the suspension
    engine's primary wave traces them."""
    import torch

    from vortex_rt_tpu_torch.engine import wavefront as wf
    from vortex_rt_tpu_torch.engine.megakernel import CameraArrays

    lane = torch.arange(w * h * spp, dtype=torch.int64, device=dev)
    q = lane // spp
    pxi, pyi = wf._tile_pixel_ids(q, w, 16, 16)
    return wf._camera_from_pix(CameraArrays.from_camera(cam, dev), w, h,
                               pxi, pyi, pyi * w + pxi, lane % spp, spp)


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _ptxas(log: str) -> str:
    return " | ".join(ln.split("ptxas info    : ")[-1].strip()
                      for ln in log.splitlines()
                      if "registers" in ln or "stack frame" in ln
                      or "spill" in ln)


def _capture(r, cam, p, w: int, h: int, limit: int = 0):
    """The walk calls of one frame of wavefront renderer ``r`` (its first
    ``limit``, or all): [(o, d, kwargs)]."""
    import torch

    waves = []
    walk = r.walk

    def capture(wa, o, d, **kw):
        if not limit or len(waves) < limit:
            waves.append((o.clone(), d.clone(), {
                k: (v.clone() if torch.is_tensor(v) else v)
                for k, v in kw.items()}))
        return walk(wa, o, d, **kw)

    dataclasses.replace(r, walk=capture).render(cam, p, w, h)
    torch.cuda.synchronize()
    return waves


def megakernel_waves(r, cam, p, w: int, h: int):
    """The first sample pass's waves of megakernel renderer ``r`` as
    ``render_megakernel`` makes them: [(o, d, live mask)]."""
    import torch

    from vortex_rt_tpu_torch.engine import megakernel as mk
    from vortex_rt_tpu_torch.utils import prng

    dev = r.device
    jitter = None
    if p.spp > 1:
        _, k2 = prng.split(prng.prng_key(0))
        jitter = prng.uniform(k2, (h, w, 2), dev)
    light = mk.LightArrays.from_params(p, dev)
    o, d = mk.generate_camera_rays(mk.CameraArrays.from_camera(cam, dev), w,
                                   h, jitter)
    n = w * h
    rad = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    thr = torch.ones(n, dtype=torch.float32, device=dev)
    act = torch.ones(n, dtype=torch.bool, device=dev)
    waves = []
    for bounce in range(p.max_depth):
        waves.append((o, d, act))
        o, d, rad, thr, act, _ = mk.trace_wave(r.ta, r.st, light, o, d, rad,
                                               thr, act, bounce, p.max_depth)
    return waves


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--parts", default="k6,k2,k3",
                    help="k6 (MK-A, MK-B), k2 (with K1's wave), k3, k1a "
                         "(K1's alpha mode), k1p, k2p (K1's and K2's "
                         "predicate modes), w16 (K1 at width 16 beside "
                         "width 8, configs 3 and 4), ptxas (K1's and K2's "
                         "ptxas lines by entry, no timing)")
    ap.add_argument("--pred", default="checker",
                    help="the predicate of k1p and k2p: checker or "
                         "perforated (bench_ladder.PREDICATES)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--variants", action="store_true",
                    help="also time VARIANTS (this tree only)")
    ap.add_argument("--old", action="append", default=[],
                    help="w16: another traverse_packet.cu with the same C "
                         "interface, timed in turns with this tree's "
                         "(repeat for more: old, old2, ...)")
    ap.add_argument("--w16-variants", default="",
                    help="w16: names of W16_VARIANTS to time in turns")
    ap.add_argument("--pred-variants", default="",
                    help="k1p, k2p: names of PRED_VARIANTS to time in turns")
    ap.add_argument("--out", default=None, help="write the JSON line here too")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    from vortex_rt_tpu_torch.ops import packet_walk as pw
    from vortex_rt_tpu_torch.ops import traverse2 as t2
    from vortex_rt_tpu_torch.ops import traverse_packet as tp
    from vortex_rt_tpu_torch.runtime import kernels
    from vortex_rt_tpu_torch.tools import walk_bounds as wb

    if not Path(t2.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {t2.__file__}, not the tree at {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    parts = args.parts.split(",")
    lib_names = [n for p in parts for n in PART_LIBS[p]]
    libs = kernels.load_all(lib_names)
    packs = hasattr(t2, "pack_walk_tables")
    out = {"root": str(root), "card": card, "packed_k6": packs,
           "reps": args.reps, "parts": parts,
           "ptxas": {n: _ptxas(lib.build_log) for n, lib in libs.items()},
           "ptxas_entries": {n: _ptxas_entries(lib.build_log)
                             for n, lib in libs.items()},
           "k6": {}, "k2": {}, "k1": {}, "k3": {}, "k1a": {}, "k1p": {},
           "k2p": {}, "w16": {}}
    variants = _variant_libs(kernels, lib_names) if args.variants else {}
    for n, lib in variants.items():
        out["ptxas"][n] = _ptxas(lib.build_log)
    if "ptxas" in parts:
        from vortex_rt_tpu_torch.ops.anyhit_pred import compile_predicate
        from vortex_rt_tpu_torch.tools.bench_ladder import checker_pred

        pred = compile_predicate(checker_pred)
        for n in PART_LIBS["ptxas"]:
            log = kernels.load_pred(n, pred).build_log
            out["ptxas"][f"{n}+checker"] = _ptxas(log)
            out["ptxas_entries"][f"{n}+checker"] = _ptxas_entries(log)
    for n, line in out["ptxas"].items():
        print(f"{n}: {line}", file=sys.stderr)

    def timed(lib_name, make, res_of, with_variants=True):
        """The kernel and each variant of library ``lib_name``: held to
        the kernel's outputs (a ``TIMING_ONLY`` copy's digest is kept
        beside), then timed in turns (forwards, backwards):
        {version: {ms (profiler), events_ms, ...}}, the kernel's first
        outputs."""
        calls = {"kernel": make()}
        first = calls["kernel"]()
        want = _digest(res_of(first))
        digests = {}
        for n, lib in variants.items():
            if VARIANTS[n][0] == lib_name and with_variants:
                calls[n] = _through(kernels, lib_name, lib, make)
                got = _digest(res_of(calls[n]()))
                if n in TIMING_ONLY:
                    digests[n] = got
                elif got != want:
                    raise RuntimeError(f"{n}: outputs differ from the kernel")
        rec = _in_turns(calls, KERNEL[lib_name], args.reps)
        for n, dg in digests.items():
            rec[n]["digest"] = dg
        return rec, first

    def k6_wave(label, ta, o, d, active):
        versions, res = timed("traverse2", lambda: t2.kernel_call(
            ta, o, d, active=active), lambda r: r)
        work = t2.rays_work(ta, o, d, active=active)
        b = wb.k6_bound(work)
        rec = dict(rays=int(o.shape[0]),
                   live=int(o.shape[0] if active is None else active.sum()),
                   **versions.pop("kernel"), bound_ms=b.ms,
                   bound_by=b.bound_by, bound_bytes=b.bytes,
                   mean_steps=float(res[6].float().mean()),
                   digest=_digest(res), variants=versions)
        if packs:
            rec["fetch_bytes"] = wb.k6_record_bytes(
                work, ta.kind.shape[0], ta.tri_idx.shape[0])
        out["k6"][label] = rec
        print(f"K6 {label}: {rec}", file=sys.stderr)

    def walk_wave(kind, label, wa, o, d, kw):
        mod, work_fn, bound_fn = ((pw, pw.walk_work_4, wb.k2_bound)
                                  if kind == "k2" else
                                  (tp, tp.walk_work, wb.k1_bound))
        versions, (hits, steps) = timed(
            "packet_walk" if kind == "k2" else "traverse_packet",
            lambda: mod.kernel_call(wa, o, d, **kw), lambda r: (*r[0], r[1]))
        _, _, work = work_fn(wa, o, d, **kw)
        b = bound_fn(work)
        rec = dict(rays=int(o.shape[0]), **versions.pop("kernel"),
                   bound_ms=b.ms, bound_by=b.bound_by, bound_bytes=b.bytes,
                   mean_steps=float(steps.float().mean()),
                   digest=_digest((*hits, steps)), variants=versions)
        out[kind][label] = rec
        print(f"{kind.upper()} {label}: {rec}", file=sys.stderr)

    if "w16" in parts:
        w16_part(args, out, dev)
    if "k1a" in parts:
        k1a_part(args, out, dev, timed)
    for kind in ("k1p", "k2p"):
        if kind in parts:
            pred_part(args, out, dev, kind)
    if "k3" in parts:
        k3_part(args, out, dev, timed, variants)
    if "k6" in parts:
        k6_part(args, out, dev, k6_wave)
    if "k2" in parts:
        k2_part(args, out, dev, walk_wave)
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line)
    return 0


def _in_turns(calls: dict, kname: str, reps: int) -> dict:
    """Each launcher of ``calls`` timed in turns, forwards then backwards:
    the profiler's time of kernel ``kname`` over ``reps`` launches, CUDA
    events beside: {name: {ms, events_ms, turns}}."""
    import torch

    from vortex_rt_tpu_torch.tools.profile_frames import (
        kernel_events, ms_by_name,
    )

    times = {n: dict(ms=[], events_ms=[]) for n in calls}
    for n in list(calls) + list(reversed(list(calls))):
        call = calls[n]
        call()
        torch.cuda.synchronize()
        times[n]["ms"].append(ms_by_name(kernel_events(
            lambda: [call() for _ in range(reps)]), [kname], reps)[kname])
        times[n]["events_ms"].append(_events_ms(torch, call, reps))
    return {n: dict(ms=sum(t["ms"]) / 2, events_ms=sum(t["events_ms"]) / 2,
                    turns=t["ms"]) for n, t in times.items()}


def _drop_uv(cls):
    """Packed slot classes with class 3 (uv only) made 0 (tested)."""
    x = cls.long() & 0xFFFFFFFF
    m = x & (x >> 1) & 0x55555555
    x = x & ~(m | (m << 1))
    return (x - ((x >> 31) << 32)).int()  # (u32 values as int32 bits)


def pred_part(args, out, dev, kind: str) -> None:
    """K1's (``k1p``) or K2's (``k2p``) predicate mode on ladder row 6's
    scene (the module docstring): each wave in predicate mode, alpha mode
    and without any-hit, in turns, beside the predicate mode's bound."""
    import time

    import torch

    from vortex_rt_tpu_torch import RTConfig, WavefrontRenderer
    from vortex_rt_tpu_torch.engine.shaders import (
        ShaderTable, stateless_anyhit,
    )
    from vortex_rt_tpu_torch.ops import anyhit_pred
    from vortex_rt_tpu_torch.ops import packet_walk as pw
    from vortex_rt_tpu_torch.ops import traverse_packet as tp
    from vortex_rt_tpu_torch.ops.traverse_wide import WideArrays
    from vortex_rt_tpu_torch.runtime import kernels
    from vortex_rt_tpu_torch.tools import bench_ladder
    from vortex_rt_tpu_torch.tools import walk_bounds as wb
    from vortex_rt_tpu_torch.utils.config import LARGE_FLOAT

    k1 = kind == "k1p"
    fn = bench_ladder.PREDICATES[args.pred]
    pred = anyhit_pred.compile_predicate(fn)
    sc6, r, cam6, p6, _ = bench_ladder.setup6(dev, pred=args.pred)
    if not k1:
        cfg = RTConfig()
        r = WavefrontRenderer.from_buffers(
            sc6.build(cfg), cfg, ShaderTable(anyhit=stateless_anyhit(
                fn, args.pred)), device=dev)
    plain_wa = (WideArrays.from_scene(r.sb, width=8).fuse().to(dev) if k1
                else r.wa)
    mod, work_fn, bound_fn, lib_name = (
        (tp, tp.walk_work, wb.k1_bound, "traverse_packet") if k1 else
        (pw, pw.walk_work_4, wb.k2_bound, "packet_walk"))
    lib = kernels.load_pred(lib_name, pred)
    names = ["pred_counts", *(n for n in args.pred_variants.split(",")
                              if n and PRED_VARIANT_LIB.get(n, lib_name)
                              == lib_name)]
    vlibs = pred_build(kernels, lib_name, names, pred)
    out[kind].update(pred=args.pred, pred_digest=pred.digest,
                     pred_ops=wb.pred_ops(pred), pred_nodes=pred.n_ops,
                     pred_build_s=lib.build_seconds,
                     ptxas_entries=_ptxas_entries(lib.build_log),
                     ptxas_variants={n: {e: v for e, v in _ptxas_entries(
                         vl.build_log).items() if "<2," in e}
                         for n, vl in vlibs.items()})
    t0 = time.perf_counter()
    classes = mod.pred_classes(r.wa, pred)
    out[kind].update(class_build_s=time.perf_counter() - t0,
                     slot_classes=classes.counts, rep_alpha=classes.rep,
                     no_rule=classes.no_rule)
    waves = _capture(r, cam6, p6, 512, 512)
    # (row 6's bounce waves hold no live ray: mirror-free)
    cases = dict(zip(("row6_512_closest", "row6_512_shadow"), waves[:2]))
    if k1:
        (o0, d0, k0), (o1, d1, k_1) = waves[:2]
        n = o0.shape[0]
        ones = torch.ones(n, dtype=torch.bool, device=dev)
        act0, act1 = (ones if kw.get("active") is None else kw["active"]
                      for kw in (k0, k_1))
        cases["row6_512_mixed"] = (
            torch.cat([o1, o0]), torch.cat([d1, d0]),
            dict(active=torch.cat([act1, act0]), t_max=torch.cat(
                [k_1["t_max"], torch.full_like(k_1["t_max"], LARGE_FLOAT)]),
                occl_split=n))
    cases["row6_1080p_closest"] = _capture(r, cam6, p6, 1920, 1080)[0]
    del waves
    for label, (o, d, kw) in cases.items():
        kw = {k: v for k, v in kw.items() if k != "anyhit_pred"}
        def make(**extra):
            return lambda: mod.kernel_call(r.wa, o, d, anyhit_pred=pred,
                                           **kw, **extra)

        calls = {
            "pred": make()(),
            "alpha": mod.kernel_call(r.wa, o, d, alpha_ref=bench_ladder.ALPHA6,
                                     **kw),
            "none": mod.kernel_call(plain_wa, o, d, **kw)}
        for n in names[1:]:
            calls[n] = pred_through(kernels, lib_name, pred, vlibs[n], make())
        # the classes with one piece taken back: class 3 tested as 0 (the
        # texel read), every slot tested (the parent's tests, with the
        # class word read)
        calls["cls_no_uv"] = make(pred_cls=classes._replace(
            cls=_drop_uv(classes.cls)))()
        calls["cls_all_test"] = make(pred_cls=classes._replace(
            cls=torch.zeros_like(classes.cls)))()
        hits, steps = calls["pred"]()
        want = _digest((*hits, steps))
        same_variants = {}
        for n in [*names[1:], "cls_no_uv", "cls_all_test"]:
            got = calls[n]()
            same_variants[n] = _digest((*got[0], got[1])) == want
        bad = [n for n, ok in same_variants.items()
               if not ok and n not in PRED_TIMING_ONLY]
        if bad:
            raise RuntimeError(f"{kind} {label}: {bad} differ from the "
                               f"kernel's hits or steps")
        counts = pred_counts(vlibs["pred_counts"], pred_through(
            kernels, lib_name, pred, vlibs["pred_counts"], make()))
        ref, ref_steps, work = work_fn(r.wa, o, d, anyhit_pred=pred, **kw)
        same = all(torch.equal(a, b) for a, b in zip((*hits, steps),
                                                     (*ref, ref_steps)))
        times = _in_turns(calls, KERNEL[lib_name], args.reps)
        p_ops = wb.pred_ops(pred)
        b0 = bound_fn(work, lookups=False, pred_ops=p_ops)
        b = bound_fn(work, lookups=True, pred_ops=p_ops)
        cand = int(work.alpha_tests.sum())
        rec = dict(rays=int(o.shape[0]), **times["pred"],
                   alpha=times["alpha"], none=times["none"],
                   variants={n: times[n] for n in [*names[1:], "cls_no_uv",
                                                   "cls_all_test"]},
                   variants_equal=same_variants,
                   bound_ms=b.ms, bound_by=b.bound_by, bound_bytes=b.bytes,
                   bound_every_ms=b0.ms, bound_every_by=b0.bound_by,
                   pred_tests=cand,
                   tests_made=int(work.alpha_lookups.sum()),
                   texel_reads=int(work.texel_reads.sum()),
                   class_share={c: int(x) / max(cand, 1) for c, x in zip(
                       ("test", "kept", "cut", "uv"),
                       work.by_class.tolist())},
                   step0=counts,
                   mean_steps=float(steps.float().mean()),
                   equals_plain=same, digest=want)
        out[kind][label] = rec
        print(f"{kind.upper()} {label}: {rec}", file=sys.stderr)
        if not same:
            raise RuntimeError(f"{kind} {label}: the predicate mode's hits "
                               f"or steps differ from the plain walk's")


def _ptxas_entries(log: str) -> dict:
    """ptxas's registers, stack frame and spills by kernel entry (the
    mangled name shortened: ``<...>`` for a template argument)."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            # template arguments (a mode number, a bool) in brackets
            name = re.sub(r"I((?:L[bi]\d+E)+)E", lambda m: "<" + ",".join(
                re.findall(r"L[bi](\d+)E", m.group(1))) + ">", name)
            name = name.replace("_Z", "").lstrip("0123456789N")
            out[name] = []
        elif name and ("registers" in ln or "stack frame" in ln):
            out[name].append(ln.split("ptxas info    : ")[-1].strip())
    return {k: " | ".join(v) for k, v in out.items()}


def w16_build(kernels, specs: dict, olds=(), pred=None) -> dict:
    """Copies of ``traverse_packet.cu`` ({name: (base, edits)}, as
    ``W16_VARIANTS``; base "this" is this tree's source, "old" the first
    of the sources ``olds`` (this tree's when none), "old<i>" the i-th),
    each built as the default library and, with predicate ``pred``, with
    its header too, one nvcc a build, all at once: {name: {"": library,
    "pred": library}}."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    this = kernels.SRC_DIR / "traverse_packet.cu"
    bases = {"this": this, "old": Path(olds[0]).resolve() if olds else this}
    for i, old in enumerate(olds[1:], 2):
        bases[f"old{i}"] = Path(old).resolve()
    out_dir = kernels.BUILD_DIR.parent / "walk_variants"
    srcs = {}
    for base, src in bases.items():
        d = out_dir / base
        d.mkdir(parents=True, exist_ok=True)
        for hdr in src.parent.glob("*.cuh"):
            shutil.copy(hdr, d / hdr.name)
    for name, (base, edits) in specs.items():
        text = bases[base].read_text()
        for edit in edits:
            if callable(edit):
                text = edit(text)
                continue
            a, b = edit
            if text.count(a) != 1:
                raise RuntimeError(f"{name}: {a!r} is not in the source once")
            text = text.replace(a, b)
        srcs[name] = out_dir / base / f"{name}.cu"
        srcs[name].write_text(text)
    modes = {"": {}}
    if pred is not None:
        hdr = pred.write(kernels.PRED_DIR)
        modes["pred"] = dict(defines=(f"VRT_PRED_HEADER={hdr.name}",),
                             include_dirs=(kernels.PRED_DIR,), headers=(hdr,))
    with ThreadPoolExecutor(8) as ex:
        futs = {(n, m): ex.submit(kernels.load_file, "traverse_packet", src,
                                  **kw)
                for n, src in srcs.items() for m, kw in modes.items()}
        return {n: {m: futs[(n, m)].result() for m in modes} for n in srcs}


def _w16_libs(kernels, args, pred) -> dict:
    """The 16-wide walk's other versions for ``--parts w16``: ``--old``
    as ``old``, ``--w16-variants``, and ``w16_counts``."""
    names = ["old", *(f"old{i}" for i in range(2, len(args.old) + 1))]
    specs = {n: (n, []) for n in names[:len(args.old)]}
    for n in filter(None, args.w16_variants.split(",")):
        specs[n] = W16_VARIANTS[n]
    specs["w16_counts"] = W16_COUNTS
    return w16_build(kernels, specs, args.old, pred)


def w16_through(kernels, pred, libs: dict, make):
    """``make()`` with K1's default library (and, with ``pred``, the one
    built with it) taken from ``libs`` (``w16_build``'s pair) during it."""
    keys = {"traverse_packet": libs[""]}
    if pred is not None:
        keys[f"traverse_packet+pred-{pred.digest}"] = libs["pred"]
    saved = {k: kernels._loaded[k] for k in keys}
    kernels._loaded.update(keys)
    try:
        return make()
    finally:
        kernels._loaded.update(saved)


def w16_counts(lib, run) -> dict:
    """Step 0's counters (``W16_COUNTERS``) over one ``run()`` of the
    counting copy ``lib``: means a lane's internal step and a warp's, the
    shares with ties and with m >= 2, and m's histogram."""
    import ctypes

    buf = (ctypes.c_ulonglong * 32)()
    fn = lib.lib.vrt_w16_counts
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    for reset in (1, 0):
        if reset == 0:
            run()
        err = fn(ctypes.addressof(buf), reset)
        if err:
            raise RuntimeError(f"vrt_w16_counts: {lib.error_string(err)}")
    c = dict(zip(W16_COUNTERS, list(buf)))
    lanes, warps = max(c["lane_steps"], 1), max(c["warp_steps"], 1)
    return dict(counts=c, m_hist=list(buf)[12:29],
                nch_mean=c["nch"] / lanes,
                nch_warp_max_mean=c["warp_max_nch"] / warps,
                m_mean=c["m"] / lanes, m_warp_max_mean=c["warp_max_m"] / warps,
                groups_mean=c["lane_groups"] / lanes,
                groups_warp_max_mean=c["warp_max_groups"] / warps,
                lanes_per_warp_step=c["lane_steps"] / warps,
                tie_share=c["lane_ties"] / lanes,
                warp_tie_share=c["warp_ties"] / warps,
                m2_share=c["lane_m2"] / lanes,
                warp_m2_share=c["warp_m2"] / warps)


def w16_part(args, out, dev) -> None:
    """K1 at width 16 beside width 8 on ladder configs 3 and 4 and row 6
    (module docstring)."""
    import time

    import torch

    from vortex_rt_tpu_torch import (
        RenderParams, RTConfig, Scene, WavefrontRenderer,
    )
    from vortex_rt_tpu_torch.engine.shaders import (
        ShaderTable, stateless_anyhit,
    )
    from vortex_rt_tpu_torch.models.bigscenes import atrium, blob
    from vortex_rt_tpu_torch.ops import traverse_packet as tp
    from vortex_rt_tpu_torch.ops.anyhit_pred import compile_predicate
    from vortex_rt_tpu_torch.runtime import kernels
    from vortex_rt_tpu_torch.tools import bench_ladder
    from vortex_rt_tpu_torch.tools import walk_bounds as wb
    from vortex_rt_tpu_torch.tools.k1_timing import width_pair_wave

    pred = compile_predicate(bench_ladder.checker_pred)
    kernels.load_pred("traverse_packet", pred)
    libs = _w16_libs(kernels, args, pred)
    out["w16"]["ptxas_entries"] = {
        f"{n}{'+checker' if m else ''}": _ptxas_entries(lib.build_log)
        for n, pair in libs.items() for m, lib in pair.items()}
    for n, e in out["w16"]["ptxas_entries"].items():
        print(f"w16 build {n}: " + json.dumps(
            {k: v for k, v in e.items() if "16_kernel" in k}),
            file=sys.stderr)

    def wave(label, name, wa16, wa8, o, d, kw, bound_kw=None):
        extra = {n: (w16_through(kernels, pred, pair, lambda: tp.kernel_call(
            wa16, o, d, **kw)), n not in W16_TIMING_ONLY)
            for n, pair in libs.items() if n != "w16_counts"}
        rec = width_pair_wave(wa16, wa8, o, d, kw, args.reps, extra,
                              bound_kw)
        rec["step0"] = w16_counts(
            libs["w16_counts"]["pred" if "anyhit_pred" in kw else ""],
            w16_through(kernels, pred, libs["w16_counts"],
                         lambda: tp.kernel_call(wa16, o, d, **kw)))
        out["w16"][label][name] = rec
        print(f"w16 {label} {name}: {rec}", file=sys.stderr)

    def frames(label, rs, cam, p, w, h):
        walks = {"w16": (rs[16], None), "w8": (rs[8], None)}
        for n in libs:
            if n.startswith("old"):
                walks[n] = (rs[16], libs[n])
        ms = {n: [] for n in walks}
        rays = {}

        def render(n):
            r, lib = walks[n]
            run = lambda: r.render_burst(cam, p, w, h, n_frames=1,  # noqa
                                         rays_only=True)
            return run() if lib is None else w16_through(kernels, pred,
                                                          lib, run)
        for n in walks:
            render(n)
        for n in list(walks) + list(walks)[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rays[n] = render(n)
            torch.cuda.synchronize()
            ms[n].append((time.perf_counter() - t0) * 1e3)
        # (the two trees may split a tie on an edge two leaves share
        # differently, H24: a frame's rays can differ by a few)
        out["w16"][label]["frame_ms"] = ms
        out["w16"][label]["rays"] = rays
        print(f"w16 {label} frames: {ms}", file=sys.stderr)

    names = ("closest0", "shadow0", "closest1", "merged1", "shadow2")
    for label, meshes, spp, n_waves in (
            ("config3", [(blob(n=187), 0.0)], 4, 1),
            ("config4", list(atrium()), 8, 5)):
        sc = Scene()
        for mesh, refl in meshes:
            sc.add_instance(sc.add_mesh(mesh), reflectivity=refl)
        sb = sc.build(RTConfig(flatten=True))
        rs = {w: WavefrontRenderer.from_buffers(
            sb, RTConfig(flatten=True, bvh_width=w), device=dev)
            for w in (16, 8)}
        cam = Scene.framing_camera(sb, 45.0, HD[0] / HD[1])
        p = RenderParams(max_depth=3, spp=spp, shadow=True, pathtrace=True)
        out["w16"][label] = dict(
            tris=sb.num_tris, depth={w: r.wa.depth for w, r in rs.items()},
            nodes={w: int(r.wa.nodes.shape[0]) for w, r in rs.items()},
            fused_bytes={w: r.wa.fused.numel() * 4 for w, r in rs.items()})
        for name, (o, d, kw) in zip(names, _capture(rs[16], cam, p, *HD,
                                                   limit=n_waves)):
            wave(label, name, rs[16].wa, rs[8].wa, o, d, kw)
        frames(label, rs, cam, p, *HD)
        del rs
    # row 6: the alpha and checker-predicate primary waves at 512x512
    _, r6, cam6, p6, table_a = bench_ladder.setup6(dev)
    tables = {"alpha": table_a, "pred": ShaderTable(anyhit=stateless_anyhit(
        bench_ladder.checker_pred, "checker"))}
    r16 = WavefrontRenderer.from_buffers(
        r6.sb, RTConfig(flatten=True, bvh_width=16), table_a, device=dev)
    out["w16"]["row6"] = dict(depth={16: r16.wa.depth, 8: r6.wa.depth})
    for kind, table in tables.items():
        rk = dataclasses.replace(r16, table=table)
        o, d, kw = _capture(rk, cam6, p6, 512, 512, limit=1)[0]
        wave("row6", f"{kind}_512_closest", r16.wa, r6.wa, o, d, kw,
             dict(lookups=True) if kind == "alpha" else
             dict(lookups=False, pred_ops=wb.pred_ops(pred)))


def k1a_part(args, out, dev, timed) -> None:
    """K1's alpha mode on ladder row 6's waves (the textured atrium, flat
    8-wide, ``alpha_test_anyhit(0.30)``) at 512x512 (the first sample
    pass's closest, shadow, bounce and second shadow waves, and the
    mixed wave of its shadow and primary rays) and its 1080p primary
    wave; the same rays over the scene's fused table without alpha
    fields (the walk without alpha, 384-B rows); K1 without alpha on
    config 2's 8-wide primary wave.  Each beside its bound (``k1_bound``,
    the tests the kernel makes, and the first figure with every candidate
    tested) and its alpha tests (made, and every candidate)."""
    import torch

    from vortex_rt_tpu_torch import Camera, RenderParams, RTConfig, Scene
    from vortex_rt_tpu_torch import WavefrontRenderer
    from vortex_rt_tpu_torch.models import procedural
    from vortex_rt_tpu_torch.ops import traverse_packet as tp
    from vortex_rt_tpu_torch.ops.traverse_wide import WideArrays
    from vortex_rt_tpu_torch.runtime import kernels
    from vortex_rt_tpu_torch.tools import bench_ladder
    from vortex_rt_tpu_torch.tools import walk_bounds as wb
    from vortex_rt_tpu_torch.utils.config import LARGE_FLOAT

    lib = kernels.load("traverse_packet")
    out["k1a"]["ptxas_entries"] = _ptxas_entries(lib.build_log)
    lookups = "lookups" in wb.k1_bound.__code__.co_varnames
    sc6, r6, cam6, p6, _ = bench_ladder.setup6(dev)
    plain_wa = WideArrays.from_scene(r6.sb, width=8).fuse().to(dev)
    out["k1a"].update(row_bytes_alpha=r6.wa.fused.shape[1] * 4,
                      row_bytes_plain=plain_wa.fused.shape[1] * 4,
                      stack_entries=tp.stack_entries(r6.wa))

    def wave(label, wa, o, d, kw, with_variants=True):
        versions, (hits, steps) = timed(
            "traverse_packet", lambda: tp.kernel_call(wa, o, d, **kw),
            lambda r: (*r[0], r[1]), with_variants)
        _, _, work = tp.walk_work(wa, o, d, **kw)
        b = wb.k1_bound(work)
        rec = dict(rays=int(o.shape[0]), **versions.pop("kernel"),
                   bound_ms=b.ms, bound_by=b.bound_by,
                   mean_steps=float(steps.float().mean()),
                   digest=_digest((*hits, steps)), variants=versions)
        if "alpha_ref" in kw:
            rec.update(alpha_tests=int(work.alpha_tests.sum()))
            if lookups:
                b0 = wb.k1_bound(work, lookups=False)
                rec.update(alpha_lookups=int(work.alpha_lookups.sum()),
                           bound_every_ms=b0.ms, bound_every_by=b0.bound_by)
        out["k1a"][label] = rec
        print(f"K1a {label}: {rec}", file=sys.stderr)

    waves = _capture(r6, cam6, p6, 512, 512)
    (o0, d0, k0), (o1, d1, k1), (o2, d2, k2), (o3, d3, k3) = waves[:4]
    n = o0.shape[0]
    cases = {"row6_512_closest": (o0, d0, k0), "row6_512_shadow": (o1, d1, k1),
             "row6_512_bounce": (o2, d2, k2), "row6_512_shadow1": (o3, d3, k3)}
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    act0, act1 = (ones if kw.get("active") is None else kw["active"]
                  for kw in (k0, k1))
    cases["row6_512_mixed"] = (
        torch.cat([o1, o0]), torch.cat([d1, d0]),
        dict(alpha_ref=k0["alpha_ref"], active=torch.cat([act1, act0]),
             t_max=torch.cat([k1["t_max"], torch.full_like(
                 k1["t_max"], LARGE_FLOAT)]), occl_split=n))
    del waves
    ohd, dhd, khd = _capture(r6, cam6, p6, 1920, 1080)[0]
    cases["row6_1080p_closest"] = (ohd, dhd, khd)
    for label, (o, d, kw) in cases.items():
        wave(label, r6.wa, o, d, kw)
        if label in ("row6_512_closest", "row6_512_shadow",
                     "row6_1080p_closest"):
            plain = {k: v for k, v in kw.items() if k != "alpha_ref"}
            wave(f"{label}_no_alpha", plain_wa, o, d, plain, False)
    del cases
    cam2 = Camera.look_at(*EYE2)
    sc = Scene()
    for mesh, refl in procedural.cornell_box():
        sc.add_instance(sc.add_mesh(mesh), reflectivity=refl)
    sc.add_instance(sc.add_mesh(procedural.uv_sphere((0, -0.3, 0), 0.35, 24,
                                                     48)))
    cfg = RTConfig(flatten=True)
    r2 = WavefrontRenderer.from_buffers(sc.build(cfg), cfg, device=dev)
    o, d, kw = _capture(r2, cam2, RenderParams(
        light_pos=LIGHT2, max_depth=2, shadow=True, spp=2), 512, 512)[0]
    wave("config2_primary", r2.wa, o, d, kw, False)


def k6_part(args, out, dev, k6_wave) -> None:
    """K6 on MK-A's and MK-B's waves, and in MK-A's frames."""
    import torch

    from vortex_rt_tpu_torch import Camera, RenderParams, RTConfig, Scene
    from vortex_rt_tpu_torch.engine.megakernel import MegakernelRenderer
    from vortex_rt_tpu_torch.models import bigscenes, procedural
    from vortex_rt_tpu_torch.ops import traverse2 as t2
    from vortex_rt_tpu_torch.tools.profile_frames import (
        kernel_events, ms_by_name,
    )

    packs = hasattr(t2, "pack_walk_tables")
    sc = Scene()
    for mesh, refl in procedural.cornell_box():
        sc.add_instance(sc.add_mesh(mesh), reflectivity=refl)
    sc.add_instance(sc.add_mesh(procedural.uv_sphere((0, -0.3, 0), 0.35, 24,
                                                     48)), reflectivity=0.6)
    sb_a = sc.build(RTConfig())
    cam2 = Camera.look_at(*EYE2)
    p_a = RenderParams(light_pos=LIGHT2, max_depth=3, spp=4)
    ra = MegakernelRenderer.from_buffers(sb_a, device=dev)
    waves = megakernel_waves(ra, cam2, p_a, 512, 512)
    k6_wave("mk_a_primary", ra.ta, waves[0][0], waves[0][1], None)
    k6_wave("mk_a_bounce1", ra.ta, *waves[1])
    del waves
    ra.frame(cam2, p_a, 512, 512)
    torch.cuda.synchronize()
    ev = kernel_events(lambda: [ra.frame(cam2, p_a, 512, 512)
                                for _ in range(args.frames)])
    out["k6"]["mk_a_frame_ms"] = ms_by_name(
        ev, ["traverse2_kernel"], args.frames)["traverse2_kernel"]
    out["k6"]["mk_a_frame_launches"] = sum(
        e.count for e in ev if "traverse2_kernel" in e.key) / args.frames
    sc = Scene()
    for mesh, refl in bigscenes.atrium():
        sc.add_instance(sc.add_mesh(mesh), reflectivity=refl)
    sb_b = sc.build(RTConfig())
    camb = Scene.framing_camera(sb_b, 45.0, HD[0] / HD[1], zoom=1.0)
    torch.cuda.reset_peak_memory_stats(dev)
    rb = MegakernelRenderer.from_buffers(sb_b, device=dev)
    rb.frame(camb, RenderParams(spp=1, max_depth=2), *HD)
    torch.cuda.synchronize()
    out["mk_b_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    out["k6_arrays_bytes"] = rb.ta.nbytes
    if packs:
        out["k6_records_bytes"] = rb.ta.walk_tables().nbytes
    o, d, _ = megakernel_waves(rb, camb, RenderParams(spp=1, max_depth=1),
                               *HD)[0]
    k6_wave("mk_b_primary", rb.ta, o, d, None)


def k2_part(args, out, dev, walk_wave) -> None:
    """K2 on config 2's 4-wide waves and frames, row 6's TLAS primary
    wave in alpha mode and the atrium's TLAS at 1080p; K1 on config 2's
    primary wave."""
    import torch

    from vortex_rt_tpu_torch import (
        Camera, RenderParams, RTConfig, Scene, WavefrontRenderer,
    )
    from vortex_rt_tpu_torch.models import bigscenes, procedural
    from vortex_rt_tpu_torch.ops import packet_walk as pw
    from vortex_rt_tpu_torch.tools import bench_ladder
    from vortex_rt_tpu_torch.tools.profile_frames import (
        kernel_events, ms_by_name,
    )

    cam2 = Camera.look_at(*EYE2)
    sc = Scene()
    for mesh, refl in procedural.cornell_box():
        sc.add_instance(sc.add_mesh(mesh), reflectivity=refl)
    sc.add_instance(sc.add_mesh(procedural.uv_sphere((0, -0.3, 0), 0.35, 24,
                                                     48)))
    p2 = RenderParams(light_pos=LIGHT2, max_depth=2, shadow=True, spp=2)
    for kind, width in (("k1", 0), ("k2", 4)):  # the 4-wide one stays
        cfg = RTConfig(flatten=True, bvh_width=width)
        r2 = WavefrontRenderer.from_buffers(sc.build(cfg), cfg, device=dev)
        waves = _capture(r2, cam2, p2, 512, 512)
        walk_wave(kind, "config2_primary", r2.wa, *waves[0])
    for k, wave in enumerate(waves[1:], 1):
        walk_wave("k2", f"config2_wave{k}", r2.wa, *wave)
    out["k2"]["config2_waves_ms"] = {
        n: sum(v["ms"] if n == "kernel" else v["variants"][n]["ms"]
               for k, v in out["k2"].items() if k.startswith("config2_w")
               or k == "config2_primary")
        for n in ["kernel", *out["k2"]["config2_primary"]["variants"]]}
    del waves
    r2.render(cam2, p2, 512, 512)
    torch.cuda.synchronize()
    ev = kernel_events(lambda: [r2.render(cam2, p2, 512, 512)
                                for _ in range(args.frames)])
    out["k2"]["config2_frame_ms"] = ms_by_name(
        ev, ["packet_walk_kernel"], args.frames)["packet_walk_kernel"]
    out["k2"]["config2_frame_launches"] = sum(
        e.count for e in ev if "packet_walk_kernel" in e.key) / args.frames
    sc6, _, cam6, p6, table = bench_ladder.setup6(dev)
    cfg = RTConfig()
    r6 = WavefrontRenderer.from_buffers(sc6.build(cfg), cfg, table,
                                        device=dev)
    o, d, kw = _capture(r6, cam6, p6, 512, 512)[0]
    walk_wave("k2", "row6_tlas_alpha_primary", r6.wa, o, d, kw)
    del r6, sc6
    sc = Scene()
    for mesh, refl in bigscenes.atrium():
        sc.add_instance(sc.add_mesh(mesh), reflectivity=refl)
    sb_b = sc.build(RTConfig())
    camb = Scene.framing_camera(sb_b, 45.0, HD[0] / HD[1], zoom=1.0)
    rh = WavefrontRenderer.from_buffers(sb_b, cfg, device=dev)
    o, d, kw = _capture(rh, camb, RenderParams(spp=1, max_depth=1), *HD)[0]
    walk_wave("k2", "atrium_tlas_1080p_primary", rh.wa, o, d, kw)
    out["atrium_tlas_depth"] = int(rh.wa.depth)
    out["atrium_tlas_stack_entries"] = pw.stack_entries(rh.wa)


def k3_part(args, out, dev, timed, variants) -> None:
    """K3's readings on row 6's scene in the 4-wide TLAS build: the
    parity frame's first suspension round, and whole pool frames."""
    import inspect
    import time

    import torch

    from vortex_rt_tpu_torch import RTConfig, WavefrontRenderer
    from vortex_rt_tpu_torch.ops import traverse_wide as tw
    from vortex_rt_tpu_torch.runtime import kernels
    from vortex_rt_tpu_torch.tools import bench_ladder
    from vortex_rt_tpu_torch.tools import walk_bounds as wb
    from vortex_rt_tpu_torch.tools.profile_frames import (
        kernel_events, ms_by_name,
    )

    kname = KERNEL["traverse_wide"]
    sc6, _, cam6, p6, table = bench_ladder.setup6(dev)
    cfg = RTConfig()
    wa6 = WavefrontRenderer.from_buffers(sc6.build(cfg), cfg, table,
                                         device=dev).wa
    lanes = pool_lanes(cam6, 192, 192, 2, dev)
    fresh = tw.init_state_lanes(*lanes)
    # this tree's K3 walks the state it is given (the pool path's rounds);
    # an earlier tree's wrote a new state, leaving its input as it was
    probe = tw.init_state_lanes(*lanes)
    in_place = tw.kernel_call(wa6, *lanes, state=probe, suspend=True)() \
        is probe

    def first_round():
        si = tw.init_state_lanes(*lanes)
        call = tw.kernel_call(wa6, *lanes, state=si, suspend=True)
        if not in_place:
            return call

        def run():
            for a, f in zip(si, fresh):
                a.copy_(f)
            return call()
        return run

    rec, st = timed("traverse_wide", first_round, lambda r: tuple(r))
    if in_place:   # (events around the put-back copies and the launch)
        for r in rec.values():
            r["events_with_copies_ms"] = r.pop("events_ms")
    res = dict(lanes=int(lanes[0].shape[0]), in_place=in_place,
               suspended=int(st.suspended.sum()),
               mean_steps=float(st.nodes_visited.float().mean()),
               **rec.pop("kernel"), variants=rec, digest=_digest(st))
    st_w, work = tw.lanes_work(wa6, *lanes, state=fresh, suspend=True)
    bounds = {"bound_every_lane": wb.k3_bound(work)}
    if "before" in inspect.signature(wb.k3_bound).parameters:
        bounds["bound"] = wb.k3_bound(work, fresh, st_w, suspend=True)
    for k, b in bounds.items():
        res[f"{k}_ms"], res[f"{k}_by"] = b.ms, b.bound_by
    if in_place:
        lib = kernels.load("traverse_wide").lib
        res["blocks_per_sm"] = lib.vrt_traverse_wide_blocks_per_sm()
    out["k3"]["parity_first_round"] = res
    print(f"K3 parity first round: {res}", file=sys.stderr)
    del work, st_w

    slow_cfg = RTConfig(packet_size=0)
    r_slow = WavefrontRenderer.from_buffers(sc6.build(slow_cfg), slow_cfg,
                                            table, device=dev)
    for label, size in (("parity_frame_192", 192), ("pool_frame_512", 512)):
        frame = {}
        for n in ["kernel", *variants]:
            lib = variants.get(n)

            def render():
                return _through(kernels, "traverse_wide", lib,
                                lambda: r_slow.render(cam6, p6, size, size))

            img, rays = render()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            ev = kernel_events(render)
            frame[n] = dict(
                k3_ms=sum(e.self_device_time_total for e in ev
                          if kname in e.key) / 1e3,
                launches=sum(e.count for e in ev if kname in e.key),
                wall_ms=wall, rays=int(rays),
                digest=_digest([torch.from_numpy(img)]))
        if any(v["digest"] != frame["kernel"]["digest"]
               for v in frame.values()):
            raise RuntimeError(f"{label}: a variant's image differs")
        out["k3"][label] = frame
        print(f"K3 {label}: {frame}", file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
