// alpha_test.cuh — the alpha-cutout test of a candidate hit inside a walk:
// the alpha mode of K1 (traverse_packet.cu) and K2 (packet_walk.cu).
//
// Replaces the in-loop any-hit predicate of the XLA loop `trace_packets`
// with `alpha_ref` (vortex_rt_tpu/ops/traverse_packet.py:723-761): a
// Moller-Trumbore candidate whose surface alpha is below the threshold is
// rejected before the closest-hit fold (COMMIT_CONT without suspension);
// with `anyhit_pred` (the predicate mode, 8b), a candidate whose
// compiled predicate of (u, v, alpha) is false.
// The alpha is the luminance of the colour `shade_point` computes at the
// candidate: the point-sampled texel, or the material's diffuse colour (a
// 1x1 texture), looked up in the pool of `WideArrays.with_alpha`.  The uv
// interpolation (`uv1*bx + uv2*by + uv0*bz`, closest.cpp:77 order), the
// texel address and the pool read repeat `shade_point`'s operations, so
// the walk rejects exactly the candidates `alpha_test_anyhit` rejects
// through the suspension protocol (built with -fmad=false).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Floored modulo, as Python's and jnp's `%`: C's `%` truncates toward
// zero, so a negative or wrapped texel coordinate would pick another
// texel (ROADMAP hazard H10).  A side that is a power of two (every
// texture of the shipped scenes) takes a mask, the same value for every
// int in two's complement: the walks are paced by instruction issue, and
// the two integer divisions cost some forty instructions each.
__device__ __forceinline__ int vrt_floor_mod(int x, int m) {
    if ((m & (m - 1)) == 0) return x & (m - 1);
    return ((x % m) + m) % m;
}

// The candidate's interpolated uv at barycentrics (w1, w2) (uv1*w1 +
// uv2*w2 + uv0*bz, closest.cpp:77 order) from its slot's uv corners,
// (u0, v0, u1, v1) and (u2, v2): all that the predicate mode reads of a
// slot whose answer no texel it can reach changes (ops/pred_classes.py).
__device__ __forceinline__ void vrt_candidate_uv(float4 f0, float2 f1,
                                                 float w1, float w2,
                                                 float& u, float& v) {
    const float bz = 1.0f - w1 - w2;
    u = f0.z * w1 + f1.x * w2 + f0.x * bz;
    v = f0.w * w1 + f1.y * w2 + f0.y * bz;
}

// The pool entry of the texel point-sampled at (u, v) (a texture side of
// 0 is read as 1, as shade_point clamps it; with_alpha writes none); `f1`
// is the slot's second alpha field, (u2, v2, texture offset bits,
// tw << 16 | th bits).
__device__ __forceinline__ float vrt_texel_alpha(float4 f1, float u, float v,
                                                 const float* pool,
                                                 int n_pool) {
    const int toff = __float_as_int(f1.z);
    const int twh = __float_as_int(f1.w);
    const int tw = max(twh >> 16, 1);
    const int th = max(twh & 0xFFFF, 1);
    const int iu = vrt_floor_mod((int)floorf(u * (float)tw), tw);
    const int iv = vrt_floor_mod((int)floorf(v * (float)th), th);
    const int idx = min(max(toff + iu + iv * tw, 0), n_pool - 1);
    return __ldg(pool + idx);
}

// The candidate's surface at barycentrics (w1, w2): its interpolated uv
// and its alpha, the pool entry of the point-sampled texel.  The slot's
// alpha fields are two float4: (u0, v0, u1, v1) and (u2, v2, texture
// offset bits, tw << 16 | th bits).  The alpha mode compares the alpha
// with its threshold (vrt_alpha_keep); the predicate mode hands all three
// to the compiled predicate (ops/anyhit_pred.py).
__device__ __forceinline__ void vrt_candidate_surface(
        float4 f0, float4 f1, float w1, float w2, const float* pool,
        int n_pool, float& u, float& v, float& alpha) {
    vrt_candidate_uv(f0, make_float2(f1.x, f1.y), w1, w2, u, v);
    alpha = vrt_texel_alpha(f1, u, v, pool, n_pool);
}

// Whether the alpha mode keeps the candidate: !(alpha < thr).
__device__ __forceinline__ bool vrt_alpha_keep(float4 f0, float4 f1, float w1,
                                               float w2, const float* pool,
                                               int n_pool, float thr) {
    float u, v, alpha;
    vrt_candidate_surface(f0, f1, w1, w2, pool, n_pool, u, v, alpha);
    return !(alpha < thr);
}
