// alpha_test.cuh — the alpha-cutout test of a candidate hit inside a walk:
// the alpha mode of K1 (traverse_packet.cu) and K2 (packet_walk.cu).
//
// Replaces the in-loop any-hit predicate of the XLA loop `trace_packets`
// with `alpha_ref` (vortex_rt_tpu/ops/traverse_packet.py:723-761): a
// Moller-Trumbore candidate whose surface alpha is below the threshold is
// rejected before the closest-hit fold (COMMIT_CONT without suspension).
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
// texel (ROADMAP hazard H10).
__device__ __forceinline__ int vrt_floor_mod(int x, int m) {
    return ((x % m) + m) % m;
}

// The slot's alpha fields are two float4: (u0, v0, u1, v1) and
// (u2, v2, texture offset bits, tw << 16 | th bits).  Returns whether the
// candidate at barycentrics (w1, w2) is kept: !(alpha < thr).  A texture
// side of 0 is read as 1, as shade_point clamps it (with_alpha writes
// none).
__device__ __forceinline__ bool vrt_alpha_keep(float4 f0, float4 f1, float w1,
                                               float w2, const float* pool,
                                               int n_pool, float thr) {
    const float bz = 1.0f - w1 - w2;
    const float u = f0.z * w1 + f1.x * w2 + f0.x * bz;
    const float v = f0.w * w1 + f1.y * w2 + f0.y * bz;
    const int toff = __float_as_int(f1.z);
    const int twh = __float_as_int(f1.w);
    const int tw = max(twh >> 16, 1);
    const int th = max(twh & 0xFFFF, 1);
    const int iu = vrt_floor_mod((int)floorf(u * (float)tw), tw);
    const int iv = vrt_floor_mod((int)floorf(v * (float)th), th);
    const int idx = min(max(toff + iu + iv * tw, 0), n_pool - 1);
    return !(__ldg(pool + idx) < thr);
}
