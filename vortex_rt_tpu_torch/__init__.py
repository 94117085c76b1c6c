"""vortex_rt_tpu_torch — the wavefront path tracer in PyTorch and CUDA.

A port of ``vortex_rt_tpu`` (the JAX package, kept beside it as the
reference) to one NVIDIA Hopper GPU.  Module paths mirror the JAX
package so each module's counterpart is easy to find.  The package
imports torch and numpy only; it imports nothing from JAX or from
``vortex_rt_tpu``.

What this slice covers: the wavefront main path with 4-wide quantized
BVHs (flat or TLAS+BLAS), Whitted shading with shadow rays, and every
trace wave through one hand-written CUDA BVH walk
(``csrc/packet_walk.cu``, bound by ``runtime/kernels.py``).  On CPU
tensors the walk runs its plain PyTorch version instead.
"""

from __future__ import annotations

from vortex_rt_tpu_torch.engine.wavefront import WavefrontRenderer
from vortex_rt_tpu_torch.models.scene import Camera, RenderParams, Scene
from vortex_rt_tpu_torch.utils.config import RTConfig

__all__ = ["Camera", "RenderParams", "RTConfig", "Scene", "WavefrontRenderer"]
