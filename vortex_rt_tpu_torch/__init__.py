"""vortex_rt_tpu_torch — the wavefront path tracer in PyTorch and CUDA.

A port of ``vortex_rt_tpu`` (the JAX package, kept beside it as the
reference) to one NVIDIA Hopper GPU.  Module paths mirror the JAX
package so each module's counterpart is easy to find.  The package
imports torch and numpy only; it imports nothing from JAX or from
``vortex_rt_tpu``.

What the port covers: the JAX main path as ``bench.py`` runs it —
flattened builds with 8-wide fused node+leaf rows, every trace wave
through the hand-written CUDA walk ``csrc/traverse_packet.cu`` (K1),
including the merged shadow+bounce wave — and the 4-wide route (flat or
TLAS+BLAS) through ``csrc/packet_walk.cu`` (K2); Whitted shading with
shadow rays and the path-traced frame (``RenderParams(pathtrace=True)``,
``render_accum``); the native host BVH builder (``runtime/native.py``);
the on-device LBVH build and per-frame refit for moving meshes
(``accel/lbvh.py`` over ``csrc/lbvh_karras.cu``, ``lbvh_collapse.cu``,
``lbvh_refit.cu`` and ``lbvh_pack.cu``, K5); the ladder's six rows
(``tools/bench_ladder.py``) and config 2's bench entry (``tools/bench.py``);
any-hit shaders — the alpha cutout tested
inside K1 and K2, every other shader through the per-ray walk with
suspension ``csrc/traverse_wide.cu`` (K3) — with ladder row 6; and the
chained row-fetch probe ``tools/exp_hbm_walk.py`` over
``csrc/hbm_walk.cu`` (K7).  Kernels are built and bound by
``runtime/kernels.py``.  On CPU tensors each kernel's wrapper runs its
plain PyTorch version instead.
"""

from __future__ import annotations

from vortex_rt_tpu_torch.engine.wavefront import WavefrontRenderer
from vortex_rt_tpu_torch.models.scene import Camera, RenderParams, Scene
from vortex_rt_tpu_torch.utils.config import RTConfig

__all__ = ["Camera", "RenderParams", "RTConfig", "Scene", "WavefrontRenderer"]
