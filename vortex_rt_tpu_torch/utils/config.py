"""Framework configuration (port of ``vortex_rt_tpu/utils/config.py``).

Only the knobs this port reads are carried, and the reference's knobs
the JAX package carries as fields without a reader of its own
(``stack_size``, ``max_trail``, ``epsilon``, ``t_max``): they are kept so
that ``as_dict`` and ``from_overrides`` take the same names, and wired
nowhere the JAX package does not wire them.  ``mesh_axes`` is such a
field too: multi-device rendering takes its axes from the mesh it is
given (``parallel.tiles`` for image row blocks, ``parallel.shards`` for
scene shards, on ``torch.distributed``).  ``packet_size`` is carried
with one meaning of the JAX knob only: 0 selects the per-ray engine (the
pool path: ``ops/traverse_wide.trace_lanes``, K3, with any-hit
suspension), and any other value keeps the default route (K1 or K2 over
whole waves); the port walks one ray per GPU thread, so the packet size
itself has no meaning.  The JAX package's other TPU tuning knobs
(``slab``, ``lanes``, ``bounce_packet``, ``bounce_fronts``,
``bounce_sort_seg``, ``shadow_packet``, ``pallas_waves``) shape how XLA
batches a lockstep loop and change no hit; the port's pool runs whole
and has no use for them (README, "The PyTorch/CUDA port").
``fused_rows`` is not carried either: the port always fuses 8- and
16-wide flat builds (the JAX default).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

# Sentinel "no hit" distance (the reference's LARGE_FLOAT).
LARGE_FLOAT = 1e30

# Moller-Trumbore epsilon, matching the reference exactly.
MT_EPSILON = 1e-6

# Commit actions of an any-hit shader (the JAX package's VX_RT_COMMIT_*).
COMMIT_CONT = 0    # reject the pending hit, resume the walk
COMMIT_ACCEPT = 1  # accept the pending hit, resume the walk
COMMIT_TERM = 2    # end the ray


@dataclasses.dataclass(frozen=True)
class RTConfig:
    """Static knobs of the port's tracer."""

    # ---- acceleration structure ----
    bvh_width: int = 0          # children per wide-BVH node, 4, 8 or
                                # 16 (8 and 16 need flatten=True; 16 is
                                # built on the host only); 0 = auto: 8 on
                                # flattened builds, else 4 (the JAX
                                # package's rule)
    stack_size: int = 5         # RT_STACK_SIZE (no reader, as in JAX)
    max_trail: int = 32         # MAX_TRAIL_LEVEL (no reader, as in JAX)
    max_leaf_tris: int = 4      # leaf size target for the binary BVH
    sah_bins: int = 8           # bins of the binned-SAH build
    flatten: bool = False       # ONE world-space BVH over all instances
    use_native_build: bool = True  # csrc/builder.cpp (compiled at first
                                # use; raises if that fails); False = the
                                # NumPy builder

    # ---- wavefront engine ----
    packet_size: int = 256      # 0 = the per-ray engine for every wave
                                # (K3, any-hit by suspension); any other
                                # value = K1 / K2 over whole waves
    queue_capacity: int = 1024  # ShaderQueue capacity of the RT-unit
                                # facade (engine/rtu.py)

    # ---- render parameters ----
    width: int = 256
    height: int = 256
    spp: int = 1
    max_depth: int = 2          # bounce budget (the reference's -d flag)
    tex_filter: str = "point"   # 'point' or 'bilinear' (texSampleBi):
                                # read by WavefrontRenderer.render only,
                                # as in the JAX package
    tile_w: int = 16            # pixel tile of the tile-major lane order
    tile_h: int = 16

    # ---- numerics (no reader in the engine, as in the JAX package) ----
    epsilon: float = MT_EPSILON
    t_max: float = LARGE_FLOAT

    # ---- multi-device (no reader, as in the JAX package) ----
    mesh_axes: Tuple[str, ...] = ("tiles",)

    def __post_init__(self):
        if self.bvh_width == 0:
            object.__setattr__(self, "bvh_width", 8 if self.flatten else 4)
        if self.bvh_width not in (4, 8, 16):
            raise ValueError(
                f"bvh_width must be 0, 4, 8 or 16, got {self.bvh_width}")
        if self.bvh_width != 4 and not self.flatten:
            raise ValueError(f"bvh_width={self.bvh_width} requires "
                             f"flatten=True (no instance-node rows)")
        if self.packet_size < 0:
            raise ValueError("packet_size must be >= 0")
        if self.max_leaf_tris < 1:
            raise ValueError("max_leaf_tris must be >= 1")
        if self.tex_filter not in ("point", "bilinear"):
            raise ValueError(f"tex_filter must be 'point' or 'bilinear', "
                             f"got {self.tex_filter!r}")

    def replace(self, **kw: Any) -> "RTConfig":
        return dataclasses.replace(self, **kw)

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def from_overrides(base: Optional[RTConfig] = None, **kw: Any) -> RTConfig:
    """``CONFIGS="-DNAME=val"``-style overrides of ``base`` (the default
    configuration when None)."""
    return (base or RTConfig()).replace(**kw)
