"""Config 2 of the ladder, as the root ``bench.py`` renders it on a machine
without the teapot OBJ: the Cornell box with ``bench.py``'s sphere
(``bench.py:bench_scene``), the camera and the light of its frame.  The
port's bench entry (``tools/bench.py``), its ladder (``tools/bench_ladder.py``,
rows 1 and 2) and ``chip_smoke.py`` import it from here.

The scene is fixed: the teapot variant waits until its OBJ is in this
repository.  Nothing is downloaded.
"""

from __future__ import annotations

from typing import Tuple

from vortex_rt_tpu_torch.models.procedural import cornell_box, uv_sphere
from vortex_rt_tpu_torch.models.scene import (
    Camera, RenderParams, Scene, SceneBuffers,
)
from vortex_rt_tpu_torch.utils.config import RTConfig

EYE2 = ([0.05, 0.02, -3.2], [0.0, -0.05, 0.0], [0, 1, 0], 45.0, 1.0)
LIGHT2 = (0.0, 0.8, -0.5)
SIZE2 = 512
SCENE2 = "cornell+sphere"


def config2_scene(width: int = 0, leaf: int = 4, sphere_refl: float = 0.0,
                  flatten: bool = True) -> Tuple[SceneBuffers, RTConfig]:
    """``bench.py``'s ``bench_scene``: the Cornell box, then the sphere
    ``uv_sphere((0, -0.3, 0), 0.35, 24, 48)`` with ``sphere_refl``.
    Width 0 is auto (8 when ``flatten``, as ``bench.py`` builds it);
    ``flatten=False`` keeps the TLAS over the BLASes, 4-wide.  Returns
    (buffers, config)."""
    sc = Scene()
    for mesh, refl in cornell_box():
        sc.add_instance(sc.add_mesh(mesh), reflectivity=refl)
    sc.add_instance(sc.add_mesh(uv_sphere((0, -0.3, 0), 0.35, 24, 48)),
                    reflectivity=sphere_refl)
    cfg = RTConfig(flatten=flatten, bvh_width=width, max_leaf_tris=leaf)
    return sc.build(cfg), cfg


def config2_camera() -> Camera:
    """``bench.py``'s camera."""
    return Camera.look_at(*EYE2)


def config2_params(max_depth: int = 2, spp: int = 2) -> RenderParams:
    """``bench.py``'s frame: depth 2, shadow rays, spp 2."""
    return RenderParams(light_pos=LIGHT2, max_depth=max_depth, shadow=True,
                        spp=spp)
