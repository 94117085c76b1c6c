"""Camera and lighting constants as tensors (port of ``CameraArrays`` and
``LightArrays`` of ``vortex_rt_tpu/engine/megakernel.py``).  The
megakernel renderer itself is a cross-check engine not ported yet."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vortex_rt_tpu_torch.models.scene import Camera, RenderParams


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


class CameraArrays(NamedTuple):
    """Camera block: (3,) float32 vectors + (2,) viewplane."""

    pos: torch.Tensor
    forward: torch.Tensor
    right: torch.Tensor
    up: torch.Tensor
    viewplane: torch.Tensor

    @staticmethod
    def from_camera(cam: Camera, device) -> "CameraArrays":
        return CameraArrays(*(_f32(a, device) for a in cam.as_arrays()))


class LightArrays(NamedTuple):
    """Lighting / integrator constants, (3,) float32 each."""

    light_pos: torch.Tensor
    light_color: torch.Tensor
    ambient: torch.Tensor
    background: torch.Tensor

    @staticmethod
    def from_params(p: RenderParams, device) -> "LightArrays":
        return LightArrays(_f32(p.light_pos, device),
                           _f32(p.light_color, device),
                           _f32(p.ambient_color, device),
                           _f32(p.background_color, device))
