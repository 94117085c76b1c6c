"""Faults planted under the timed path, to see that the check fails on
each (the tests under ``rtbench/tests`` and ``rtbench.calibrate
--faults``).  Each is a ``hooks`` dict for ``harness.window``: ``render``
replaces the frame.

- ``stale``: a step that returns its state unchanged: each frame hands
  back the first image it made.
- ``half``: half of the batch left out, the mean taken over the rest:
  each pixel's samples are ``spp // 2`` (the frame renders at that spp).
- ``altered``: an answer altered where it is produced: the frame's image
  times 1.01.
- ``count``: the frame's ray count altered where it is produced: every
  ray counted twice (the configuration states every ray traced counted).

The cells run on one chip, so the exchange between chips left out has no
place here.
"""

from __future__ import annotations

from typing import Dict


def hooks(name: str, prog) -> Dict:
    if name == "stale":
        kept = {}

        def render(wa, i):
            if "out" not in kept:
                kept["out"] = prog.render(wa, i)
            return kept["out"]

        return {"render": render}
    if name == "half":
        return {"render": lambda wa, i: prog.render(
            wa, i, spp=max(prog.traffic["spp"] // 2, 1))}
    if name == "altered":
        def render(wa, i):
            img, rays, steps = prog.render(wa, i)
            return img * 1.01, rays, steps

        return {"render": render}
    if name == "count":
        def render(wa, i):
            img, rays, steps = prog.render(wa, i)
            return img, rays * 2, steps

        return {"render": render}
    raise ValueError(f"unknown fault {name!r}")


NAMES = ("stale", "half", "altered", "count")
