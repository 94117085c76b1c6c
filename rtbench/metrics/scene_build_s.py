"""Host seconds, inside set-up, to turn the cell's meshes into the
program's tables: ``Scene.build`` (the native host build), then
``WavefrontRenderer.from_buffers`` (the wide rows, fused, uploaded)."""


def read(ctx):
    return float(ctx["layer"]["scene_build_s"])
