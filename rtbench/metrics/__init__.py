"""One reader a metric, ``<metric name>.py``, each with ``read(ctx)``:
the metric's value from what the run recorded, or None where it finds
nothing to read (the harness then leaves the metric out of the line).

``ctx`` holds ``window`` (``rtbench.harness.Window``), ``setup_s``,
``prog`` and ``cell``, and in a traced run ``layer``: the profiled
frames' ``trace`` (``rtbench.trace.Trace``), their host ranges
``frames``, the traced window ``lo``..``hi`` and what the harness worked
out beside it (``k1_bounds_ms``, ``scene_build_s``).
"""
