"""What ``BENCHMARK.json`` names, found by name: a cell's configuration
(``configs/<config>.json`` and the scene module it names), its traffic
mix (``traffic/<traffic>.json``), its correctness limits
(``checks/<workload>.json``) and each metric's reader
(``metrics/<metric>.py``).  Adding any of them takes new files and new
entries in ``BENCHMARK.json`` only.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    config: dict          # configs/<config>.json
    scene: ModuleType     # configs/<config["scene"]>.py
    traffic: dict         # traffic/<traffic>.json
    checks: dict          # checks/<workload>.json
    end_to_end: List[dict]
    per_layer: List[dict]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """The Python file ``path`` as a module (a metric's name may hold
    dots and dashes, which an import name may not)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: Path) -> dict:
    return load_json(Path(root) / "BENCHMARK.json")


def metrics_of(bench: dict, workload: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    whose ``workloads`` list it, or that have no list (a per-layer one
    then goes with every cell that reports the metric it moves)."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if kind == "end_to_end":
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload])
            and m["moves"] in moved]


def load_cell(root: Path, workload: str, harness_dir: Path = HERE) -> Cell:
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    config = load_json(harness_dir / "configs" / f"{w['config']}.json")
    scene = load_module(harness_dir / "configs" / f"{config['scene']}.py",
                        f"rtbench_scene_{config['scene']}")
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                scene=scene,
                traffic=load_json(harness_dir / "traffic"
                                  / f"{w['traffic']}.json"),
                checks=load_json(harness_dir / "checks" / f"{workload}.json"),
                end_to_end=metrics_of(bench, workload, "end_to_end"),
                per_layer=metrics_of(bench, workload, "per_layer"))


def readers(metrics: List[dict], harness_dir: Path = HERE
            ) -> Dict[str, ModuleType]:
    """Each metric's reader, ``metrics/<name>.py``, by name."""
    return {m["name"]: load_module(harness_dir / "metrics"
                                   / f"{m['name']}.py",
                                   f"rtbench_metric_{m['name']}")
            for m in metrics}
