"""Finds a cell's files by the names in ``BENCHMARK.json``.

- a configuration: the ``file`` its ``configs`` entry names (Hugging Face
  keys at the top level, the dtype it is served in, the comparison's
  limits under ``check``), and its architecture's family,
  ``portbench/families/<model_type>.py``;
- a traffic mix: ``portbench/traffic/<traffic>.json`` (lengths, load,
  the engine it runs on, the window's lead-in, the check's sample);
- a metric: ``portbench/metrics/<name>.py``, whose ``read(run)`` returns
  the number or None where it finds nothing to read.

Adding a cell, a configuration, an architecture, a mix or a metric is
adding files and entries: nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

from portbench import families


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list        # BENCHMARK.json entries whose cells include this one
    per_layer: list
    root: Path              # the checkout


def _covers(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    mix = json.loads((root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    family = families.path(config.get("model_type"))
    if not family.is_file():
        raise SystemExit(f"{w['config']}: no family for model_type "
                         f"{config.get('model_type')!r}: {family} is missing")
    if world(mix) > 1 and not hasattr(families.of(config), "mesh_param_specs"):
        raise SystemExit(f"{name} asks for {world(mix)} ranks, but the {config['model_type']} "
                         f"family gives no mesh_param_specs to cut a rank's slice by")
    return Cell(name, w["chips"], config, mix,
                [m for m in bench["end_to_end"] if _covers(m, name)],
                [m for m in bench["per_layer"] if _covers(m, name)], root)


def reader(root: Path, name: str):
    """The ``read`` function of ``portbench/metrics/<name>.py``."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def model_config(cfg: dict):
    """The port's ``ModelConfig`` for a configuration file."""
    return families.of(cfg).model_config(cfg)


def engine_config(mix: dict, flight_events: int = 0):
    """The port's ``EngineConfig`` for a mix's ``engine`` entry."""
    from omnia_tpu_torch.engine.types import EngineConfig

    fields = dict(mix["engine"])
    fields["prefill_buckets"] = tuple(fields["prefill_buckets"])
    return EngineConfig(flight_events=flight_events, **fields)


def world(mix: dict) -> int:
    e = mix["engine"]
    return e.get("dp", 1) * e.get("sp", 1) * e.get("tp", 1)
