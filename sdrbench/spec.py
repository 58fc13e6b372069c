"""Find each piece of a cell by its name.

``BENCHMARK.json`` names a cell's configuration and traffic. A configuration
is ``configs/<name>.json`` (the file ``BENCHMARK.json`` gives it), a traffic
mix ``traffic/<name>.json``, an entry driver ``entries/<name>.py``, a metric's
reader ``metrics/<name>.py`` (or the reader of the name before its first
dot) and a cell's limits ``limits/<cell>.json``. A later cell, mix, entry or
metric is a new file; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _read_json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """The module ``<kind>/<name>.py`` under the benchmark's folder, or,
    where there is none, ``<kind>/<name before its first dot>.py``: a
    metric split by the end-to-end metric it moves (``idle_share.dev``)
    shares its quantity's reader. A name may hold dots, so the module is
    loaded from its path."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        path = HERE / kind / f"{name.split('.')[0]}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file named {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"sdrbench.{kind}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]

    @property
    def complex_input(self) -> bool:
        return self.config["input"] == "complex_planes"

    @property
    def samples_per_chunk(self) -> int:
        """Input samples a chunk (an IQ sample counts once)."""
        return self.config["channels"] * self.traffic["frames_per_chunk"] * self.config["fft_size"]


def load_benchmark(root: Path = ROOT) -> dict:
    return _read_json(root / "BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``bench`` with its configuration, traffic, limits
    and the metrics it reports: an end-to-end metric without ``workloads``
    is every cell's; a per-layer metric without ``workloads`` is every cell's
    that reports the metric it ``moves``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload named {name!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read_json(root / configs[w["config"]]["file"])
    traffic = _read_json(HERE / "traffic" / f"{w['traffic']}.json")
    limits = _read_json(HERE / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(name, w["chips"], config, traffic, limits, e2e, per_layer)
