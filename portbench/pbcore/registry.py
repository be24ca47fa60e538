"""Find every part of a cell by its name, from files alone.

`BENCHMARK.json` at the checkout's root pairs a configuration with a
traffic mix in each cell. Each part is a file of its own under
`portbench/`, so a later change adds a cell, a metric or a kernel class by
adding files and editing none:

    configs/<config>.json          the model's sizes, precision, deployment
    traffic/<traffic>.json         one traffic mix: its mode and parameters
    modes/<mode>.py                the code that drives one kind of traffic
    workloads/<cell>.json          the cell's correctness limits, the
                                   tolerance of a share of answers off,
                                   its control and faults
    metrics/<metric>.py            a per-layer metric's reader, `read(ctx)`
    kernel_classes/<class>.json    a kernel class and its name patterns
    peaks.json                     the card's peaks, by device name
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parents[1]          # portbench/
ROOT = HERE.parent                                  # the checkout


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, prefix: str) -> ModuleType:
    """Import the Python file at `path` under a private name: files are
    named after metrics and modes, which may hold dots and dashes."""
    name = prefix + "".join(c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of BENCHMARK.json's `workloads` with every file it names."""

    def __init__(self, bench: dict, name: str, base: Path = HERE):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(it has {sorted(cells)})")
        entry = cells[name]
        self.name = name
        self.chips = int(entry["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = load_config(configs[entry["config"]], base)
        self.traffic = _json(base / "traffic" / f"{entry['traffic']}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if _per_layer_applies(m, name, self.end_to_end)]
        spec = base / "workloads" / f"{name}.json"
        self.spec = _json(spec) if spec.exists() else {}
        self.limits: Dict[str, float] = self.spec.get("limits", {})

    @property
    def mode(self) -> str:
        return self.traffic["mode"]


def _per_layer_applies(metric: dict, cell: str, e2e: List[dict]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in {m["name"] for m in e2e}


def load_config(entry: dict, base: Path = HERE) -> dict:
    """The configuration file a BENCHMARK.json `configs` entry names."""
    path = Path(entry["file"])
    if not path.is_absolute():
        path = base.parent / path
    cfg = _json(path)
    cfg["name"] = entry["name"]
    return cfg


def load_benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def load_mode(mode: str, base: Path = HERE) -> ModuleType:
    return load_module(base / "modes" / f"{mode}.py", "pb_mode_")


def load_metric(name: str, base: Path = HERE) -> ModuleType:
    return load_module(base / "metrics" / f"{name}.py", "pb_metric_")


def kernel_classes(base: Path = HERE) -> List[dict]:
    """Every kernel class file, in the order in which a kernel's name is
    tried against them (`order`, then the name)."""
    out = []
    for path in sorted((base / "kernel_classes").glob("*.json")):
        c = _json(path)
        c.setdefault("name", path.stem)
        out.append(c)
    return sorted(out, key=lambda c: (c.get("order", 100), c["name"]))


PLAIN = "other"


def classify(name: str, classes: List[dict]) -> str:
    """The first class whose patterns the kernel's name meets: one of
    `any` (when given), all of `all`, none of `none`, case blind; a
    kernel that meets none is in no class: PLAIN, the plain layers."""
    low = name.lower()
    for c in classes:
        if c.get("any") and not any(p in low for p in c["any"]):
            continue
        if not all(p in low for p in c.get("all", [])):
            continue
        if any(p in low for p in c.get("none", [])):
            continue
        return c["name"]
    return PLAIN


def peaks(device_name: str, base: Path = HERE) -> Optional[dict]:
    """The peaks of the card named `device_name`, or None if the table
    has no such card."""
    table = _json(base / "peaks.json")
    return table.get(device_name)
