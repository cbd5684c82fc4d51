"""Find a cell's files by the names in BENCHMARK.json.

    portbench/workloads/<cell>.json     the traffic and the limits
    portbench/configs/<config>.json     the sizes
    portbench/drivers/<driver>.py       run(ctx) -> Outcome
    portbench/metrics/<metric>.py       read(record) -> float | None

A later change adds a cell, a configuration, a driver or a metric by
adding its file and its entry in BENCHMARK.json; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _named(kind: str, name: str, suffix: str, base: Path) -> Path:
    if not NAME_RE.match(name):
        raise ValueError(f"{kind} name {name!r} is not a benchmark name")
    path = base / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} file {path}")
    return path


def workload(name: str, base: Path = BENCH_DIR) -> dict:
    return load_json(_named("workloads", name, ".json", base))


def config(name: str, base: Path = BENCH_DIR) -> dict:
    return load_json(_named("configs", name, ".json", base))


def _module(path: Path) -> ModuleType:
    mod_name = "portbench_" + path.parent.name + "_" + re.sub(
        r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, base: Path = BENCH_DIR) -> ModuleType:
    return _module(_named("drivers", name, ".py", base))


def metric(name: str, base: Path = BENCH_DIR) -> ModuleType:
    return _module(_named("metrics", name, ".py", base))


def cell_entry(bench: dict, cell: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"no cell {cell!r} in BENCHMARK.json")


def end_to_end_of(bench: dict, cell: str) -> List[dict]:
    """The end-to-end metrics a cell reports: those without a workloads
    key, and those that list it."""
    return [m for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])]


def per_layer_of(bench: dict, cell: str) -> List[dict]:
    """The per-layer metrics a cell reports: those that list it, and
    those without a workloads key whose `moves` the cell reports."""
    moves = {m["name"] for m in end_to_end_of(bench, cell)}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [])
            or ("workloads" not in m and m["moves"] in moves)]


def read_metrics(entries: List[dict], record: dict,
                 base: Path = BENCH_DIR) -> Dict[str, dict]:
    """Each metric's reader over the run's record; a reader that finds
    nothing to read returns None and the metric is left out."""
    out = {}
    for m in entries:
        value = metric(m["name"], base).read(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
