"""Find a cell's parts by name: `BENCHMARK.json` names the workload, its
configuration and its traffic; each lives in a file of its own under the
benchmark's folder, which a later cell adds to without editing:

    configs/<config>.json     the configuration, with its params file
    traffic/<traffic>.json    a traffic mix's parameters; its "entry" names
                              entries/<entry>.py, the driver of the timed path
    limits/<workload>.json    the limits of the numbers `correct` compares
    metrics/<metric>.py       a per-layer metric's reader
"""

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def _reported(metric, workload):
    return "workloads" not in metric or workload in metric["workloads"]


def resolve(workload, spec=None, bench_dir=BENCH_DIR):
    """The Cell of `workload` from `spec` (BENCHMARK.json's contents, read
    from the checkout's root when not given)."""
    spec = load_json(bench_dir.parent / "BENCHMARK.json") if spec is None else spec
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    return Cell(name=workload, chips=int(w["chips"]),
                config=load_json(bench_dir / "configs" / f"{w['config']}.json"),
                traffic=load_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(bench_dir / "limits" / f"{workload}.json"),
                end_to_end=[m for m in spec["end_to_end"] if _reported(m, workload)],
                per_layer=[m for m in spec["per_layer"] if _reported(m, workload)])


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def entry(cell, bench_dir=BENCH_DIR):
    """The module that drives the cell's timed path."""
    name = cell.traffic["entry"]
    return load_module(bench_dir / "entries" / f"{name}.py", f"benchmark_entry_{name}")


def metric_reader(name, bench_dir=BENCH_DIR):
    """A per-layer metric's `read(ctx)`, which returns a number or None."""
    return load_module(bench_dir / "metrics" / f"{name}.py",
                       "benchmark_metric_" + name.replace(".", "_")).read
