"""Where the harness finds a cell's pieces, by the names in
``BENCHMARK.json``: the cell's entry there, its configuration in
``configs/<config>.json``, its traffic in ``traffic/<traffic>.json`` and
each metric's reader in ``metrics/<metric>.py``, or, for a metric split
by cells (``k1_roofline_pct.fx64``), in ``metrics/<name before the first
dot>.py`` where the split has no file of its own.  A cell, configuration,
traffic mix or metric is added by adding files and entries; nothing here
names one."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    """The ``workloads`` entry named ``name``; raises naming the cells."""
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json; cells: "
                     + ", ".join(w["name"] for w in bench["workloads"]))


def _data(kind: str, name: str, here: Path) -> dict:
    return json.loads((Path(here) / kind / f"{name}.json").read_text())


def config(name: str, here: Path = HERE) -> dict:
    return _data("configs", name, here)


def traffic(name: str, here: Path = HERE) -> dict:
    return _data("traffic", name, here)


def metrics_of(bench: dict, cell_name: str, trace: bool) -> list:
    """The cell's metrics: with ``trace`` the per-layer ones, else the
    end-to-end ones; a metric without ``workloads`` applies to every
    cell."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if cell_name in m.get("workloads", [cell_name])]


def reader(metric: str, here: Path = HERE):
    """The ``read(run_or_trace)`` function of ``metrics/<metric>.py``, or
    of ``metrics/<metric up to its first dot>.py`` where the first is
    missing."""
    path = Path(here) / "metrics" / f"{metric}.py"
    if not path.is_file():
        path = path.with_name(metric.partition(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
