"""The harness finds its pieces as files, BENCHMARK.json keeps to the
contract's shapes, and nothing under benchmark/ imports JAX or the JAX
package (CPU)."""

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import run, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_piece_is_a_file():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        spec.config(w["config"])
        spec.traffic(w["traffic"])
        for trace in (False, True):
            for m in spec.metrics_of(bench, w["name"], trace):
                assert callable(spec.reader(m["name"]))
    for c in bench["configs"]:
        assert (spec.ROOT / c["file"]).is_file()


def test_a_cell_added_as_files_is_found(tmp_path):
    """A copy of the benchmark with a traffic mix, a metric and a cell
    added as files and entries, no file edited: the harness finds them."""
    shutil.copytree(spec.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.load_benchmark()
    here = tmp_path / "benchmark"
    t = spec.traffic("stream")
    t["ring_chunks"] = 8
    (here / "traffic" / "stream8.json").write_text(json.dumps(t))
    (here / "metrics" / "chunks_seen.py").write_text(
        "def read(run):\n    return run['chunks']\n")
    bench["workloads"].append({"name": "fx64-ring8", "config": "fx64",
                               "traffic": "stream8", "chips": 1,
                               "why": "a longer ring"})
    bench["end_to_end"].append({"name": "chunks_seen", "unit": "chunks",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["fx64-ring8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    b = spec.load_benchmark(tmp_path)
    cell = spec.cell(b, "fx64-ring8")
    assert spec.traffic(cell["traffic"], here)["ring_chunks"] == 8
    names = [m["name"] for m in spec.metrics_of(b, "fx64-ring8", False)]
    assert sorted(names) == ["chunks_seen", "setup_s"]
    assert spec.reader("chunks_seen", here)({"chunks": 7}) == 7
    with pytest.raises(SystemExit):
        spec.cell(b, "no-such-cell")


def test_a_metric_split_by_cells_reads_its_base_file(tmp_path):
    """``k1_roofline_pct.fx64`` has no file of its own and is read by
    ``k1_roofline_pct.py``; a split that brings its own file is read by
    that one."""
    assert not (spec.HERE / "metrics" / "k1_roofline_pct.fx64.py").exists()
    assert spec.reader("k1_roofline_pct.fx64") is not None
    (tmp_path / "metrics").mkdir()
    for name, value in (("chunks", 1), ("chunks.beam64", 2)):
        (tmp_path / "metrics" / f"{name}.py").write_text(
            f"def read(run):\n    return {value}\n")
    assert spec.reader("chunks.fx64", tmp_path)(None) == 1
    assert spec.reader("chunks.beam64", tmp_path)(None) == 2
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric.fx64", tmp_path)


def test_benchmark_json_shapes():
    bench = spec.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"})):
        for e in bench[group]:
            assert set(e) == keys
            assert NAME.match(e["name"]) and e["name"] not in names
            names.add(e["name"])
            assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e
        for w in m["workloads"]:
            movers = [e for e in bench["end_to_end"]
                      if e["name"] == m["moves"]][0]
            assert w in movers.get("workloads", [w])
    for w in bench["workloads"]:
        assert len(spec.metrics_of(bench, w["name"], False)) >= 2
        assert spec.metrics_of(bench, w["name"], True)
    assert len(json.dumps(bench)) < 64 * 1024


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.partition(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            out.add(node.module.partition(".")[0])
    return out


def test_no_module_imports_jax_or_the_jax_package():
    for path in spec.HERE.rglob("*.py"):
        assert not _imports(path) & set(run.FORBIDDEN), path


def test_forbidden_names_compare_whole():
    saved = dict(sys.modules)
    try:
        sys.modules.pop("dc_sand_tpu", None)
        sys.modules["dc_sand_tpu_torch_fake"] = sys
        assert "dc_sand_tpu" not in run.forbidden_modules()
        sys.modules["dc_sand_tpu.fake"] = sys
        assert "dc_sand_tpu" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_run_loads_no_forbidden_module():
    """A cell's whole run on the CPU at a tiny size, in a fresh process,
    leaves none of jax, jaxlib, flax or dc_sand_tpu loaded."""
    code = (
        "import sys, time\n"
        "from benchmark import harness, run, spec, stream\n"
        "cs = spec.config('fx64')\n"
        "cfg = harness.chain_config('fx64', cs).replace(n_ants=2, "
        "n_chans=32, spectra_per_chunk=16, n_spectra_per_acc=64)\n"
        "stream.run_cell(cfg, cs, spec.traffic('stream'), 3, 0.05, None, "
        "'cpu', time.time())\n"
        "print(run.forbidden_modules())\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=spec.ROOT, timeout=600)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_refuses_without_a_card(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = run.main(["--workload", "fx64-stream", "--seed", "1", "--seconds",
                   "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""
