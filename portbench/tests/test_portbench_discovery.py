"""A cell, a configuration, a traffic mix and a metric are found by name:
added as files (and entries in BENCHMARK.json) in a copy of the benchmark,
with no file that is there edited."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture()
def copy(tmp_path):
    """BENCHMARK.json and portbench/ alone, copied to a temporary root."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return tmp_path


def _add_cell(root: Path):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "portbench/configs/fr3_pl_system.json").read_text())
    cfg["name"], cfg["pipeline_depth"] = "fr3_pl_system_d0", 0
    (root / "portbench/configs/fr3_pl_system_d0.json").write_text(json.dumps(cfg))
    traffic = json.loads((root / "portbench/traffic/xyz.json").read_text())
    traffic["motion_scale"] = 2.5
    (root / "portbench/traffic/fast.json").write_text(json.dumps(traffic))
    (root / "portbench/limits/fr3_pl_system_d0.fast.json").write_text(
        (root / "portbench/limits/fr3_pl_system.xyz.json").read_text())
    (root / "portbench/metrics/calls_per_s.py").write_text(
        "def read(rec):\n    return len(rec['calls_ms']) / rec['window_s'] if 'calls_ms' in rec else None\n")
    bench["configs"].append({"name": "fr3_pl_system_d0", "source": "https://example.org/tum3",
                             "file": "portbench/configs/fr3_pl_system_d0.json", "reduced": [], "why": "depth 0"})
    bench["workloads"].append({"name": "fr3_pl_system_d0.fast", "config": "fr3_pl_system_d0", "traffic": "fast",
                               "chips": 1, "why": "fast motion"})
    bench["per_layer"].append({"name": "calls_per_s", "unit": "calls/s", "better": "higher",
                               "source": "program_span", "layer": "facade", "moves": "frames_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_added_files_are_found_without_an_edit(copy):
    before = {p: p.read_bytes() for p in copy.rglob("*") if p.is_file()}
    _add_cell(copy)
    for p, data in before.items():
        if p.name != "BENCHMARK.json":
            assert p.read_bytes() == data, f"{p} was edited"
    cell = harness.Cell("fr3_pl_system_d0.fast", root=copy)
    assert cell.config["pipeline_depth"] == 0 and cell.traffic["motion_scale"] == 2.5
    assert cell.entry().Session.__name__ == "Session"
    names = [m["name"] for m in cell.per_layer]
    assert "calls_per_s" in names  # no `workloads` key: every cell reporting frames_per_s
    rec = dict(calls_ms=[1.0] * 30, window_s=3.0)
    assert cell.reader("calls_per_s").read(rec) == 10.0
    # the cells already there see it too, and keep their own metrics
    old = harness.Cell("fr3_pl_system.xyz", root=copy)
    assert "calls_per_s" in [m["name"] for m in old.per_layer]
    assert "call_ms_p95.system" in [m["name"] for m in old.per_layer]


def test_metric_lists_follow_the_workloads_key():
    cells = {w["name"]: harness.Cell(w["name"]) for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]}
    for name, cell in cells.items():
        assert [m["name"] for m in cell.end_to_end] == ["frames_per_s", "setup_s"]
        per = {m["name"] for m in cell.per_layer}
        assert {"dispatch_ms_per_frame", "device_idle_pct", "launches_per_frame"} <= per
        assert ("chain_ms" in per) == (name != "fr3_pl_system.localize")
        assert ("call_ms_p95.system" in per) == name.startswith("fr3_pl_system")
        for m in cell.per_layer + cell.end_to_end:
            assert cell.reader(m["name"]).read is not None


def test_benchmark_names_a_reader_per_metric():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (ROOT / "portbench/metrics" / f"{m['name']}.py").is_file(), m["name"]
    for w in bench["workloads"]:
        assert (ROOT / "portbench/traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "portbench/limits" / f"{w['name']}.json").is_file()


def test_unknown_cell_gives_no_result(copy):
    with pytest.raises(harness.NoResult):
        harness.Cell("no_such.cell", root=copy)


def test_alone_in_a_directory_it_gives_no_result(copy):
    """BENCHMARK.json and portbench/ alone (no port, no card here): a non-zero
    exit and no result line."""
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "fr3_pl_system.xyz", "--seed", "3",
                        "--seconds", "1", "--trace", "0"], cwd=copy, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout
