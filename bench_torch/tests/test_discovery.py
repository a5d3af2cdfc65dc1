"""Configs, mixes, drivers, programs, references and metrics are found by
name, and a new one is a new file and a new entry, with no edit."""

import json
import os
import shutil
import subprocess
import sys

import pytest
from conftest import ROOT

from bench_torch import harness

BENCH = harness.load_benchmark()


@pytest.mark.parametrize("workload", [c["name"] for c in BENCH["workloads"]])
def test_every_cell_resolves(workload):
    cell = harness.Cell.find(workload)
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.reader(m["name"]).read)
    for name in ("setup", "window", "release", "compare"):
        assert callable(getattr(cell.driver, name))
    for name in ("make_weights", "frames", "flops_per_frame", "separate"):
        assert callable(getattr(cell.reference, name))
    assert callable(cell.program.build)
    assert "setup_s" in {m["name"] for m in cell.end_to_end}
    assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_every_metric_has_a_reader_and_every_config_its_file():
    names = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    readers = {p.stem for p in (harness.HERE / "metrics").glob("*.py")}
    assert names <= readers
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()


def test_a_new_config_mix_cell_and_metric_are_only_files(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / "bench_torch",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((harness.HERE / "configs" / "upit_blstm.json").read_text())
    (tmp_path / "bench_torch" / "configs" / "upit_blstm_wide.json").write_text(
        json.dumps({**cfg, "hidden": 512}))
    mix = json.loads((harness.HERE / "traffic" / "wsj0_2mix_tt_b256.json").read_text())
    (tmp_path / "bench_torch" / "traffic" / "wsj0_2mix_tt_b16.json").write_text(
        json.dumps({**mix, "batch": 16}))
    (tmp_path / "bench_torch" / "metrics" / "items.count.py").write_text(
        "def read(w):\n    return float(len(w.items))\n")
    bench["configs"].append({"name": "upit_blstm_wide", "source": "x",
                             "file": "bench_torch/configs/upit_blstm_wide.json", "reduced": [],
                             "why": "x"})
    bench["workloads"].append({"name": "wide_separate", "config": "upit_blstm_wide",
                               "traffic": "wsj0_2mix_tt_b16", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "items.count", "unit": "items", "better": "higher",
                               "source": "host_clock", "layer": "x", "moves": "separate_rtf",
                               "workloads": ["wide_separate"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    probe = (
        "from bench_torch import harness\n"
        "cell = harness.Cell.find('wide_separate')\n"
        "print(cell.cfg['hidden'], cell.traffic['batch'], cell.traffic['driver'],\n"
        "      [m['name'] for m in cell.per_layer], cell.reader('items.count').read(\n"
        "      type('W', (), {'items': [1, 2]})()))\n"
    )
    env = {**os.environ, "PYTHONPATH": f"{tmp_path}{os.pathsep}{ROOT}"}
    out = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path, env=env,
                         capture_output=True, text=True, check=True).stdout.split()
    assert out[:3] == ["512", "16", "separate"]
    assert "'items.count']" in out[-2] and out[-1] == "2.0"


def test_a_missing_workload_is_refused():
    with pytest.raises(harness.BenchError):
        harness.Cell.find("no_such_cell")
