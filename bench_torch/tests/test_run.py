"""Whole runs of each cell on the CPU at toy sizes: the result line's shape,
the program coming out correct, and the refusal to run without a card."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
from conftest import ROOT, tiny_cell

from bench_torch import harness

BENCH = harness.load_benchmark()
WORKLOADS = [c["name"] for c in BENCH["workloads"]]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_result_line_shape_and_program_correct(workload, trace, cpu):
    cell = tiny_cell(workload)
    result = harness.run_cell(cell, 2**31 + 17, 0.3, trace, t_start=time.perf_counter(), device=cpu)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    json.dumps(result)  # one JSON object
    expected = cell.per_layer if trace else cell.end_to_end
    units = {m["name"]: m["unit"] for m in expected}
    for name, m in result["metrics"].items():
        assert set(m) == {"value", "unit"} and m["unit"] == units[name]
    if not trace:
        assert set(result["metrics"]) == set(units)
        assert result["metrics"]["setup_s"]["value"] > 0
    else:
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"} and 0 <= c["value"] <= c["limit"]
    assert all(line.startswith("check ") for line in harness.check_lines(result))


def _run_py(cwd, env_extra=None):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", **(env_extra or {})}
    return subprocess.run([sys.executable, "bench_torch/run.py", "--workload", WORKLOADS[0],
                           "--seed", "3", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def _printed_a_result(stdout: str) -> bool:
    lines = stdout.strip().splitlines()
    return bool(lines) and lines[-1].lstrip().startswith("{")


def test_refuses_without_a_card():
    proc = _run_py(ROOT)
    assert proc.returncode != 0 and not _printed_a_result(proc.stdout)
    assert "CUDA" in proc.stderr


def test_refuses_without_the_program(tmp_path):
    # a directory with only BENCHMARK.json and the benchmark's own files
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "bench_torch",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    proc = _run_py(tmp_path)
    assert proc.returncode != 0 and not _printed_a_result(proc.stdout)
