"""One run of one cell: set-up, the measured (or traced) window, the
comparison with the plain reference, and the result line.

Everything is found by name, from ``BENCHMARK.json`` at the checkout's root:
the cell names a configuration and a traffic mix; the configuration's file
names its architecture (``programs/<arch>.py``, the system under test, and
``reference/<arch>.py``, its plain reference, weights and counts); the mix's
file names its driver (``drivers/<driver>.py``, the window loop of one kind
of entry); each metric is read by ``metrics/<metric>.py``; the limits of the
numbers compared are in ``limits/<cell>.json``. A new configuration, mix,
cell or metric is a new file and a new entry, and no edit here.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import pathlib
import sys
import time
from dataclasses import dataclass, field

import torch

from bench_torch import trace as tr
from bench_torch.counts import PEAK_FLOPS
from bench_torch.readers import Window

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


class BenchError(RuntimeError):
    """The benchmark cannot run this cell here."""


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _module(path: pathlib.Path):
    if not path.is_file():
        raise BenchError(f"missing {path.relative_to(ROOT)}")
    name = "bench_torch._found." + path.relative_to(HERE).with_suffix("").as_posix().replace("/", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def _json(path: pathlib.Path) -> dict:
    if not path.is_file():
        raise BenchError(f"missing {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def applies(metric: dict, workload: str, reported: set[str]) -> bool:
    """Whether a metric belongs in a cell's line: listed for it, or unlisted
    and (end-to-end) every cell's, or (per-layer) the cell reports what it
    moves."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


@dataclass
class Cell:
    """Everything one cell of ``BENCHMARK.json`` names, found on disk."""

    workload: str
    chips: int
    cfg: dict
    traffic: dict
    driver: object
    program: object
    reference: object
    end_to_end: list[dict]
    per_layer: list[dict]
    limits: dict

    @classmethod
    def find(cls, workload: str, bench: dict | None = None) -> "Cell":
        bench = bench or load_benchmark()
        cells = {c["name"]: c for c in bench["workloads"]}
        if workload not in cells:
            raise BenchError(f"no workload {workload!r} in BENCHMARK.json")
        cell = cells[workload]
        configs = {c["name"]: c for c in bench["configs"]}
        cfg = _json(ROOT / configs[cell["config"]]["file"])
        traffic = _json(HERE / "traffic" / f"{cell['traffic']}.json")
        e2e = [m for m in bench["end_to_end"] if applies(m, workload, set())]
        reported = {m["name"] for m in e2e}
        per_layer = [m for m in bench["per_layer"] if applies(m, workload, reported)]
        limits_path = HERE / "limits" / f"{workload}.json"
        limits = json.loads(limits_path.read_text()) if limits_path.is_file() else {}
        return cls(workload, cell["chips"], cfg, traffic,
                   _module(HERE / "drivers" / f"{traffic['driver']}.py"),
                   _module(HERE / "programs" / f"{cfg['arch']}.py"),
                   _module(HERE / "reference" / f"{cfg['arch']}.py"), e2e, per_layer, limits)

    def reader(self, name: str):
        return _module(HERE / "metrics" / f"{name}.py")


@dataclass
class Run:
    """What a driver gets: the cell's files, the seed, the device, and how
    this run differs from a measured one (the system in the program's place,
    a planted fault)."""

    cell: Cell
    seed: int
    device: torch.device
    trace: bool = False
    # "program", or the plain reference in the program's place: "control" (in
    # the configuration's control_precision) or a precision's name (a witness)
    mode: str = "program"
    fault: str | None = None
    baseline: str = "fp32"  # the precision of the reference the outputs are compared with
    weights: dict = field(default_factory=dict)

    @property
    def cfg(self) -> dict:
        return self.cell.cfg

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    @property
    def program(self):
        return self.cell.program

    @property
    def reference(self):
        return self.cell.reference

    @property
    def precision(self) -> str:
        """The precision of the reference in the program's place."""
        return self.cfg["control_precision"] if self.mode == "control" else self.mode

    def span(self, name: str):
        return tr.span(name, self.trace)


def require_devices(chips: int) -> None:
    """Refuse to run without ``chips`` CUDA devices (there is no CPU fallback)."""
    if not torch.cuda.is_available():
        raise BenchError("torch.cuda.is_available() is false: this benchmark needs a CUDA device")
    if torch.cuda.device_count() < chips:
        raise BenchError(f"{torch.cuda.device_count()} CUDA devices, the cell needs {chips}")


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class GcClock:
    """The garbage collector's milliseconds by generation while registered
    in ``gc.callbacks``: a full collection stalls whatever item it lands in."""

    def __init__(self):
        self.ms = [0.0, 0.0, 0.0]
        self._t0 = 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.ms[info["generation"]] += 1e3 * (time.perf_counter() - self._t0)


def window_line(items: list[dict], gc_ms: list[float]) -> str:
    """The window's items and their spacing on the host's clock, first and
    slowest apart (a first item far above the median is work left out of
    the warm-up), and the collector's time in it."""
    collector = "garbage collection ms by generation " + ", ".join(f"{t:.3f}" for t in gc_ms)
    if not items or "end_s" not in items[0]:  # a training step is not waited on alone
        return f"window: {len(items)} items; {collector}"
    ends = [0.0] + [it["end_s"] for it in items]
    ms = [1e3 * (b - a) for a, b in zip(ends, ends[1:])]
    return (f"window: {len(items)} items in {ends[-1]:.3f} s; ms an item: first {ms[0]:.3f}, "
            f"median {sorted(ms)[len(ms) // 2]:.3f}, slowest {max(ms):.3f}; {collector}")


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *, t_start: float,
             device: torch.device, mode: str = "program", fault: str | None = None,
             baseline: str = "fp32") -> dict:
    """One run; returns the result line's fields, ``checks`` last."""
    # TF32 stays off: no configuration is served in it (it is the fp32 one's control)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = Run(cell, seed, device, trace, mode, fault, baseline)
    marks = [("imports", time.perf_counter())]
    torch.zeros(1, device=device)
    _synchronize(device)
    marks.append(("device context", time.perf_counter()))
    run.weights = cell.reference.make_weights(cell.cfg, seed, device)
    _synchronize(device)
    marks.append(("weights", time.perf_counter()))
    state = cell.driver.setup(run)
    _synchronize(device)
    marks.append(("driver set-up", time.perf_counter()))
    # the full collection that set-up's survivors have made due runs here, not
    # as a stall of ~0.2 s at some point of the window
    gc.collect()
    marks.append(("garbage collection", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    print("set-up: " + ", ".join(f"{name} at {t - t_start:.3f} s" for name, t in marks),
          file=sys.stderr, flush=True)
    collector = GcClock()
    gc.callbacks.append(collector)
    try:
        with tr.record(trace) as capture:
            with tr.span("window", trace):
                items, window_s = cell.driver.window(run, state, seconds)
    finally:
        gc.callbacks.remove(collector)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    print(window_line(items, collector.ms), file=sys.stderr, flush=True)
    if hasattr(cell.driver, "finish"):  # answers due that the window did not reach
        cell.driver.finish(run, state)
    cell.driver.release(state)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = cell.driver.compare(run, state)

    w = Window(cell.cfg, window_s, items, setup_s, cell.reference.flops_per_frame(cell.cfg),
               PEAK_FLOPS[cell.cfg["peak"]], capture.trace)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(m["name"]).read(w)
        if value is None and not trace:
            raise BenchError(f"{m['name']} read nothing in {cell.workload}")
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": False, "attempted": len(items), "failed": 0, "metrics": metrics,
              "device": dev}
    if capture.trace is not None:
        dev["busy_s"] = tr.busy_s(capture.trace)
        dev["window_s"] = capture.trace.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(capture.trace),
                               "idle_gaps": tr.idle_gaps(capture.trace)}
    checks = {name: {"value": value, "limit": cell.limits.get(name)}
              for name, value in numbers.items()}
    result["correct"] = all(c["limit"] is not None and math.isfinite(c["value"])
                            and c["value"] <= c["limit"] for c in checks.values())
    result["checks"] = checks
    return result


def check_lines(result: dict) -> list[str]:
    """One line a compared number, beside its limit."""
    return [f"check {name} = {c['value']!r} (limit {c['limit']!r})"
            for name, c in result["checks"].items()]
