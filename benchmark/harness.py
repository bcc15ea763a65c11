"""The harness every cell shares: the specification read by name, the
run's context (seed, window, spans, counters, the traced slice), the
reading of a profiler trace, the result line and the checks around it.

Files are found by name, so a later change adds a configuration, a cell,
a traffic driver or a per-layer metric as a new file and an entry:

* ``configs/<config>.json``: the model, its flags and sizes;
* ``traffic/<mix>.json``: a traffic mix, the driver that generates it
  and its parameters (rates, pools, batch, window slices);
* ``workloads/<cell>.json``: a configuration and a traffic mix, the
  chips, the kernels' shapes per item, the limits of the checks;
* ``drivers/<driver>.py``: ``run(ctx) -> Outcome``;
* ``metrics/<metric>.py``: ``read(run) -> float | None``;
* ``BENCHMARK.json`` at the checkout's root: which metrics each cell
  reports.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# modules that no run may hold once its window has closed, by whole
# top-level name: JAX and the JAX package the program was ported from
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "segtran_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A driver or metric module by file, whatever its name's dots."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_" + name.replace(".", "_").replace("-", "_"), path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find(kind: str, name: str, suffix: str, root: Path = BENCH_DIR) -> Path:
    path = root / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return path


def cell_spec(cell: str, root: Path = BENCH_DIR) -> Tuple[dict, dict]:
    """(workload, configuration) of a cell, by name; the workload's
    ``traffic`` becomes its mix's parameters and ``driver`` the mix's
    driver (``traffic/<mix>.json``)."""
    wl = load_json(find("workloads", cell, ".json", root))
    cfg = load_json(find("configs", wl["config"], ".json", root))
    traffic = load_json(find("traffic", wl["traffic"], ".json", root))
    wl = dict(wl, traffic_name=wl["traffic"], driver=traffic.pop("driver"),
              traffic=traffic)
    return wl, cfg


def benchmark_entries(cell: str, root: Path = ROOT) -> Tuple[list, list]:
    """(end_to_end, per_layer) entries of BENCHMARK.json that this cell
    reports: those without ``workloads`` and those that list it."""
    spec = load_json(root / "BENCHMARK.json")

    def mine(e):
        return "workloads" not in e or cell in e["workloads"]
    return ([e for e in spec["end_to_end"] if mine(e)],
            [e for e in spec["per_layer"] if mine(e)])


def process_start_time() -> float:
    """The process's start on the ``time.time()`` clock (Linux), or now."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        ticks = int(fields[19])
        with open("/proc/stat") as f:
            btime = next(int(ln.split()[1]) for ln in f
                         if ln.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def set_cache_dirs(root: Path = ROOT) -> None:
    """Kernel and build caches at fixed paths inside the checkout, so that
    only a checkout's first run builds (the program's CUDA libraries
    already live in ``build/kernels``, keyed by their source's hash)."""
    base = root / "build" / "benchmark"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(base / sub)
    # a library that would load JAX by itself (transformers) stays off it
    os.environ["USE_FLAX"] = "0"


def forbidden_loaded(modules) -> List[str]:
    return sorted({m.split(".", 1)[0] for m in modules}
                  & set(FORBIDDEN_MODULES))


# ------------------------------------------------------------- tracing ----

@dataclasses.dataclass
class Span:
    name: str
    t0: int            # time.time_ns()
    t1: int


class Spans:
    """Host spans around the benchmark's calls into the program, kept in
    memory; recorded only in a traced run."""

    def __init__(self, on: bool):
        self.on = on
        self.items: List[Span] = []

    def wrap(self, name: str, fn: Callable, sync: Optional[Callable] = None):
        if not self.on:
            return fn

        def wrapped(*a, **k):
            if sync is not None:
                sync()
            t0 = time.time_ns()
            try:
                return fn(*a, **k)
            finally:
                if sync is not None:
                    sync()
                self.items.append(Span(name, t0, time.time_ns()))
        return wrapped

    def add(self, name: str, t0: int, t1: int) -> None:
        if self.on:
            self.items.append(Span(name, t0, t1))


@dataclasses.dataclass
class Trace:
    """The device operations of the traced slice: (name, start_ns,
    end_ns) each, and the slice's bounds on the same clock."""
    ops: List[Tuple[str, int, int]]
    t0: int
    t1: int

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        merged: List[List[int]] = []
        for _, a, b in sorted(self.ops, key=lambda o: o[1]):
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def kernel_seconds(self, *substrings: str) -> float:
        """Device seconds of the operations whose name holds one of the
        substrings (their union, so overlapping launches count once)."""
        sub = Trace([o for o in self.ops
                     if any(s in o[0] for s in substrings)], self.t0, self.t1)
        return sub.busy_s

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for name, a, b in self.ops:
            by[name] = by.get(name, 0.0) + (b - a) / 1e9
        return [[k[:160], v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, spans: List[Span], n: int = 10) -> List[list]:
        """Idle device time by the innermost host span open at each gap's
        start ("outside spans" where none is)."""
        busy = self.busy_intervals()
        edges = [self.t0] + [x for ab in busy for x in ab] + [self.t1]
        by: Dict[str, float] = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            open_ = [s for s in spans if s.t0 <= a < s.t1]
            label = (max(open_, key=lambda s: s.t0).name if open_
                     else "outside spans")
            by[label] = by.get(label, 0.0) + (b - a) / 1e9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


class Tracer:
    """torch.profiler over one bounded slice of the window, in a traced
    run only; ``trace`` holds the device operations afterwards."""

    def __init__(self, on: bool):
        self.on = on
        self.trace: Optional[Trace] = None
        self._prof = None
        self._t0 = 0

    def start(self) -> None:
        if not self.on or self._prof is not None:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        # the device's activity only where there is one: recording every
        # host operation too would slow the host the slice measures
        acts = [ProfilerActivity.CUDA if torch.cuda.is_available()
                else ProfilerActivity.CPU]
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.time_ns()

    def stop(self) -> None:
        if self._prof is None:
            return
        import torch
        from torch.autograd import DeviceType
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t1 = time.time_ns()
        self._prof.__exit__(None, None, None)
        ops = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
                continue
            start = e.start_ns()
            ops.append((e.name(), start, start + e.duration_ns()))
        self.trace = Trace(ops, self._t0, t1)
        self._prof = None


# ------------------------------------------------------------- outcome ----

@dataclasses.dataclass
class Check:
    """One number compared with the reference, and its limit (the number
    passes at or under it)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    checks: List[Check]
    memory_peak_bytes: int
    window_s: float
    counters: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, its configuration, the run's
    arguments and the tracing objects."""
    cell: str
    workload: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    t_process: float
    spans: Spans
    tracer: Tracer
    device: Any = None
    faults: Tuple[str, ...] = ()       # tests plant faults by name
    log: Callable[[str], None] = print

    def setup_done(self) -> float:
        """setup_s: process start to now, the first timed request."""
        return time.time() - self.t_process


@dataclasses.dataclass
class Run:
    """What a per-layer metric reader reads."""
    cell: str
    workload: dict
    config: dict
    outcome: Outcome
    spans: Spans
    trace: Optional[Trace]


def seed_parts(seed: int) -> List[int]:
    """A whole-number seed of any size as 32-bit words (for numpy)."""
    seed = int(seed)
    if seed < 0:
        raise ValueError("--seed must be a whole number >= 0")
    words = []
    while seed or not words:
        words.append(seed & 0xFFFFFFFF)
        seed >>= 32
    return words


def torch_seed(seed: int, salt: int = 0) -> int:
    """A 63-bit seed for torch.Generator from any whole number."""
    return (int(seed) * 0x9E3779B97F4A7C15 + salt * 0xBF58476D1CE4E5B9) \
        % (2 ** 63 - 1)


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile (inf where a value is missing)."""
    if not values:
        return float("nan")
    s = sorted(values)
    return s[max(0, math.ceil(q / 100 * len(s)) - 1)]
