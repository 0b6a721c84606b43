"""The benchmark's core: finding a cell's files by name, the run's record
(spans, counters, checks), the device trace's reduction, and the result.

A cell is an entry of `BENCHMARK.json`'s `workloads`: a configuration
(`portbench/configs/<config>.json`) under a traffic mix
(`portbench/traffic/<traffic>.json`, whose `driver` names the general
generator `portbench/drivers/<driver>.py`), with the limits of its
correctness check in `portbench/workloads/<cell>.json`.  A per-layer metric
is read by `portbench/metrics/<metric>.py`.  A later cell, mix or metric
is new files and a new entry of `BENCHMARK.json`; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
# Modules no process that prints a result may hold: JAX and the JAX package
# the port was made from, compared by whole top-level name.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "unimoe_audio_tpu")


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def bench_spec(root: str = ROOT) -> Dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def find(kind: str, name: str, suffix: str = ".json") -> str:
    """The file of a named configuration, traffic mix, cell, driver or
    metric reader under the benchmark's folder."""
    path = os.path.join(BENCH_DIR, kind, name + suffix)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} (looked for {path})")
    return path


def load_module(kind: str, name: str):
    """A driver or metric reader, loaded by path (names may hold dots)."""
    path = find(kind, name, ".py")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def workload(spec: Dict, name: str) -> Dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"BENCHMARK.json has no workload {name!r}")


def metrics_for(spec: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics a run of `cell` reports: the end-to-end ones without the
    trace, the per-layer ones with it; a metric's `workloads` key limits
    it to the cells it lists."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules(modules) -> List[str]:
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN_MODULES})


def process_age_s() -> float:
    """Seconds since this process started (Linux: its start tick against
    the boot clock)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


@dataclass
class Check:
    """One compared number: the reading, its limit, and whether a reading
    above the limit fails the run."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclass
class Run:
    """What a driver is given and what it hands back."""

    cell: str
    seed: int
    seconds: float
    trace: bool
    device: Any
    config: Dict                     # the configuration file
    traffic: Dict                    # the traffic mix's parameters
    limits: Dict                     # the cell's correctness limits
    e2e: Dict[str, float] = field(default_factory=dict)
    layer: Dict[str, Any] = field(default_factory=dict)   # what metric readers read
    checks: List[Check] = field(default_factory=list)
    readings: Dict[str, float] = field(default_factory=dict)   # compared or not
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    spans: List[Tuple[str, int, int]] = field(default_factory=list)
    setup_deduct_s: float = 0.0      # check bookkeeping inside set-up, not set-up itself
    phases: Dict[str, float] = field(default_factory=dict)   # window and reference seconds

    def span(self, name: str):
        return _Span(self, name)

    def check(self, name: str, value: float) -> Optional[Check]:
        """Record a reading; compare it where the cell's limits name it."""
        self.readings[name] = float(value)
        if name not in self.limits:
            return None
        c = Check(name, float(value), float(self.limits[name]))
        self.checks.append(c)
        return c


class _Span:
    def __init__(self, run: Run, name: str):
        self.run, self.name = run, name

    def __enter__(self):
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.run.spans.append((self.name, self.t0, time.time_ns()))
        return False


# -- the device trace -------------------------------------------------------------
class DeviceTrace:
    """torch.profiler over the measured window, device activity only (the
    host's operators are not recorded: at some ten thousand launches a
    decode step their records would cost more than the work).  Kernel,
    copy and memset intervals come back in the host's time.time_ns clock,
    which the profiler's timestamps share."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.t0 = self.t1 = 0
        self.events: List[Tuple[str, int, int]] = []
        self.stop_s = self.read_s = 0.0          # the profiler's stop, reading its records

    def __enter__(self):
        if self.enabled:
            import torch
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
            # The raw records are read below; the profiler's own per-event
            # Python objects (millions in a serving window) are not built.
            self.prof.profiler._parse_kineto_results = lambda *a, **k: []
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self.enabled:
            import torch

            torch.cuda.synchronize()
        self.t1 = time.time_ns()
        if self.prof is not None:
            t = time.perf_counter()
            self.prof.__exit__(None, None, None)
            self.stop_s = time.perf_counter() - t
            self.events = device_events(self.prof)
            self.read_s = time.perf_counter() - t - self.stop_s
        return False


def device_events(prof) -> List[Tuple[str, int, int]]:
    """(name, start ns, end ns) of every device activity of a stopped
    profiler, from its raw kineto records."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            s = e.start_ns()
            out.append((e.name(), s, s + e.duration_ns()))
    out.sort(key=lambda x: x[1])
    return out


def union_ns(intervals: List[Tuple[int, int]]) -> int:
    """Total length of the union of [start, end) intervals sorted by start."""
    total, cur_s, cur_e = 0, None, None
    for s, e in intervals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


# Device operations by kind, for the breakdown (first match wins).
OP_CLASSES = (
    ("attention kernels K1-K3", ("flash_",)),
    ("grouped GEMM K4-K5", ("gmm_wgmma", "tgmm_")),
    ("library GEMM", ("nvjet", "gemm", "cutlass", "cublas", "Kernel2")),
    ("softmax", ("oftMax", "softmax")),
    ("copy, cat, index", ("copy", "Copy", "Cat", "index", "gather", "scatter", "Memcpy",
                          "Memset")),
    ("reduction", ("reduce", "Reduce", "norm")),
    ("elementwise", ("elementwise", "Functor")),
)


def reduce_trace(tr: DeviceTrace, spans: List[Tuple[str, int, int]]) -> Dict:
    """busy / window seconds, the operations that took most device time,
    and the longest idle gaps named by the harness span that held the host
    (the innermost span covering the gap's middle; "untraced host" where
    none does)."""
    import numpy as np

    ev = [(n, max(s, tr.t0), min(e, tr.t1)) for n, s, e in tr.events if e > tr.t0 and s < tr.t1]
    busy = union_ns([(s, e) for _, s, e in ev])
    by_name: Dict[str, int] = {}
    for n, s, e in ev:
        by_name[n] = by_name.get(n, 0) + (e - s)
    top = sorted(by_name.items(), key=lambda x: -x[1])[:10]
    starts = np.array([tr.t0] + [e for _, _, e in ev], np.int64)
    ends = np.array([s for _, s, _ in ev] + [tr.t1], np.int64)
    reach = np.maximum.accumulate(starts)            # device busy until here before the gap
    gap_s, gap_e = reach, ends
    keep = gap_e > gap_s
    gap_s, gap_e = gap_s[keep], gap_e[keep]
    mid = (gap_s + gap_e) // 2
    holder = np.full(mid.shape, -1)
    width = np.full(mid.shape, np.iinfo(np.int64).max)
    names = sorted({n for n, _, _ in spans})
    for n, s, e in spans:
        inside = (mid >= s) & (mid < e) & ((e - s) < width)
        holder[inside] = names.index(n)
        width[inside] = e - s
    label = [names[h] if h >= 0 else "untraced host" for h in holder]
    order = np.argsort(gap_s - gap_e, kind="stable")[:10]
    classes: Dict[str, int] = {}
    for n, t in by_name.items():
        c = next((label for label, keys in OP_CLASSES if any(k in n for k in keys)), "other")
        classes[c] = classes.get(c, 0) + t
    return {
        "busy_s": busy * 1e-9, "window_s": (tr.t1 - tr.t0) * 1e-9, "events": ev,
        "classes": {k: v * 1e-9 for k, v in sorted(classes.items(), key=lambda x: -x[1])},
        "device_ops": [[n, t * 1e-9] for n, t in top],
        "idle_gaps": [[label[i], float(gap_e[i] - gap_s[i]) * 1e-9] for i in order],
        "n_events": len(ev),
    }


def kernel_time(events, needle: str) -> Tuple[int, float]:
    """(launches, seconds) of the device events whose name holds `needle`."""
    hits = [(s, e) for n, s, e in events if needle in n]
    return len(hits), sum(e - s for s, e in hits) * 1e-9


def read_metric(name: str, run: Run) -> Optional[float]:
    """A per-layer metric from its reader, or None where it finds nothing."""
    return load_module("metrics", name).read(run)

