"""Profiling and timing — counterpart of `unimoe_audio_tpu/utils/profiling.py`:

  * `trace(logdir)`: torch.profiler around a block (CPU and, on the card,
    CUDA activity), written as a Chrome trace, logdir/trace.json;
  * `WallClock`: named phase timers with start / stop / elapsed, where
    `stop(sync=t)` first waits for t's device;
  * `timeit_in_jit`: seconds per call of a function: on the card the replay
    of a CUDA graph of `iters` calls timed by CUDA events (no host gaps
    between the launches), on the CPU `perf_counter` around `iters` calls;
  * `router_stats`: the routing summary of a forward's expert masks and
    top-k counts;
  * `span`, `count`, `recorded`: the program's own spans and counters.

Spans and counters record only while a torch.profiler records in the
calling thread (`torch._C._autograd._profiler_enabled()`, which a profiler
of CUDA activity alone sets too); that flag is the only switch.  Off,
`span(name)` hands back one shared no-op context and `count` returns:
one flag check, no allocation, nothing on the device.  On:

  * a span holds its name, start and end on `time.time_ns()` (the clock
    the profiler's device timestamps are read in), its parent (the
    innermost span open in the same thread) and the request id it belongs
    to, if any; `span(name, device=True)` also records a CUDA event pair
    on the current stream, without waiting, which gives the phase's device
    time;
  * `count(name, x)` adds a host int, or the sum of a device tensor (one
    reduction on its device, read later), to the counter;
  * `recorded(t0_ns, t1_ns)` returns the spans that overlap the window,
    with the device milliseconds of device-timed spans, and the counters'
    sums over the calls made in the window: the events and the device sums
    are read there, once.

No site synchronises or reads the device for its span; the spans around
reads the program makes anyway (the decode loop's stop test, the
trainer's log) time those reads.  `trace(logdir)` writes the spans of its
block into the Chrome trace as rows of their own, over the kernels.

The port records `slot.*` spans in `apps/continuous.SlotServer`,
`generate.*` in the decode loop, `model.attention` in each decoder layer,
`moe.block` with the counters `moe.routed_experts` and `moe.routed_tokens`
in the DCMoE block, `codec.dac_decode` where the API writes a stream, and
`train.*` in the trainer; the benchmark's per-layer metrics read them
(`portbench/harness/program.py`).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str = "torch-trace"):
    """Profile the enclosed block; on exit write logdir/trace.json (Chrome
    trace format), the program's spans of the block included, one row per
    recording thread.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        t0 = time.time_ns()
        yield prof
        t1 = time.time_ns()
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    _add_spans(path, recorded(t0, t1)["spans"])


# Rows of the program's spans in a Chrome trace: one synthetic thread id
# per recording thread, above any real one.
_SPAN_ROW = 1 << 30


def _add_spans(path: str, spans: List["SpanRecord"]) -> None:
    """The spans as complete events of the trace at `path`, on its base
    time (kineto writes microseconds after `baseTimeNanoseconds`)."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    rows = {t: _SPAN_ROW + i for i, t in enumerate(dict.fromkeys(s.thread for s in spans))}
    events = doc.setdefault("traceEvents", [])
    for thread, tid in rows.items():
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                       "args": {"name": f"program spans (thread {thread})"}})
    for s in spans:
        args = {} if s.rid is None else {"rid": str(s.rid)}
        if s.device_ms is not None:
            args["device_ms"] = s.device_ms
        events.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
                       "tid": rows[s.thread], "ts": (s.t0_ns - base) / 1e3,
                       "dur": (s.t1_ns - s.t0_ns) / 1e3, "args": args})
    with open(path, "w") as f:
        json.dump(doc, f)


# -- the program's spans and counters -----------------------------------------------
_recording = torch._C._autograd._profiler_enabled
_MAX_RECORDS = 1 << 21         # per list; the oldest half goes when one fills


class SpanRecord(NamedTuple):
    name: str
    t0_ns: int
    t1_ns: int
    parent: Optional[int]        # index of the parent in the same list; None for a root
    rid: object                  # the request's id, where the span is one request's
    device_ms: Optional[float]   # device-timed spans on the card
    thread: int                  # the recording thread's native id


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()
_spans: List["_Span"] = []
_counts: Dict[str, List[tuple]] = {}
_local = threading.local()


def _keep(records: list, item) -> None:
    if len(records) >= _MAX_RECORDS:
        del records[:_MAX_RECORDS // 2]
    records.append(item)


class _Span:
    __slots__ = ("name", "rid", "t0", "t1", "parent", "thread", "events")

    def __init__(self, name: str, rid, device: bool):
        self.name, self.rid, self.t1 = name, rid, None
        self.events = None
        if device and torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            # The native id is a system call, so once per thread.
            stack = _local.stack = []
            _local.native_id = threading.get_native_id()
        self.parent = stack[-1] if stack else None
        self.thread = _local.native_id
        stack.append(self)
        _keep(_spans, self)
        if self.events is not None:
            self.events[0].record()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.time_ns()
        if self.events is not None:
            self.events[1].record()
        _local.stack.pop()
        return False


def span(name: str, rid=None, device: bool = False):
    """A context that records one span while a profiler records (see the
    module's docstring); otherwise the shared no-op."""
    if not _recording():
        return _NO_SPAN
    return _Span(name, rid, device)


def count(name: str, x) -> None:
    """Add x (a host int, or a tensor whose sum is taken on its device)
    to the counter `name` while a profiler records."""
    if not _recording():
        return
    if isinstance(x, torch.Tensor):
        x = x.detach().sum(dtype=torch.int64)
    _keep(_counts.setdefault(name, []), (time.time_ns(), x))


def recorded(t0_ns: int, t1_ns: int) -> Dict[str, object]:
    """{"spans": the closed spans that overlap [t0_ns, t1_ns), in the order
    they opened, as SpanRecords; "counters": each counter's sum over the
    calls made in the window}.  Waits for the device-timed spans' events
    and reads the device sums."""
    keep = [s for s in list(_spans) if s.t1 is not None and s.t1 > t0_ns and s.t0 < t1_ns]
    index = {id(s): i for i, s in enumerate(keep)}
    out = []
    for s in keep:
        ms = None
        if s.events is not None:
            s.events[1].synchronize()
            ms = s.events[0].elapsed_time(s.events[1])
        parent = None if s.parent is None else index.get(id(s.parent))
        out.append(SpanRecord(s.name, s.t0, s.t1, parent, s.rid, ms, s.thread))
    counters = {}
    for name, calls in list(_counts.items()):
        host, by_device = 0, {}
        for t, x in calls:
            if t0_ns <= t < t1_ns:
                if isinstance(x, torch.Tensor):
                    by_device.setdefault(x.device, []).append(x)
                else:
                    host += int(x)
        counters[name] = host + sum(int(torch.stack(xs).sum()) for xs in by_device.values())
    return {"spans": out, "counters": counters}


def _sync(t: Optional[torch.Tensor]) -> None:
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)


class WallClock:
    """Named wall-clock phase timers: `clock(name).start()`, `.stop()`,
    `.elapsed()`, or `with clock(name):`."""

    def __init__(self):
        self._start: Dict[str, float] = {}
        self._elapsed: Dict[str, float] = {}

    def __call__(self, name: str) -> "WallClock._Phase":
        return WallClock._Phase(self, name)

    class _Phase:
        def __init__(self, clock: "WallClock", name: str):
            self.clock, self.name = clock, name

        def start(self):
            self.clock._start[self.name] = time.perf_counter()
            return self

        def stop(self, sync: Optional[torch.Tensor] = None) -> float:
            """Seconds since start, added to the phase; with sync, after
            the work queued on sync's device has finished."""
            _sync(sync)
            dt = time.perf_counter() - self.clock._start[self.name]
            self.clock._elapsed[self.name] = self.clock._elapsed.get(self.name, 0.0) + dt
            return dt

        def elapsed(self, reset: bool = True) -> float:
            v = self.clock._elapsed.get(self.name, 0.0)
            if reset:
                self.clock._elapsed[self.name] = 0.0
            return v

        def __enter__(self):
            return self.start()

        def __exit__(self, *exc):
            self.stop()


def timeit_in_jit(fn: Callable, *args, iters: int = 8) -> float:
    """Seconds per call of fn(*args), after two warm-up calls.  CUDA tensor
    arguments: one CUDA graph holds `iters` calls and its replay is timed
    by CUDA events (the best of three replays).  CPU tensors: perf_counter
    around `iters` calls.  Arguments on no device are refused."""
    devices = {a.device.type for a in args if isinstance(a, torch.Tensor)}
    if devices not in ({"cuda"}, {"cpu"}):
        raise ValueError(f"timeit_in_jit needs tensor arguments on one device type, got "
                         f"{sorted(devices) or 'none'}")
    if devices == {"cpu"}:
        fn(*args)
        fn(*args)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn(*args)
    g.replay()
    best = float("inf")
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3 / iters)
    return best


def router_stats(expert_mask, router_top_k, num_dynamic: int) -> Dict[str, object]:
    """Routing summary (`profiling.py:95-112`): expert_mask [L, S, E] and
    router_top_k [L, S] (tensors or arrays) → mean top-k, its histogram,
    each dynamic expert's load, the load's coefficient of variation and the
    per-layer mean top-k."""
    def host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    dyn = host(expert_mask)[..., :num_dynamic]
    topk = host(router_top_k)
    load = dyn.sum(axis=(0, 1))
    return {
        "mean_top_k": float(topk.mean()),
        "top_k_histogram": {int(k): int(v) for k, v in zip(*np.unique(topk, return_counts=True))},
        "expert_load": load.astype(int).tolist(),
        "expert_load_cv": float(load.std() / max(load.mean(), 1e-9)),
        "per_layer_mean_k": topk.mean(axis=1).tolist(),
    }
