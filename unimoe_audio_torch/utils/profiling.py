"""Profiling and timing — counterpart of `unimoe_audio_tpu/utils/profiling.py`:

  * `trace(logdir)`: torch.profiler around a block (CPU and, on the card,
    CUDA activity), written as a Chrome trace, logdir/trace.json;
  * `WallClock`: named phase timers with start / stop / elapsed, where
    `stop(sync=t)` first waits for t's device;
  * `timeit_in_jit`: seconds per call of a function: on the card the replay
    of a CUDA graph of `iters` calls timed by CUDA events (no host gaps
    between the launches), on the CPU `perf_counter` around `iters` calls;
  * `router_stats`: the routing summary of a forward's expert masks and
    top-k counts.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str = "torch-trace"):
    """Profile the enclosed block; on exit write logdir/trace.json (Chrome
    trace format).  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


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
