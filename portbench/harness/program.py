"""The program's own spans and counters (`unimoe_audio_torch.utils.profiling`),
for the per-layer metric readers: what the program recorded in the traced
window, a span's self time, and the device's idle time inside spans.

The program records while a profiler runs in its process, which the
`--trace 1` window's device trace is.  A port without the recorder, or a
window in which it recorded nothing, gives None, and the readers built on
this then read None.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def record(run) -> Optional[Dict]:
    """{"spans": [SpanRecord], "counters": {name: int}} of the window, read
    from the program once per run; None where there is nothing."""
    if "program" not in run.layer:
        rec = None
        if "window_ns" in run.layer:
            try:
                from unimoe_audio_torch.utils import profiling
            except ImportError:
                profiling = None
            recorded = getattr(profiling, "recorded", None)
            if recorded is not None:
                rec = recorded(*run.layer["window_ns"])
                if not rec["spans"] and not any(rec["counters"].values()):
                    rec = None
        run.layer["program"] = rec
    return run.layer["program"]


def named(rec: Dict, name: str) -> List[int]:
    """Indices of the spans called `name`."""
    return [i for i, s in enumerate(rec["spans"]) if s.name == name]


def length_ns(rec: Dict, i: int) -> int:
    s = rec["spans"][i]
    return s.t1_ns - s.t0_ns


def children(rec: Dict) -> Dict[int, List[int]]:
    """Each span's direct children, by index."""
    out: Dict[int, List[int]] = {}
    for i, s in enumerate(rec["spans"]):
        if s.parent is not None:
            out.setdefault(s.parent, []).append(i)
    return out


def self_ns(rec: Dict, i: int, kids: Dict[int, List[int]],
            only: Optional[str] = None) -> int:
    """Span i's length less the part its children cover (only the children
    called `only`, when given).  Children of one span are spans of its
    thread opened and closed inside it, so they do not overlap."""
    return length_ns(rec, i) - sum(length_ns(rec, c) for c in kids.get(i, ())
                                   if only is None or rec["spans"][c].name == only)


def under(rec: Dict, i: int, ancestor: str) -> bool:
    """Whether span i lies inside a span called `ancestor`."""
    p = rec["spans"][i].parent
    while p is not None:
        if rec["spans"][p].name == ancestor:
            return True
        p = rec["spans"][p].parent
    return False


def busy(events: Sequence[Tuple[str, int, int]]) -> Tuple[np.ndarray, np.ndarray]:
    """The union of device activity, as sorted disjoint [start, end)."""
    starts, ends = [], []
    for _, s, e in sorted(events, key=lambda x: x[1]):
        if ends and s <= ends[-1]:
            ends[-1] = max(ends[-1], e)
        else:
            starts.append(s)
            ends.append(e)
    return np.asarray(starts, np.int64), np.asarray(ends, np.int64)


def idle_ns(events, intervals: Sequence[Tuple[int, int]]) -> np.ndarray:
    """Nanoseconds of each [a, b) in which no device activity ran."""
    iv = np.asarray(intervals, np.int64).reshape(-1, 2)
    a, b = iv[:, 0], iv[:, 1]
    starts, ends = busy(events)
    if not len(starts):
        return b - a
    cum = np.concatenate([[0], np.cumsum(ends - starts)])

    def covered_until(t):
        k = np.searchsorted(starts, t, side="right")      # intervals starting at or before t
        over = np.where(k > 0, np.maximum(ends[np.maximum(k - 1, 0)] - t, 0), 0)
        return cum[k] - over

    return (b - a) - (covered_until(b) - covered_until(a))


def decode_steps(rec: Dict) -> List[int]:
    return named(rec, "generate.decode_step")


def host_ms_per_decode_step(run, name: str) -> Optional[float]:
    """Host milliseconds in the spans called `name` that lie inside decode
    steps, over the decode steps of the window."""
    rec = record(run)
    if rec is None or not decode_steps(rec):
        return None
    inside = [i for i in named(rec, name) if under(rec, i, "generate.decode_step")]
    if not inside:
        return None
    return 1e-6 * sum(length_ns(rec, i) for i in inside) / len(decode_steps(rec))


def device_ms_p50(run, name: str) -> Optional[float]:
    """Median device milliseconds of the device-timed spans called `name`."""
    rec = record(run)
    if rec is None:
        return None
    ms = [rec["spans"][i].device_ms for i in named(rec, name)]
    ms = [m for m in ms if m is not None]
    return float(np.median(ms)) if ms else None
