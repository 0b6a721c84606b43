"""Device-idle time of one benchmark cell by the program span that held the
host, from a traced run on the card.

    python3 tools/span_breakdown.py --workload <cell> --seed <n> --seconds <s>

Runs the cell as `portbench/run.py --trace 1` does (set-up, the traced
window, the check) and prints its result line, then one JSON object read
from the program's spans (`unimoe_audio_torch.utils.profiling`) against the
window's device trace:

  idle_by_span      device-idle seconds by innermost span of the thread that
                    drives the program ("no span" where none is open);
  idle_s, idle_in_spans_share
                    the window's idle seconds, and the share of them inside
                    some span of that thread;
  spans             each span name's count, host seconds and, for
                    device-timed spans, device seconds;
  counters          the program's counters over the window, beside the
                    reference router's real experts per token where the
                    serving check computed it (`reference_real_k`).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "portbench"))
sys.path.insert(0, ROOT)


def breakdown(run) -> dict:
    """The idle attribution of a finished traced run (see the docstring)."""
    from harness import program

    rec = program.record(run)
    t0, t1 = run.layer["window_ns"]
    events = run.layer["trace"]["events"]
    main = threading.main_thread().native_id
    spans = rec["spans"] if rec else []
    mine = [i for i, s in enumerate(spans) if s.thread == main]
    clip = [(max(spans[i].t0_ns, t0), min(spans[i].t1_ns, t1)) for i in mine]
    idle = program.idle_ns(events, clip) if clip else []
    by_index = dict(zip(mine, (int(x) for x in idle)))
    kids = program.children(rec) if rec else {}
    by_name: dict = {}
    for i in mine:
        own = by_index[i] - sum(by_index.get(c, 0) for c in kids.get(i, ()))
        by_name[spans[i].name] = by_name.get(spans[i].name, 0) + own
    total = int(program.idle_ns(events, [(t0, t1)])[0])
    inside = sum(by_index[i] for i in mine if spans[i].parent is None)
    by_name["no span"] = total - inside
    stats: dict = {}
    for s in spans:
        st = stats.setdefault(s.name, {"count": 0, "host_s": 0.0})
        st["count"] += 1
        st["host_s"] += (s.t1_ns - s.t0_ns) * 1e-9
        if s.device_ms is not None:
            st["device_s"] = st.get("device_s", 0.0) + s.device_ms * 1e-3
    return {"idle_by_span": {k: v * 1e-9 for k, v in sorted(by_name.items(), key=lambda x: -x[1])},
            "idle_s": total * 1e-9, "idle_in_spans_share": inside / total if total else None,
            "spans": stats, "counters": rec["counters"] if rec else {},
            "reference_real_k": run.layer.get("real_k")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import run as entry

    entry._env()
    from harness import core

    spec = core.bench_spec(ROOT)
    run = entry.execute(args.workload, args.seed, args.seconds, True, spec=spec)
    print(json.dumps(entry.result(run, spec)), flush=True)
    print(json.dumps({"span_breakdown": breakdown(run)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
