"""Benchmark of the PyTorch/CUDA port (`unimoe_audio_torch`) on NVIDIA H100s.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of `BENCHMARK.json` from the root of a checkout: set-up,
`--seconds` of measured work, the correctness check against the plain
reference (`portbench/reference/`), and as the last line of standard
output one JSON object: correct, attempted, failed, metrics (the cell's
end-to-end metrics, or with --trace 1 its per-layer ones, read from a
device trace of the window), device, and with --trace 1 a breakdown of the
device's time; last in it, `checks`, each compared number beside its
limit, which also end standard error.  Exits non-zero without a result
when CUDA or the cell's cards are missing, or when JAX or the JAX package
was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")


def _env() -> None:
    """Build caches at fixed paths inside the checkout; the port's banner off."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ.setdefault("UNIMOE_AUDIO_QUIET", "1")
    os.environ["USE_FLAX"] = "0"
    for p in (HERE, ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)


def execute(cell: str, seed: int, seconds: float, trace: bool, device=None,
            config=None, traffic=None, limits=None, spec=None):
    """One run of a cell: the Run record after the driver and the check.
    Tests pass device="cpu" and small configurations; the command line
    never does."""
    import torch

    from harness import core

    spec = spec or core.bench_spec(ROOT)
    w = core.workload(spec, cell)
    config = config or core.load_json(core.find("configs", w["config"]))
    traffic = traffic or core.load_json(core.find("traffic", w["traffic"]))
    limits = limits or core.load_json(core.find("workloads", cell))["limits"]
    run = core.Run(cell=cell, seed=seed, seconds=seconds, trace=trace,
                   device=torch.device(device or "cuda"), config=config, traffic=traffic,
                   limits=limits)
    core.load_module("drivers", traffic["driver"]).run(run)
    return run


def result(run, spec) -> dict:
    """The result object of a run."""
    import torch

    from harness import core, peaks

    metrics = {}
    for m in core.metrics_for(spec, run.cell, run.trace):
        value = run.e2e.get(m["name"]) if not run.trace else core.read_metric(m["name"], run)
        if value is None:
            continue
        if m["unit"] == "%" and value > 100 * peaks.RATE_LIMIT:
            raise RuntimeError(f"{m['name']} reads {value} %, above {100 * peaks.RATE_LIMIT} % "
                               "of its peak: its count or its time is wrong")
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cuda = run.device.type == "cuda"
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": int(run.memory_peak_bytes)}
    out = {"correct": all(c.ok for c in run.checks) and bool(run.checks),
           "attempted": run.attempted, "failed": run.failed, "metrics": metrics,
           "device": device}
    if run.trace:
        tr = run.layer["trace"]
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        out["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
        out["device_classes"] = tr["classes"]
        # The traced window's own end-to-end readings: the tracing's cost.
        out["traced_end_to_end"] = dict(run.e2e)
    out["phases_s"] = dict(run.phases)
    out["readings"] = dict(run.readings)
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in run.checks}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    import torch

    from harness import core

    spec = core.bench_spec(ROOT)
    chips = core.workload(spec, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell {args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run = execute(args.workload, args.seed, args.seconds, bool(args.trace), spec=spec)
    out = result(run, spec)
    bad = core.forbidden_modules(sys.modules)
    if bad:
        print(f"portbench: the run loaded {bad}: the benchmark measures the port alone",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
