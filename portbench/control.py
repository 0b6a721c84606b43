"""The readings that set a cell's correctness limits, on the card at the
cell's own size (not part of a benchmark run):

    python3 portbench/control.py --workload <cell> --seeds 11 12 13 [--seconds 30]

Training cell: for each seed, the reference in float32 against the
control (the reference computed in fp8, `reference/model.Prec`) and
against a planted fault (half of each batch left out, the mean over the
rest), by every number the check can compare (`train_check.readings`).
A state left unchanged reads 1 on the per-leaf numbers without a run.
Serving cell: for each seed a run of the cell with a window of
`--seconds`, then on the check's sample of finished greedy requests the
gap of the token that the control (int4 activations and KV cache) puts
first below the reference's best, beside the served tokens' own gap.
Prints one JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import sys

import run as entry


def train_readings(cell: str, seeds, spec) -> None:
    import torch

    from drivers.train_steps import batch_at
    from harness import core, model_config
    from reference import train_check

    w = core.workload(spec, cell)
    conf = core.load_json(core.find("configs", w["config"]))
    traffic = core.load_json(core.find("traffic", w["traffic"]))
    cfg = model_config.build(conf)
    B, T = traffic["batch"], traffic["seq_len"]
    dev = torch.device("cuda")
    for seed in seeds:
        ref = train_check.follow(cfg, conf, seed, dev, batch_at, B, T)
        out = {"seed": seed}
        for label, kw in (("control_fp8", {"lowp": "fp8"}), ("fault_half_batch", {"rows": B // 2})):
            alt = train_check.follow(cfg, conf, seed, dev, batch_at, B, T, **kw)
            out[label] = train_check.readings(alt["losses"], alt["m1"], alt["d3"], ref,
                                              alt["m1_t"])
            del alt
        print(json.dumps(out), flush=True)


def serve_readings(cell: str, seeds, seconds: float, spec) -> None:
    from reference import serve_check

    seen = {}

    def compare(run, cfg, cases, stats_out=None):
        ref = serve_check.logits_of(cfg, run.seed, run.device, cases)
        ctrl = serve_check.logits_of(cfg, run.seed, run.device, cases, lowp="int4")
        served = serve_check.gaps(cfg, cases, ref)
        control = serve_check.gaps(cfg, cases, ref, pick=ctrl)
        seen.update(seed=run.seed, served=serve_check.readings(served),
                    control=serve_check.readings(control), judged=int(served.numel()),
                    requests=len(cases))

    serve_check.compare = compare
    for seed in seeds:
        entry.execute(cell, seed, seconds, False, spec=spec)
        print(json.dumps(seen), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=30)
    args = ap.parse_args()
    entry._env()
    from harness import core

    spec = core.bench_spec(entry.ROOT)
    driver = core.load_json(core.find("traffic", core.workload(spec, args.workload)["traffic"]))
    if driver["driver"] == "train_steps":
        train_readings(args.workload, args.seeds, spec)
    else:
        serve_readings(args.workload, args.seeds, args.seconds, spec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
