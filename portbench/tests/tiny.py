"""Small configurations and mixes of the two cells, for CPU runs of the
whole harness in the tests."""

import copy
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import core  # noqa: E402

TRAIN, SERVE = "train-12l-b8t2048", "t2m-rolling-128"

SMALL = dict(vocab_size=512, hidden_size=64, intermediate_size=256, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, head_dim=16,
             mlp_dynamic_expert_num=4, mlp_dynamic_null_expert_num=1, mlp_fixed_expert_num=2,
             dynamic_intermediate_size=96, shared_intermediate_size=48,
             max_position_embeddings=4096, codec_vocab_size=39, codec_channels=4,
             codec_delay_pattern=[0, 3, 4, 5], codec_eos_value=36, codec_pad_value=37,
             codec_bos_value=38, codec_placeholder_value=511, vision_start_token_id=510,
             vision_end_token_id=509, video_token_id=508, image_token_id=507)


def config(cell: str) -> dict:
    spec = core.bench_spec(ROOT)
    conf = copy.deepcopy(core.load_json(core.find("configs", core.workload(spec, cell)["config"])))
    conf["config"].update(SMALL)
    return conf


def traffic(cell: str) -> dict:
    spec = core.bench_spec(ROOT)
    t = copy.deepcopy(core.load_json(core.find("traffic", core.workload(spec, cell)["traffic"])))
    if cell == TRAIN:
        t.update(batch=2, seq_len=64)
    else:
        t.update(slots=4, chunk_frames=6, budget_frames=[12, 24], fill_frames=[8, 16], cycle=4,
                 warmup_chunks=2, check_requests=2)
    return t


# The training check's numbers at the small size read higher than at the
# cell's (2 layers of width 64 round more per element): sound CPU runs
# read grad_diff_median about 0.04, grad_diff 0.09, grad_gap 0.02 and
# change_gap 0.019.
SMALL_TRAIN_LIMITS = {"grad_diff_median": 0.15, "grad_diff": 0.3, "grad_gap": 0.1,
                      "change_gap": 0.06}


def limits(cell: str) -> dict:
    """Limits for the small sizes: the cell's own names, at the small
    size's values for training, with no token minimum for serving."""
    lim = dict(core.load_json(core.find("workloads", cell))["limits"])
    if cell == TRAIN:
        assert set(lim) == set(SMALL_TRAIN_LIMITS), "the small limits name the cell's numbers"
        return dict(SMALL_TRAIN_LIMITS)
    lim["min_judged_tokens"] = 1
    return lim


def run(cell: str, seed: int = 3, seconds: float = 0.5, trace: bool = False, **kw):
    import run as entry

    return entry.execute(cell, seed, seconds, trace, device="cpu",
                         config=kw.get("config") or config(cell),
                         traffic=kw.get("traffic") or traffic(cell),
                         limits=kw.get("limits") or limits(cell))
