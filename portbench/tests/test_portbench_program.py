"""The readers of the program's spans and counters (`harness/program.py` and
the metrics built on it): self time and device idle time inside spans on
synthetic spans and device events, each reader's None where its spans are
missing or the port has no recorder, and a small serving and training run
under a CPU profiler, in which the program-span readers read numbers."""

import types

import pytest
from torch.profiler import ProfilerActivity, profile

import tiny
from harness import core, program
from unimoe_audio_torch.utils import profiling
from unimoe_audio_torch.utils.profiling import SpanRecord

SERVE_METRICS = ("decode.step_ms_p50", "decode.issue_ms_p50", "decode.device_idle_share",
                 "moe.host_ms_per_step", "attention.host_ms_per_step", "slot.admit_share",
                 "moe.routed_per_token.serve")
TRAIN_METRICS = ("train.forward_ms", "train.backward_ms", "train.optimizer_ms")


def _span(name, t0, t1, parent=None, rid=None, device_ms=None):
    return SpanRecord(name, t0, t1, parent, rid, device_ms, 1)


def _serving_record():
    """A window [0, 1000) ns: a slot step holding one admission (with its
    prefill) and two decode steps, each with attention, a DCMoE block and
    a stop read."""
    spans = [
        _span("slot.step", 0, 900),                              # 0
        _span("slot.admit", 10, 110, parent=0, rid="a"),         # 1
        _span("generate.prefill", 20, 100, parent=1),            # 2
        _span("model.attention", 30, 40, parent=2),              # 3 (prefill: not a step's)
        _span("generate.decode_step", 200, 400, parent=0),       # 4
        _span("model.attention", 210, 230, parent=4),            # 5
        _span("moe.block", 230, 290, parent=4),                  # 6
        _span("generate.stop_read", 350, 400, parent=4),         # 7
        _span("generate.decode_step", 500, 800, parent=0),       # 8
        _span("model.attention", 510, 540, parent=8),            # 9
        _span("moe.block", 540, 640, parent=8),                  # 10
        _span("generate.stop_read", 700, 800, parent=8),         # 11
    ]
    return {"spans": spans, "counters": {"moe.routed_experts": 30, "moe.routed_tokens": 20}}


def _run(rec, events=(), window=(0, 1000)):
    layer = {"window_ns": window, "program": rec,
             "trace": {"events": list(events), "busy_s": 0.0, "window_s": 1e-6}}
    return types.SimpleNamespace(layer=layer)


def test_self_time_and_ancestry():
    rec = _serving_record()
    kids = program.children(rec)
    assert kids[4] == [5, 6, 7] and kids[0] == [1, 4, 8]
    assert program.self_ns(rec, 4, kids) == 200 - 20 - 60 - 50
    assert program.self_ns(rec, 4, kids, only="generate.stop_read") == 150
    assert program.self_ns(rec, 7, kids) == 50                  # no children
    assert program.under(rec, 5, "generate.decode_step")
    assert not program.under(rec, 3, "generate.decode_step")
    assert program.under(rec, 3, "slot.admit")


def test_idle_inside_spans():
    # Device busy [0, 50), [40, 120) (overlapping) and [300, 350).
    events = [("k", 0, 50), ("k", 40, 120), ("k", 300, 350)]
    got = program.idle_ns(events, [(0, 100), (100, 400), (130, 290), (350, 360), (500, 600)])
    assert got.tolist() == [0, 300 - 20 - 50, 160, 10, 100]
    assert program.idle_ns([], [(5, 9)]).tolist() == [4]


def test_serving_readers_on_synthetic_spans():
    # Busy inside the decode steps: [250, 300) of the first, [500, 800) of
    # the second.
    run = _run(_serving_record(), events=[("k", 250, 300), ("k", 450, 850)])
    got = {m: core.read_metric(m, run) for m in SERVE_METRICS}
    assert got["decode.step_ms_p50"] == pytest.approx(250e-6)
    assert got["decode.issue_ms_p50"] == pytest.approx(175e-6)        # (150 + 200) / 2
    assert got["decode.device_idle_share"] == pytest.approx(150 / 500)
    assert got["moe.host_ms_per_step"] == pytest.approx(80e-6)
    assert got["attention.host_ms_per_step"] == pytest.approx(25e-6)  # the prefill's left out
    assert got["slot.admit_share"] == pytest.approx(0.1)
    assert got["moe.routed_per_token.serve"] == pytest.approx(1.5)


def test_training_readers_take_the_median_device_time():
    spans = [_span("train.step", 0, 100)]
    for k, (fwd, bwd) in enumerate(((3.0, 7.0), (5.0, 9.0), (4.0, 8.0))):
        spans += [_span("train.forward", 10 * k, 10 * k + 2, parent=0, device_ms=fwd),
                  _span("train.backward", 10 * k + 2, 10 * k + 6, parent=0, device_ms=bwd),
                  _span("train.optimizer", 10 * k + 6, 10 * k + 9, parent=0)]
    run = _run({"spans": spans, "counters": {}})
    assert core.read_metric("train.forward_ms", run) == 4.0
    assert core.read_metric("train.backward_ms", run) == 8.0
    assert core.read_metric("train.optimizer_ms", run) is None     # no device time


def test_readers_read_none_without_their_spans():
    no_steps = _serving_record()
    no_steps["spans"] = [s for s in no_steps["spans"] if s.name == "slot.step"]
    no_steps["counters"] = {}
    for rec in (None, no_steps):
        for m in SERVE_METRICS + TRAIN_METRICS:
            assert core.read_metric(m, _run(rec)) is None, m
    # Spans but no device trace: only the idle share needs one.
    run = _run(_serving_record())
    del run.layer["trace"]
    assert core.read_metric("decode.device_idle_share", run) is None
    assert core.read_metric("decode.step_ms_p50", run) is not None


def test_a_port_without_the_recorder_reads_none(monkeypatch):
    monkeypatch.delattr(profiling, "recorded")
    run = types.SimpleNamespace(layer={"window_ns": (0, 10 ** 19)})
    assert program.record(run) is None
    for m in SERVE_METRICS + TRAIN_METRICS:
        assert core.read_metric(m, run) is None, m


@pytest.mark.parametrize("cell", [tiny.SERVE, tiny.TRAIN])
def test_small_runs_under_a_cpu_profiler(cell):
    """The whole small run under a CPU profiler: the program records, and
    the readers find their spans in the window (the device-timed and
    device-trace ones excepted: the CPU has neither)."""
    with profile(activities=[ProfilerActivity.CPU]):
        r = tiny.run(cell, seed=5, seconds=0.5 if cell == tiny.SERVE else 0.3)
    assert all(c.ok for c in r.checks)
    if cell == tiny.SERVE:
        r.layer["trace"] = {"events": []}
        got = {m: core.read_metric(m, r) for m in SERVE_METRICS}
        assert all(v is not None and v > 0 for v in got.values()), got
        assert got["decode.issue_ms_p50"] <= got["decode.step_ms_p50"]
        assert got["decode.device_idle_share"] == 1.0        # no device events
        assert 0 < got["moe.routed_per_token.serve"] <= 4
    else:
        rec = program.record(r)
        steps = program.named(rec, "train.step")
        assert len(steps) == r.layer["steps"]
        assert all(core.read_metric(m, r) is None for m in TRAIN_METRICS)
