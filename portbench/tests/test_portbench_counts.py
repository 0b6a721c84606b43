"""The yardstick's counts against counts by hand at small shapes."""

import numpy as np
import pytest

import tiny  # noqa: F401  (import path)
from counts import flash, model
from harness import model_config, peaks


def brute_pairs(valid, T, causal=True):
    B, S = valid.shape
    return sum(1 for b in range(B) for t in range(T) for s in range(S)
               if valid[b, s] and (not causal or s <= t + S - T))


@pytest.mark.parametrize("T,S", [(5, 5), (3, 7), (8, 8)])
def test_attended_pairs(T, S):
    rng = np.random.default_rng(T * 10 + S)
    valid = (rng.random((2, S)) > 0.3).astype(np.int32)
    assert flash.attended_pairs(valid, T) == brute_pairs(valid, T)
    assert flash.attended_pairs(valid, T, causal=False) == brute_pairs(valid, T, causal=False)


def test_k1_by_hand():
    # B 1, H 2, KV 1, T = S = 2, Dh 4, causal, every key valid: 3 pairs.
    nbytes, flops = flash.k1(1, 2, 1, 2, 2, 4, 3)
    q = o = 1 * 2 * 2 * 4 * 2                 # bf16
    k = v = 1 * 1 * 2 * 4 * 2
    assert nbytes == q + k + v + o + 1 * 2 * 4 + 2 * 1 * 2 * 2 * 4
    assert flops == 2 * (2 * 4 * 3 * 2)       # QK^T and PV, 2 heads, 3 pairs


def test_k2k3_by_hand():
    nbytes, flops = flash.k2k3(1, 2, 1, 2, 2, 4, 3)
    bf = 2 * (1 * 2 * 2 * 4) * 2 + (1 * 2 * 2 * 4) * 2      # q, do in; dq out
    bf += 4 * (1 * 1 * 2 * 4) * 2                           # k, v in; dk, dv out
    assert nbytes == bf + 3 * (1 * 2 * 2) * 4 + 1 * 2 * 4
    assert flops == 5 * (2 * 4 * 3 * 2)


def test_bound_picks_the_larger():
    assert peaks.bound_s(peaks.PEAK_BYTES_PER_S, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 2 * peaks.PEAK_BF16_FLOPS) == pytest.approx(2.0)


def test_model_flops_by_hand():
    cfg = model_config.build(tiny.config(tiny.TRAIN))
    tc = cfg.text_config
    D, H, KV, Dh = 64, 4, 2, 16
    per = (2 * D * (H * Dh + 2 * KV * Dh) + 2 * H * Dh * D + 4 * H * Dh * 3.0 + 2 * D * 7
           + 2.5 * 3 * 2 * D * 96 + 2 * 3 * 2 * D * 48)
    assert model.layer_forward_per_token(tc, 2.5, 3.0) == pytest.approx(per)
    head = 2 * D * 4 * 39
    assert model.decode_row(cfg, 2.5, 3.0) == pytest.approx(2 * per + head)
    B, T = 2, 4
    fwd = B * T * (2 * model.layer_forward_per_token(tc, 2.5, (T + 1) / 2) + head)
    assert model.train_step(cfg, B, T, 2.5) == pytest.approx(3 * fwd)


def test_trace_reduction_by_hand():
    from harness import core

    tr = core.DeviceTrace(False)
    tr.t0, tr.t1 = 0, 100
    tr.events = [("flash_fwd_kernel<128>", 10, 20), ("nvjet_a", 15, 30), ("x_elementwise", 50, 60)]
    out = core.reduce_trace(tr, [("step", 0, 40), ("decode_slot_results", 40, 100)])
    assert out["busy_s"] == pytest.approx(30e-9) and out["window_s"] == pytest.approx(100e-9)
    assert [g[0] for g in out["idle_gaps"]] == ["decode_slot_results", "decode_slot_results",
                                                "step"]
    assert sum(g[1] for g in out["idle_gaps"]) == pytest.approx(70e-9)
    assert out["device_ops"][0] == ["nvjet_a", pytest.approx(15e-9)]
    assert core.kernel_time(out["events"], "flash_fwd_kernel") == (1, pytest.approx(10e-9))


def test_k1_train_reader_by_hand():
    """Launches at exactly their bound read 100 %; at twice it, 50 %."""
    from harness import core

    cfg = model_config.build(tiny.config(tiny.TRAIN))
    tc = cfg.text_config
    B, T = 2, 64
    nbytes, flops = flash.k1(B, tc.num_attention_heads, tc.num_key_value_heads, T, T,
                             tc.head_dim, flash.attended_pairs(np.ones((B, T)), T))
    ns = peaks.bound_s(nbytes, flops) * 1e9
    for scale, want in ((1, 100.0), (2, 50.0)):
        run = core.Run(cell=tiny.TRAIN, seed=0, seconds=1, trace=True, device=None, config={},
                       traffic={}, limits={})
        run.layer.update(cfg=cfg, B=B, T=T, step_s=[1.0], trace={"events": [
            ("void flash_fwd_kernel<64>", 0, scale * ns), ("flash_fwd_kernel", 0, scale * ns)]})
        assert core.read_metric("k1_roofline.train", run) == pytest.approx(want, rel=1e-6)
