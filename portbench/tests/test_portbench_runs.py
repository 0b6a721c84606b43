"""Whole runs of both cells on the CPU at small sizes: the program against
the plain reference (sound runs come out correct, with small readings),
the faults a cell can have planted underneath its timed path (each comes
out not correct), the control's lower precision separated from sound
runs, and the JAX-free process."""

import subprocess
import sys
import textwrap

import pytest
import torch

import tiny
from harness import core

SEEDS = (3, 4000000007)


def _readings(run):
    return {c.name: c.value for c in run.checks}


@pytest.mark.parametrize("seed", SEEDS)
def test_train_sound_run_is_correct(seed):
    r = tiny.run(tiny.TRAIN, seed=seed, seconds=0.3)
    got = _readings(r)
    assert all(c.ok for c in r.checks), got
    assert r.readings["loss_gap"] < 5e-3
    assert r.e2e["train_tokens_per_s"] > 0 and r.e2e["setup_s"] > 0
    assert r.attempted >= 4 and r.failed == 0


@pytest.mark.parametrize("seed", SEEDS)
def test_serve_sound_run_is_correct(seed):
    r = tiny.run(tiny.SERVE, seed=seed, seconds=1.0)
    assert all(c.ok for c in r.checks), _readings(r)
    assert r.layer["judged_tokens"] > 0 and r.e2e["audio_rtf"] > 0
    assert r.layer["int8_calls"] == r.layer["steps"] * 2 * (4 + 2) * 3


def test_same_seed_same_inputs():
    from drivers.train_steps import batch_at
    from harness import model_config, weights

    cfg = model_config.build(tiny.config(tiny.TRAIN))
    a, b = batch_at(cfg, 9, 2, 2, 8), batch_at(cfg, 9, 2, 2, 8)
    assert all((a[k] == b[k]).all() for k in a)
    pa = weights.make_params(cfg, 9, "cpu")
    pb = weights.make_params(cfg, 9, "cpu")
    for (_, x), (_, y) in zip(weights.walk(pa), weights.walk(pb)):
        assert torch.equal(x, y)


def _tight(cell):
    """The cell's limits at the small size: three times the largest sound
    reading over the test seeds (the cell's own limits are set at its own
    size on the card)."""
    worst = {}
    for seed in SEEDS:
        for c in tiny.run(cell, seed=seed, seconds=0.3 if cell == tiny.TRAIN else 1.0).checks:
            worst[c.name] = max(worst.get(c.name, 0.0), c.value)
    lim = tiny.limits(cell)
    lim.update({k: 3 * v for k, v in worst.items() if k != "short_tokens"})
    return lim


@pytest.fixture(scope="module")
def train_limits():
    return _tight(tiny.TRAIN)


@pytest.fixture(scope="module")
def serve_limits():
    return _tight(tiny.SERVE)


def test_fault_train_state_unchanged(monkeypatch, train_limits):
    from unimoe_audio_torch.train import step

    monkeypatch.setattr(step.AdamW, "update", lambda self, *a, **k: None)
    r = tiny.run(tiny.TRAIN, seconds=0.3, limits=train_limits)
    assert not all(c.ok for c in r.checks)


def test_fault_train_half_batch(monkeypatch, train_limits):
    from unimoe_audio_torch.train import step

    orig = step.loss_fn

    def half(params, cfg, batch, *a, **k):
        n = batch["input_ids"].shape[0] // 2
        return orig(params, cfg, {key: v[:n] for key, v in batch.items()}, *a, **k)

    monkeypatch.setattr(step, "loss_fn", half)
    r = tiny.run(tiny.TRAIN, seconds=0.3, limits=train_limits)
    assert not all(c.ok for c in r.checks)


def test_fault_serve_token_altered(monkeypatch, serve_limits):
    from unimoe_audio_torch.generate import loop

    orig = loop.sample_next_token
    cfg_eos = tiny.SMALL["codec_eos_value"]

    def altered(*a, **k):
        out = orig(*a, **k)
        out[0::4] = (out[0::4] + 1) % cfg_eos
        return out

    monkeypatch.setattr(loop, "sample_next_token", altered)
    r = tiny.run(tiny.SERVE, seconds=1.0, limits=serve_limits)
    assert not all(c.ok for c in r.checks)


def test_fault_serve_cache_unchanged(monkeypatch, serve_limits):
    from unimoe_audio_torch.generate import loop
    from unimoe_audio_torch.models.layers import KVCache

    orig = loop.text_model_forward

    def frozen(params, emb, pos, tc, *, kv_cache=None, **k):
        if kv_cache is not None and emb.shape[1] == 1:
            kv_cache = KVCache(*(None if t is None else t.clone() for t in
                                 (kv_cache.k, kv_cache.v, kv_cache.k_scale, kv_cache.v_scale)))
        return orig(params, emb, pos, tc, kv_cache=kv_cache, **k)

    monkeypatch.setattr(loop, "text_model_forward", frozen)
    r = tiny.run(tiny.SERVE, seconds=1.0, limits=serve_limits)
    assert not all(c.ok for c in r.checks)


def test_train_control_separates(train_limits):
    """The reference in fp8 in the program's place fails a limit set
    between sound readings and it."""
    from drivers.train_steps import batch_at
    from harness import model_config
    from reference import train_check

    conf = tiny.config(tiny.TRAIN)
    cfg = model_config.build(conf)
    t = tiny.traffic(tiny.TRAIN)
    ref = train_check.follow(cfg, conf, 3, torch.device("cpu"), batch_at, t["batch"], t["seq_len"])
    ctl = train_check.follow(cfg, conf, 3, torch.device("cpu"), batch_at, t["batch"], t["seq_len"],
                             lowp="fp8")
    got = train_check.readings(ctl["losses"], ctl["m1"], ctl["d3"], ref, ctl["m1_t"])
    assert any(got[k] > train_limits[k] for k in got if k in train_limits), (got, train_limits)


def test_serve_control_separates(monkeypatch, serve_limits):
    from reference import serve_check

    seen = {}

    def compare(run, cfg, cases, stats_out=None):
        ref = serve_check.logits_of(cfg, run.seed, run.device, cases)
        ctl = serve_check.logits_of(cfg, run.seed, run.device, cases, lowp="int4")
        seen.update(serve_check.readings(serve_check.gaps(cfg, cases, ref, pick=ctl)))

    monkeypatch.setattr(serve_check, "compare", compare)
    tiny.run(tiny.SERVE, seconds=1.0)
    assert any(seen[k] > v for k, v in serve_limits.items() if k in seen), (seen, serve_limits)


def test_no_jax_in_the_process():
    """A whole run of each cell leaves no module whose top-level name is
    JAX's or the JAX package's (compared whole: the port's name begins
    with the JAX package's)."""
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{tiny.HERE!r}]
        import tiny
        from harness import core
        tiny.run(tiny.TRAIN, seconds=0.2)
        tiny.run(tiny.SERVE, seconds=0.5)
        print("FOUND", core.forbidden_modules(sys.modules))
        print("PORT", "unimoe_audio_torch" in sys.modules)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert "FOUND []" in out.stdout and "PORT True" in out.stdout, out.stdout + out.stderr[-2000:]


def test_forbidden_names_compare_whole():
    assert core.forbidden_modules(["unimoe_audio_torch", "unimoe_audio_torch.api", "jaxtyping",
                                   "numpy"]) == []
    assert core.forbidden_modules(["jax.numpy", "unimoe_audio_tpu.api", "flax"]) == \
        ["flax", "jax.numpy", "unimoe_audio_tpu.api"]


@pytest.mark.cuda
def test_cells_run_on_the_card():
    """One short run of each cell on the card, through the command."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for cell in (tiny.TRAIN, tiny.SERVE):
        out = subprocess.run([sys.executable, f"{tiny.BENCH}/run.py", "--workload", cell,
                              "--seed", "5", "--seconds", "5", "--trace", "0"],
                             capture_output=True, text=True, timeout=900)
        assert out.returncode == 0, out.stderr[-3000:]
