"""Mixed-task batches (`UniMoEAudio.generate_mixed`), the per-request
counter-based draws and the request batcher (`apps/batcher.py`) of the
port, on the CPU: f32, the tiny config with its vision tower, the JAX
package's weights through the bridge and the crc32 tokenizer of
`tests/test_torch_vt2m.py` (never the salted `hash()` ids).

Tolerances: greedy codes are held EQUAL to the JAX package's
`generate_mixed` for a T2M + TTS + VT2M batch and to each request run
alone (torch's CPU GEMMs give the same f32 codes at these batch sizes).
A seeded, sampled request gives EQUAL codes alone and inside a mixed
batch (dense dispatch).  The counter-based uniforms are held by
distribution: a chi-square test against the softmax over 20,000 draws of
one row (p > 1e-4), and correlations between channels and between
consecutive steps within 4.5 standard errors of 0."""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_vt2m import _jax_codes, _videos, stable_tokenizer
from unimoe_audio_torch.api import UniMoEAudio
from unimoe_audio_torch.apps.batcher import RequestBatcher
from unimoe_audio_torch.config import tiny_test_config
from unimoe_audio_torch.core.bridge import dac_params_from_jax, params_from_jax
from unimoe_audio_torch.generate.sampler import counter_uniform, row_keys, sample_next_token
from unimoe_audio_tpu import api as JAPI
from unimoe_audio_tpu.config import tiny_test_config as j_tiny_test_config
from tests.torch_threads import one_torch_thread  # noqa: F401

SECONDS = dict(max_audio_seconds=16 / 50, min_audio_seconds=4 / 50)


@pytest.fixture(scope="module")
def models():
    jcfg = j_tiny_test_config(with_vision=True)
    jm = JAPI.UniMoEAudio(allow_random=True, config=jcfg, dtype=jnp.float32, max_tokens=16,
                          min_tokens=4, tokenizer=stable_tokenizer(jcfg))
    tm = UniMoEAudio(allow_random=True, config=tiny_test_config(with_vision=True), device="cpu",
                     dtype=torch.float32, max_tokens=16, min_tokens=4, tokenizer=jm.tokenizer)
    tm.params = params_from_jax(jax.tree.map(np.asarray, jm.params), tm.config, "cpu")
    tm.dac.params = dac_params_from_jax(jax.tree.map(np.asarray, jm.dac.params), device="cpu")
    return jm, tm


def _requests(cfg):
    codec = np.random.default_rng(1).integers(0, cfg.codec_eos_value,
                                              size=(5, cfg.codec_channels))
    return [
        {"task": "text_to_music", "caption": "calm piano", "cfg_scale": 3.0, **SECONDS},
        {"task": "text_to_speech", "caption": "hello there", "prompt_text": "ref text",
         "prompt_codec": codec, "max_audio_seconds": 12 / 50, "min_audio_seconds": 2 / 50},
        {"task": "video_text_to_music", "caption": "drums", "video": _videos()[0],
         "cfg_scale": 5.0, **SECONDS},
    ]


def test_generate_mixed_greedy_equals_jax(tmp_path, models):
    """A T2M + TTS + VT2M batch, greedy, per-request knobs and budgets:
    codes equal the JAX package's stream for stream; one wav each."""
    jm, tm = models
    reqs = _requests(tm.config)
    want = _jax_codes(jm, "generate_mixed", reqs, output_dir=str(tmp_path / "jax"),
                      do_sample=False, seed=0)
    paths = tm.generate_mixed(reqs, output_dir=str(tmp_path / "port"), do_sample=False, seed=0)
    assert len(paths) == 3 and all(os.path.isfile(p) for p in paths)
    assert len(tm.last_timings["vision_s"]) == 1
    assert [len(c) for c in tm.last_codes] == [len(c) for c in want]
    assert len(tm.last_codes[1]) <= 12 and all(len(c) > 0 for c in tm.last_codes)
    for got, w in zip(tm.last_codes, want):
        np.testing.assert_array_equal(got, w)


def test_generate_mixed_rows_equal_requests_alone(tmp_path, models):
    """Greedy: each row of the mixed batch equals its request run alone
    through generate_mixed (the rows do not interact)."""
    _, tm = models
    reqs = _requests(tm.config)
    tm.generate_mixed(reqs, output_dir=str(tmp_path), do_sample=False, seed=0)
    mixed = tm.last_codes
    for i, r in enumerate(reqs):
        tm.generate_mixed([r], output_dir=str(tmp_path), do_sample=False, seed=0)
        np.testing.assert_array_equal(tm.last_codes[0], mixed[i], err_msg=r["task"])


def test_seeded_sampled_request_is_composition_independent(tmp_path, models):
    """Sampled, dense dispatch: a request with seed 42 gives the same codes
    alone and second in a batch beside another request (its own
    counter-based chain); another seed gives other codes."""
    _, tm = models
    req = {"task": "text_to_music", "caption": "same tune", "seed": 42, **SECONDS}
    other = {"task": "text_to_music", "caption": "different thing", "seed": 7, **SECONDS}
    tm.generate_mixed([req], output_dir=str(tmp_path))
    solo = tm.last_codes[0]
    tm.generate_mixed([other, req], output_dir=str(tmp_path))
    assert solo.shape[0] > 0
    np.testing.assert_array_equal(tm.last_codes[1], solo)
    tm.generate_mixed([{**req, "seed": 43}], output_dir=str(tmp_path))
    assert not np.array_equal(tm.last_codes[0], solo)


def test_counter_draws_follow_the_softmax():
    """20,000 draws of one row (seed 3, channel 0, steps 0..19,999) through
    `sample_next_token` with temperature 0.7 and no top-k: the counts
    match softmax(logits / 0.7) by a chi-square test."""
    from scipy import stats

    V, n = 12, 20_000
    logits = torch.tensor(np.random.default_rng(0).normal(size=V) * 1.5, dtype=torch.float32)
    keys = row_keys(torch.full((n,), 3), torch.arange(n), 1)
    draws = sample_next_token(None, logits[None].expand(n, V), temperature=0.7, top_p=1.0,
                              top_k=None, audio_eos_value=None, keys=keys)
    counts = np.bincount(draws.numpy(), minlength=V)
    p = torch.softmax(logits / 0.7, -1).double().numpy()
    assert stats.chisquare(counts, p / p.sum() * n).pvalue > 1e-4
    # top-k path: only the top 4 ids, in proportion to their renormalized softmax.
    draws = sample_next_token(None, logits[None].expand(n, V), temperature=1.0, top_p=1.0,
                              top_k=4, audio_eos_value=None, keys=keys)
    top = torch.topk(logits, 4).indices.numpy()
    assert set(np.unique(draws.numpy())) <= set(top.tolist())
    pk = torch.softmax(logits[top], -1).double().numpy()
    counts = np.bincount(draws.numpy(), minlength=V)[top]
    assert stats.chisquare(counts, pk / pk.sum() * n).pvalue > 1e-4


def test_counter_uniforms_are_uncorrelated():
    """Uniforms of two channels at the same steps, of one channel at
    consecutive steps and of neighbouring columns: correlations within 4.5
    standard errors (1 / sqrt(n)) of 0; means and variances of U(0, 1)."""
    n = 20_000
    steps = torch.arange(n)
    keys = row_keys(torch.full((n,), 11), steps, 2).reshape(n, 2)
    cols = torch.arange(3)
    u0 = counter_uniform(keys[:, 0], cols).numpy()        # [n, 3]
    u1 = counter_uniform(keys[:, 1], cols).numpy()
    bound = 4.5 / np.sqrt(n)
    for a, b in ((u0[:, 0], u1[:, 0]), (u0[:-1, 0], u0[1:, 0]), (u0[:, 0], u0[:, 1])):
        assert abs(np.corrcoef(a, b)[0, 1]) < bound
    assert u0.min() > 0 and u0.max() < 1
    assert abs(u0.mean() - 0.5) < 4.5 * np.sqrt(1 / 12 / u0.size)
    assert abs(u0.var() - 1 / 12) < 0.005
    # The same (seed, step, channel, column) gives the same uniform.
    np.testing.assert_array_equal(
        counter_uniform(row_keys(torch.tensor([11]), torch.tensor([5]), 2)[1:], cols).numpy(),
        u1[5:6])


def test_batcher_round_trip(tmp_path, models):
    """Three interleaved requests of the three tasks share one
    generate_mixed batch; each Future gets its own wav."""
    _, tm = models
    calls = []
    orig = tm.generate_mixed

    def spy(reqs, **kw):
        calls.append([r["task"] for r in reqs])
        return orig(reqs, **kw)

    tm.generate_mixed = spy
    batcher = RequestBatcher(tm, window_s=0.5, output_dir=str(tmp_path))
    try:
        reqs = _requests(tm.config)
        tts = {k: v for k, v in reqs[1].items() if k != "task"}
        tts["transcription"] = tts.pop("caption")
        futs = [batcher.submit("text_to_music", {**reqs[0], "seed": 5}),
                batcher.submit("text_to_speech", tts),
                batcher.submit("video_text_to_music", {**reqs[2], "max_frames": 2})]
        paths = [f.result(timeout=300) for f in futs]
    finally:
        batcher.close()
        del tm.generate_mixed
    assert len(set(paths)) == 3 and all(p.endswith(".wav") and os.path.isfile(p) for p in paths)
    assert calls == [["text_to_music", "text_to_speech", "video_text_to_music"]]


def test_batcher_per_request_fallback(tmp_path, models):
    """A malformed request fails its own Future at intake; a request that
    fails inside the batch (frames too small for one patch: a request
    error) sends the batch to per-request retries, where only it fails."""
    _, tm = models
    batcher = RequestBatcher(tm, window_s=0.4, output_dir=str(tmp_path))
    try:
        good = {"caption": "fine tune", "seed": 1, **SECONDS}
        bad_video = {"caption": "drums", "video": np.zeros((2, 3, 10, 10), np.float32)}
        futs = [batcher.submit("text_to_music", good),
                batcher.submit("video_text_to_music", bad_video),
                batcher.submit("text_to_music", {"caption": "  "}),
                batcher.submit("text_to_music", {**good, "seed": 2})]
        assert futs[0].result(timeout=300).endswith(".wav")
        assert futs[3].result(timeout=300).endswith(".wav")
        with pytest.raises(ValueError, match="empty caption"):
            futs[2].result(timeout=300)
        with pytest.raises(ValueError, match="reshape"):
            futs[1].result(timeout=300)
    finally:
        batcher.close()
    assert batcher.error is None


def test_batcher_request_input_faults_fail_alone(tmp_path, models, monkeypatch):
    """What a request brings from outside is checked at intake: a missing
    prompt_wav, a prompt_wav that is not a wav and a missing video file
    each fail their own Future with a ValueError, the good request beside
    them completes and the worker keeps running.  A VT2M request on a
    model without a vision tower is a request error too."""
    _, tm = models
    not_wav = tmp_path / "not_a.wav"
    not_wav.write_text("plain text")
    tts = {"caption": "hello there", "prompt_text": "ref text"}
    batcher = RequestBatcher(tm, window_s=0.4, output_dir=str(tmp_path))
    try:
        futs = [batcher.submit("text_to_music", {"caption": "fine tune", "seed": 1, **SECONDS}),
                batcher.submit("text_to_speech", {**tts, "prompt_wav": str(tmp_path / "no.wav")}),
                batcher.submit("text_to_speech", {**tts, "prompt_wav": str(not_wav)}),
                batcher.submit("video_text_to_music",
                               {"caption": "drums", "video": str(tmp_path / "no.mp4")})]
        assert futs[0].result(timeout=300).endswith(".wav")
        for f, msg in zip(futs[1:], ("not a readable wav", "not a readable wav", "not a file")):
            with pytest.raises(ValueError, match=msg):
                f.result(timeout=300)
        assert batcher.submit("text_to_music", {"caption": "again", "seed": 2, **SECONDS}
                              ).result(timeout=300).endswith(".wav")
    finally:
        batcher.close()
    assert batcher.error is None
    monkeypatch.setattr(tm, "params", {k: v for k, v in tm.params.items() if k != "vision"})
    with pytest.raises(ValueError, match="vision tower"):
        tm.generate_mixed([{"task": "video_text_to_music", "caption": "drums",
                            "video": _videos()[0]}], output_dir=str(tmp_path))


def test_batcher_stops_on_a_systemic_error(tmp_path, models):
    """A systemic error (here a stand-in for a CUDA launch failure) is not
    retried request by request: every request of the batch fails with it,
    the worker stops and submit raises."""
    _, tm = models
    started = threading.Event()

    def failing(reqs, **kw):
        started.set()
        raise RuntimeError("flash_attention_fwd launch failed: cudaError 700")

    tm.generate_mixed = failing
    batcher = RequestBatcher(tm, window_s=0.2, output_dir=str(tmp_path))
    try:
        futs = [batcher.submit("text_to_music", {"caption": f"tune {i}"}) for i in range(2)]
        for f in futs:
            with pytest.raises(RuntimeError, match="launch failed"):
                f.result(timeout=60)
        assert started.is_set() and isinstance(batcher.error, RuntimeError)
        with pytest.raises(RuntimeError, match="systemic"):
            batcher.submit("text_to_music", {"caption": "later"})
    finally:
        batcher.close()
        del tm.generate_mixed
