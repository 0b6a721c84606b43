"""Voice-clone TTS of the PyTorch port vs the JAX package on the CPU (f32):
WAV reading at every sample width, resampling and mono mixdown (the host
library's path taken by both packages), the DAC encoder's latents and
codes (through the weight bridge, on a wav resampled from 22,050 Hz), the
placeholder alignment of the prompt's codec rows, `text_to_speech`'s
greedy codes (same token ids, same prompt codes, same weights), its
argument aliases and messages for empty inputs, and `text_to_music`'s
`rebuild_codec` and ignored keywords."""

import dataclasses
import functools
import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unimoe_audio_tpu import api as JAPI
from unimoe_audio_tpu.codec import audio_io as JIO
from unimoe_audio_tpu.codec import dac as JDAC
from unimoe_audio_tpu.codec import native as JNATIVE
from unimoe_audio_tpu.config import tiny_test_config as j_tiny_test_config
from unimoe_audio_tpu.models import model as JM
from unimoe_audio_torch.api import UniMoEAudio
from unimoe_audio_torch.codec import audio_io as TIO
from unimoe_audio_torch.codec import dac as TDAC
from unimoe_audio_torch.codec import native as TNATIVE
from unimoe_audio_torch.codec.dac_wrapper import Dac
from unimoe_audio_torch.config import tiny_test_config
from unimoe_audio_torch.core.bridge import dac_params_from_jax, params_from_jax
from unimoe_audio_torch.models import model as TM

PROMPT_SR = 22050


def _write_raw_wav(path, width, n_ch, n_frames, seed):
    raw = np.random.default_rng(seed).integers(0, 256, size=n_frames * n_ch * width,
                                               dtype=np.uint8).tobytes()
    with wave.open(str(path), "wb") as f:
        f.setnchannels(n_ch)
        f.setsampwidth(width)
        f.setframerate(PROMPT_SR)
        f.writeframes(raw)


def _two_tones(seconds, sr=PROMPT_SR, n_ch=1):
    t = np.arange(int(seconds * sr)) / sr
    x = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 331 * t)
    return np.stack([x * (1 - 0.3 * c) for c in range(n_ch)]).astype(np.float32)


@pytest.mark.parametrize("width", [1, 2, 3, 4])
def test_read_wav_equal_to_jax(tmp_path, width):
    path = tmp_path / f"w{width}.wav"
    _write_raw_wav(path, width, 2, 301, seed=width)
    got, sr = TIO.read_wav(str(path))
    want, want_sr = JIO.read_wav(str(path))
    assert sr == want_sr == PROMPT_SR and got.shape == (2, 301) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_ch,sr_from,sr_to", [(1, 22050, 16000), (2, 44100, 16000),
                                                (1, 8000, 16000), (10, 22050, 16000)])
def test_resample_and_mono_equal_to_jax(n_ch, sr_from, sr_to):
    """Both packages take the same path (the host library where g++ builds
    it, scipy otherwise); more than 8 channels go through scipy."""
    assert TNATIVE.available() == JNATIVE.available()
    x = _two_tones(0.05, sr_from, n_ch)
    x += np.random.default_rng(0).normal(scale=0.05, size=x.shape).astype(np.float32)
    np.testing.assert_allclose(TIO.resample(x, sr_from, sr_to), JIO.resample(x, sr_from, sr_to),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(TIO.resample(x[0], sr_from, sr_to),
                               JIO.resample(x[0], sr_from, sr_to), atol=1e-6, rtol=0)
    np.testing.assert_allclose(TIO.to_mono(x), JIO.to_mono(x), atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def dac_setup():
    cfg = JDAC.tiny_dac_config()
    jp = JDAC.init_dac_params(jax.random.PRNGKey(0), cfg)
    tp = dac_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp, TDAC.DACConfig(**dataclasses.asdict(cfg))


def test_dac_encoder_and_rvq_equal_to_jax(dac_setup):
    cfg, jp, tp, tcfg = dac_setup
    audio = TIO.resample(_two_tones(0.04), PROMPT_SR, cfg.sample_rate)[None]      # [1, 1, T]
    audio = np.concatenate([audio, 0.5 * audio[:, :, ::-1]], 0)                # B = 2
    audio = audio[:, :, : audio.shape[-1] - 3]                                 # not a hop multiple
    x = JDAC.dac_preprocess(jnp.asarray(audio), cfg)
    want_z = np.asarray(JDAC.dac_encoder(jp["encoder"], x, cfg))
    got_z = TDAC.dac_encoder(tp["encoder"], TDAC.dac_preprocess(torch.tensor(audio), tcfg),
                             tcfg).numpy()
    assert got_z.shape == want_z.shape == (2, cfg.latent_dim, -(-audio.shape[-1] // cfg.hop_length))
    np.testing.assert_allclose(got_z, want_z, rtol=1e-5, atol=1e-5)
    want = np.asarray(JDAC.rvq_encode(jp["quantizer"], jnp.asarray(want_z), cfg))
    got = TDAC.rvq_encode(tp["quantizer"], torch.tensor(want_z), tcfg).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        TDAC.dac_encode(tp, torch.tensor(audio), tcfg).numpy(),
        np.asarray(JDAC.dac_encode(jp, jnp.asarray(audio), cfg)))


def test_dac_wrapper_encode_equal_to_jax(tmp_path, dac_setup):
    """`Dac.encode` of a stereo 22,050 Hz wav (mono mixdown, resampling to
    16 kHz, encode) and `encode_array` give the JAX wrapper's codes."""
    from unimoe_audio_tpu.codec.dac_wrapper import Dac as JDac

    cfg, jp, tp, tcfg = dac_setup
    path = str(tmp_path / "prompt.wav")
    x = _two_tones(0.03, n_ch=2)
    TIO.write_wav(path, x, PROMPT_SR)
    jd = JDac(allow_random=True, config=cfg)
    jd.params = jp
    td = Dac(allow_random=True, config=tcfg, device="cpu")
    td.params = tp
    want = jd.encode(path)
    got = td.encode(path)
    assert isinstance(got, list) and len(got[0]) == cfg.n_codebooks
    assert got == want
    np.testing.assert_array_equal(td.encode_array(x, PROMPT_SR), jd.encode_array(x, PROMPT_SR))
    np.testing.assert_array_equal(td.encode_array(x[0], PROMPT_SR),
                                  jd.encode_array(x[0], PROMPT_SR))


def test_align_codec_ids_equal_to_jax():
    ph = 7
    rng = np.random.default_rng(0)
    ids = rng.integers(8, 20, size=(4, 11))
    ids[0, 2:5] = ph
    ids[1, [0, 6, 10]] = ph
    ids[3, 4] = ph
    n = int((ids == ph).sum())
    flat = rng.integers(0, 30, size=(n, 3))
    got = TM.align_codec_ids(ids, flat, ph)
    np.testing.assert_array_equal(got, JM.align_codec_ids(ids, flat, ph))
    np.testing.assert_array_equal(got[ids == ph], flat)
    with pytest.raises(AssertionError, match="placeholder count"):
        TM.align_codec_ids(ids, flat[:-1], ph)


@pytest.fixture(scope="module")
def tts_models():
    """The JAX package's tiny f32 model and the port's, on its weights (DAC
    included), with the same development tokenizer (same process, same word
    ids)."""
    cfg = tiny_test_config()
    jm = JAPI.UniMoEAudio(allow_random=True, config=j_tiny_test_config(), dtype=jnp.float32,
                          max_tokens=24, min_tokens=4)
    tm = UniMoEAudio(allow_random=True, config=cfg, device="cpu", dtype=torch.float32,
                     max_tokens=24, min_tokens=4)
    tree = jax.tree.map(np.asarray, {k: v for k, v in jm.params.items() if k != "vision"})
    tm.params = params_from_jax(tree, cfg, "cpu")
    tm.dac.params = dac_params_from_jax(jax.tree.map(np.asarray, jm.dac.params), device="cpu")
    return cfg, jm, tm


TTS_KW = dict(cfg_scale=1.5, do_sample=False, seed=0, max_audio_seconds=0.48,
              min_audio_seconds=0.1)


def test_text_to_speech_greedy_codes_equal_jax(tmp_path, tts_models):
    """Voice clone from a 22,050 Hz wav: the prompt's codes from each
    package's DAC, their placeholder rows, the CFG-paired prefill and the
    greedy decode give the JAX package's codes, stream for stream."""
    cfg, jm, tm = tts_models
    path = str(tmp_path / "voice.wav")
    TIO.write_wav(path, _two_tones(0.025), PROMPT_SR)
    targets = ["hello there", "a longer sentence for the second stream"]
    want = []
    orig = jm.dac.decode_batch

    def capture(codes_list, save_paths, min_duration=None):
        want.extend(np.asarray(c).T for c in codes_list)
        return orig(codes_list, save_paths, min_duration)

    jm.dac.decode_batch = capture
    jpaths = jm.text_to_speech(targets, prompt_text="the prompt words", prompt_wav=path,
                               output_dir=str(tmp_path / "jax"), **TTS_KW)
    paths = tm.text_to_speech(targets, prompt_text="the prompt words", prompt_wav=path,
                              output_dir=str(tmp_path / "port"), **TTS_KW)
    assert len(paths) == len(jpaths) == 2 and all(os.path.isfile(p) for p in paths)
    assert len(tm.last_codes) == len(want) == 2
    assert tm.last_timings["T_text"] > 64         # the prompt's placeholders fill the bucket
    for got, w in zip(tm.last_codes, want):
        assert got.shape[0] > 0
        np.testing.assert_array_equal(got, w)

    # The same call through the other spellings, and from the prompt's codes.
    codes = tm.dac.encode(path)
    tm.text_to_speech(transcription=targets, prompt_transcription="the prompt words",
                      prompt_codec=codes, output_dir=str(tmp_path / "alias"), **TTS_KW)
    assert tm.last_timings["dac_encode_s"] == 0.0
    for got, w in zip(tm.last_codes, want):
        np.testing.assert_array_equal(got, w)


def test_text_to_speech_empty_inputs(tmp_path, tts_models, capsys):
    _, _, tm = tts_models
    codes = np.zeros((5, tm.config.codec_channels), np.int64)
    assert tm.text_to_speech("", prompt_text="p", prompt_codec=codes) == []
    assert "Please enter the target text." in capsys.readouterr().out
    assert tm.text_to_speech([" ", ""], prompt_text="p", prompt_codec=codes) == []
    assert "Please enter the target text." in capsys.readouterr().out
    assert tm.text_to_speech("a b", prompt_text="p") == []
    assert "Please provide a reference audio file." in capsys.readouterr().out
    assert tm.text_to_speech("a b", prompt_text=" ", prompt_codec=codes) == []
    assert "Please enter the reference audio transcript." in capsys.readouterr().out
    tm_no_dac = UniMoEAudio(allow_random=True, config=tm.config, device="cpu")
    tm_no_dac.dac = None
    with pytest.raises(RuntimeError, match="DAC"):
        tm_no_dac.text_to_speech("a b", prompt_text="p", prompt_wav=str(tmp_path / "x.wav"))


def test_text_to_music_rebuild_and_ignored_keywords(tmp_path, tts_models):
    _, _, tm = tts_models
    rebuild = np.random.default_rng(0).integers(0, 30, size=(9, tm.config.codec_channels))
    paths = tm.text_to_music("calm piano", rebuild_codec=rebuild, unknown_kw=1,
                             output_dir=str(tmp_path), seed=0, max_audio_seconds=0.2,
                             min_audio_seconds=0.1)
    assert len(paths) == 1 and os.path.isfile(paths[0])
    with wave.open(str(tmp_path / "rebuild_music_0.wav")) as f:
        assert f.getnframes() == 9 * tm.dac.config.hop_length


def test_inference_cli_text_to_speech(tmp_path, capsys, monkeypatch):
    """`python -m unimoe_audio_torch.apps.inference --task text_to_speech`
    with random weights on the CPU writes one wav; a missing --ref-text is
    a usage error, a missing reference file a failed generation.  The CLI's
    model is built with a 24-frame budget: at the API's default of 1,000
    frames a random-weight model rarely samples EOS, and decoding and
    writing 1,000 frames on the CPU takes minutes."""
    from unimoe_audio_torch.apps import inference as app

    monkeypatch.setattr(app, "UniMoEAudio",
                        functools.partial(UniMoEAudio, max_tokens=24, min_tokens=4))
    voice = str(tmp_path / "voice.wav")
    TIO.write_wav(voice, _two_tones(0.01), PROMPT_SR)
    argv = ["--task", "text_to_speech", "--input", "hello there", "--ref-audio", voice,
            "--ref-text", "the prompt words", "--output", str(tmp_path / "out"),
            "--allow-random", "--cpu"]
    app.clear_model()
    assert app.main(argv) == 0
    (path,) = os.listdir(tmp_path / "out")
    assert path == "generated_speech_0.wav"
    with pytest.raises(SystemExit):
        app.main(argv[:6] + argv[8:])
    assert app.inference("text_to_speech", "hi", ref_audio=str(tmp_path / "none.wav"),
                         ref_text="p", output_path=str(tmp_path / "out2"), allow_random=True,
                         device="cpu") is None
    assert "does not exist" in capsys.readouterr().out
    app.clear_model()
