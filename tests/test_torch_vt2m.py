"""Video+text-to-music of the PyTorch port vs the JAX package on the CPU
(f32, tiny config with its vision tower, the same weights through the
bridge): `model_forward` with video patches, `generate` and
`generate_chunked` with the four vision inputs across a chunk boundary,
`UniMoEAudio.video_text_to_music` (default and int8 serving, the latter
loaded from a snapshot the JAX package wrote), the fallback without a
tower, the port's own snapshot with the int8 tower, the random init with
and without a tower, and the CLI's `video_text_to_music` task."""

import copy
import functools
import os
import re
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unimoe_audio_tpu import api as JAPI
from unimoe_audio_tpu.codec import delay as JDL
from unimoe_audio_tpu.config import tiny_test_config as j_tiny_test_config
from unimoe_audio_tpu.generate import loop as JLOOP
from unimoe_audio_tpu.models import model as JM
from unimoe_audio_tpu.models import vision as JV
from unimoe_audio_torch.api import SPECIAL_TOKENS, UniMoEAudio
from unimoe_audio_torch.apps import video as TVID
from unimoe_audio_torch.config import tiny_test_config
from unimoe_audio_torch.core.bridge import dac_params_from_jax, params_from_jax
from unimoe_audio_torch.generate import loop as TLOOP
from unimoe_audio_torch.models import model as TM
from unimoe_audio_torch.ops.quant import QTensor
from unimoe_audio_torch.tokenizer import SimpleTokenizer

ATOL = 1e-4          # tests/test_torch_model.py's f32 tolerance
GREEDY = dict(min_tokens=4, cfg_scale=3.0, temperature=1.0, top_p=1.0, cfg_filter_top_k=16,
              eos_prob_mul_factor=1.0)

# Two pre-extracted videos of different grids: 2 frames of 56 x 56 (grid
# 1 x 4 x 4, 4 video tokens, one window) and 3 frames of 140 x 112 (the odd
# frame repeated: grid 2 x 10 x 8, 40 tokens, ragged windows).
VIDEO_SHAPES = [(2, 3, 56, 56), (3, 3, 140, 112)]


def _videos(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 255, size=s).astype(np.float32) for s in VIDEO_SHAPES]


class StableTokenizer(SimpleTokenizer):
    """The development tokenizer with word ids from crc32 in place of
    Python's per-process salted hash(), so that the prompts, and the codes
    they lead to, are the same in every test process."""

    def _encode(self, text):
        ids = []
        for part in re.split("(" + "|".join(map(re.escape, self.special)) + ")", text):
            if part in self.special:
                ids.append(self.special[part])
            elif part:
                ids += [10 + zlib.crc32(w.encode()) % (self.vocab_size - 20) for w in part.split()]
        return ids


def stable_tokenizer(cfg):
    """The API's development special-token ids (`UniMoEAudio.__init__`)."""
    special = {t: 100 + i for i, t in enumerate(SPECIAL_TOKENS)}
    special.update({"<|AUDIO_PLACEHOLDER|>": cfg.codec_placeholder_value,
                    "<|vision_start|>": cfg.vision_start_token_id,
                    "<|vision_end|>": cfg.vision_end_token_id,
                    "<|video_pad|>": cfg.video_token_id})
    return StableTokenizer(vocab_size=min(cfg.text_config.vocab_size, 10000), special=special)


@pytest.fixture(scope="module")
def jax_model():
    """The JAX package's tiny f32 API model with random weights (its tower
    included), a 16-frame budget and the stable tokenizer."""
    cfg = j_tiny_test_config(with_vision=True)
    return JAPI.UniMoEAudio(allow_random=True, config=cfg, dtype=jnp.float32, max_tokens=16,
                            min_tokens=4, tokenizer=stable_tokenizer(cfg))


@pytest.fixture(scope="module")
def setup(jax_model):
    cfg = tiny_test_config(with_vision=True)
    jp = jax_model.params
    return cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")


def _rows(cfg, n_tokens, pads, seed):
    """One CFG pair per video: [text, <vision_start>, n video tokens,
    <vision_end>, text] rows behind their left pads, in a common width."""
    rng = np.random.default_rng(seed)
    rows = []
    for n, pad in zip(n_tokens, pads):
        row = (list(rng.integers(5, 200, 4)) + [cfg.vision_start_token_id]
               + [cfg.video_token_id] * n + [cfg.vision_end_token_id]
               + list(rng.integers(5, 200, 5)))
        rows.append(row)
    T = max(len(r) + p for r, p in zip(rows, pads))
    ids = np.zeros((len(rows), T), np.int32)
    mask = np.zeros((len(rows), T), np.int32)
    for i, r in enumerate(rows):
        ids[i, T - len(r):] = r
        mask[i, T - len(r):] = 1
    return ids, mask


def _patches():
    """Each video's flattened patches and grid."""
    return [TVID.video_to_patches(v) for v in _videos()]


def test_model_forward_with_video_equals_jax(setup):
    """Video patches through the tower, scattered at the video-token slots
    of two rows (one per video, the second left-padded), with and without
    get_rope_index positions: codec logits and the codec loss within the
    f32 tolerance."""
    cfg, jp, tp = setup
    out = _patches()
    patches, grids = np.concatenate([p for p, _ in out]), np.stack([g for _, g in out])
    ids, mask = _rows(cfg, [4, 40], [0, 0], seed=1)
    ids = np.concatenate([np.zeros((2, 3), np.int32), ids], 1)
    mask = np.concatenate([np.zeros((2, 3), np.int32), mask], 1)
    mask[0, :3] = 1
    rng = np.random.default_rng(2)
    labels = rng.integers(0, cfg.codec_eos_value, size=ids.shape + (cfg.codec_channels,))
    labels[:, :10] = -100
    pos, _ = JM.get_rope_index(ids, j_tiny_test_config(with_vision=True),
                               video_grid_thw=grids, attention_mask=mask)
    for position_ids in (None, pos):
        jout = JM.model_forward(
            jp, j_tiny_test_config(with_vision=True), jnp.asarray(ids),
            attention_mask=jnp.asarray(mask), codec_labels=jnp.asarray(labels),
            pixel_values_videos=jnp.asarray(patches), video_grid_thw=grids,
            position_ids=None if position_ids is None else jnp.asarray(position_ids))
        tout = TM.model_forward(
            tp, cfg, torch.tensor(ids), attention_mask=torch.tensor(mask),
            codec_labels=torch.tensor(labels), pixel_values_videos=torch.tensor(patches),
            video_grid_thw=grids,
            position_ids=None if position_ids is None else torch.tensor(position_ids))
        np.testing.assert_allclose(tout.codec_logits.numpy(), np.asarray(jout.codec_logits),
                                   atol=ATOL, rtol=ATOL)
        np.testing.assert_allclose(float(tout.loss), float(jout.loss), atol=ATOL, rtol=ATOL)
    # The video rows differ from a text-only forward.
    plain = TM.model_forward(tp, cfg, torch.tensor(ids), attention_mask=torch.tensor(mask))
    assert not torch.allclose(plain.codec_logits, tout.codec_logits)


def _gen_case(cfg, tp):
    """Two CFG pairs (4 rows) of different video-token counts and left
    pads, tower features at the slots, mRoPE positions and deltas."""
    out = _patches()
    grids = np.stack([g for _, g in out])
    feats = [TM.vision_forward(tp["vision"], torch.tensor(p), g[None], cfg.vision_config)
             for p, g in out]
    n = [f.shape[0] for f in feats]
    ids, mask = _rows(cfg, [n[0], n[0], n[1], n[1]], [0, 0, 0, 0], seed=3)
    ids[0, :2], mask[0, :2] = 0, 0                                  # a shorter negative row
    vmask = (ids == cfg.video_token_id).astype(np.int32)
    vemb = np.zeros(ids.shape + (cfg.text_config.hidden_size,), np.float32)
    for r in range(4):
        vemb[r, np.flatnonzero(vmask[r])] = feats[r // 2].detach().numpy()
    pos, deltas = TM.get_rope_index(ids, cfg, video_grid_thw=np.repeat(grids, 2, 0),
                                    second_per_grid_ts=[1.0] * 4, attention_mask=mask)
    assert (deltas < 0).all() and not np.array_equal(pos[0], pos[1])
    prefill, steps = JDL.prepare_audio_prompt(
        [None] * 2, num_channels=cfg.codec_channels, bos_value=cfg.codec_bos_value,
        delay_pattern=cfg.codec_delay_pattern)
    return ids, mask, vemb, vmask, pos, deltas, np.asarray(prefill), steps


def test_generate_with_vision_equals_jax(setup):
    """f32 greedy codes with visual_embeds, visual_mask, prefill_position_ids
    and rope_deltas equal `generate_jit`'s, through `generate` and through
    `generate_chunked` in chunks of 8 frames (two chunk boundaries)."""
    cfg, jp, tp = setup
    jcfg = j_tiny_test_config(with_vision=True)
    ids, mask, vemb, vmask, pos, deltas, prefill, steps = _gen_case(cfg, tp)
    max_tokens = 20
    want = JLOOP.generate_jit(
        jp, jcfg, jnp.asarray(ids), jnp.asarray(mask), None,
        JLOOP.pad_buffer(prefill, max_tokens), jnp.asarray(steps, jnp.int32),
        jax.random.PRNGKey(0), jnp.asarray(vemb), jnp.asarray(vmask), jnp.asarray(pos),
        rope_deltas=jnp.asarray(deltas, jnp.int32), max_tokens=max_tokens,
        min_tokens=jnp.int32(4), cfg_scale=jnp.float32(3.0), temperature=jnp.float32(1.0),
        top_p=jnp.float32(1.0), cfg_filter_top_k=16, eos_prob_mul_factor=jnp.float32(1.0),
        do_sample=False)
    vision = dict(visual_embeds=torch.tensor(vemb), visual_mask=torch.tensor(vmask),
                  prefill_position_ids=torch.tensor(pos), rope_deltas=torch.tensor(deltas))
    args = (tp, cfg, torch.tensor(ids), torch.tensor(mask), None,
            TLOOP.pad_buffer(torch.tensor(prefill), max_tokens), steps, torch.Generator())
    got = TLOOP.generate(*args, max_tokens=max_tokens, do_sample=False, **GREEDY, **vision)
    chunked = TLOOP.generate_chunked(*args, chunk_frames=8, max_tokens=max_tokens,
                                     do_sample=False, **GREEDY, **vision)
    assert got.steps > 16
    for res in (got, chunked):
        np.testing.assert_array_equal(res.codes.numpy(), np.asarray(want.codes))
        np.testing.assert_array_equal(res.lengths.numpy(), np.asarray(want.lengths))
    # Without the vision inputs the codes differ.
    plain = TLOOP.generate(*args, max_tokens=max_tokens, do_sample=False, **GREEDY)
    assert not np.array_equal(plain.codes.numpy(), got.codes.numpy())


def _eager_tower(monkeypatch):
    """The JAX API's tower op by op (jit off), as the port runs it: under
    jit XLA skips roundings between fused ops, which in the int8 tower's
    bf16 patch embed moves the features by 2.5e-3 relative
    (`tests/test_torch_vision.py`) and flips greedy codes for some
    prompts."""
    forward = JV.vision_forward

    def eager(*a, **k):
        with jax.disable_jit():
            return forward(*a, **k)

    monkeypatch.setattr(JV, "vision_forward", eager)


def _jax_codes(jm, fn, *a, **k):
    """The streams' codes [T_i, C] of one JAX API call (read where its DAC
    decodes them)."""
    got = []
    orig = jm.dac.decode_batch

    def capture(codes_list, save_paths, min_duration=None):
        got.extend(np.asarray(c).T for c in codes_list)
        return orig(codes_list, save_paths, min_duration)

    jm.dac.decode_batch = capture
    try:
        getattr(jm, fn)(*a, **k)
    finally:
        del jm.dac.decode_batch
    return got


VT2M_KW = dict(cfg_scale=3.0, do_sample=False, seed=0, max_frames=4)


def _jax_int8(jm):
    """The JAX API model in serving_mode="int8": its constructor's
    quantization pass (`api.py:172-190`: int8 weights, padded expert FFNs,
    the int8 tower) on a copy of jm's params."""
    from unimoe_audio_tpu.ops import quant as JQ

    jm8 = copy.copy(jm)
    params = JQ.pad_expert_ffn(jax.jit(JQ.quantize_model_params)(jm.params))
    jm8.params = {**params, "vision": jax.jit(JQ.quantize_vision_params)(params["vision"])}
    jm8.serving_mode = "int8"
    return jm8


@pytest.mark.parametrize("mode", [False, "int8"])
def test_video_text_to_music_equals_jax(tmp_path, monkeypatch, jax_model, mode):
    """Two videos of different grids with their captions: the port's f32
    greedy codes equal the JAX package's, stream for stream.  int8: the
    JAX model quantized (its tower by `quantize_vision_params`) and saved
    as `serving.jax.pkl`, the port loading that snapshot; the JAX tower
    runs op by op there (`_eager_tower`)."""
    jcfg = j_tiny_test_config(with_vision=True)
    jm = _jax_int8(jax_model) if mode else jax_model
    if mode:
        from unimoe_audio_tpu.core.export import save_serving_snapshot as j_save

        _eager_tower(monkeypatch)

        j_save(jm.params, jcfg, str(tmp_path / "snap"), serving_mode=mode)
        tm = UniMoEAudio(str(tmp_path / "snap"), allow_random=True, device="cpu",
                         max_tokens=16, min_tokens=4, tokenizer=jm.tokenizer)
        assert tm.serving_mode == mode and isinstance(tm.params["vision"]["patch_embed"],
                                                      QTensor)
        np.testing.assert_array_equal(
            tm.params["vision"]["blocks"][1]["mlp"]["up"]["w"].q.numpy(),
            np.asarray(jm.params["vision"]["blocks"][1]["mlp"]["up"]["w"].q))
    else:
        tm = UniMoEAudio(allow_random=True, config=tiny_test_config(with_vision=True),
                         device="cpu", dtype=torch.float32, max_tokens=16, min_tokens=4,
                         tokenizer=jm.tokenizer)
        tm.params = params_from_jax(jax.tree.map(np.asarray, jm.params), tm.config, "cpu")
    tm.dac.params = dac_params_from_jax(jax.tree.map(np.asarray, jm.dac.params), device="cpu")
    videos, captions = _videos(), ["calm piano", "fast drums with a walking bass line"]
    want = _jax_codes(jm, "video_text_to_music", videos, captions,
                      output_dir=str(tmp_path / "jax"), **VT2M_KW)
    paths = tm.video_text_to_music(videos, captions, output_dir=str(tmp_path / "port"),
                                   **VT2M_KW)
    assert len(paths) == len(want) == 2 and all(os.path.isfile(p) for p in paths)
    assert len(tm.last_timings["vision_s"]) == 2
    for got, w in zip(tm.last_codes, want):
        assert got.shape[0] > 0
        np.testing.assert_array_equal(got, w)


def test_vt2m_falls_back_without_vision(tmp_path, capsys):
    """A model without a tower warns and generates from the captions: the
    codes of `text_to_music` on the same captions, as the JAX package
    does."""
    tm = UniMoEAudio(allow_random=True, config=tiny_test_config(), device="cpu",
                     dtype=torch.float32, max_tokens=16, min_tokens=4)
    assert "vision" not in tm.params
    kw = dict(cfg_scale=3.0, do_sample=False, seed=1, output_dir=str(tmp_path))
    paths = tm.video_text_to_music(video=["x.mp4"], caption=["calm"], **kw)
    assert len(paths) == 1 and "no vision tower" in capsys.readouterr().out
    fallback = tm.last_codes
    tm.text_to_music(["calm"], **kw)
    assert len(fallback) == len(tm.last_codes) == 1
    np.testing.assert_array_equal(fallback[0], tm.last_codes[0])


def test_port_snapshot_with_int8_tower_round_trip(tmp_path):
    """`serving_mode="int8"` quantizes the tower; the port's snapshot keeps
    its QTensors bit for bit and the reloaded model gives the same greedy
    VT2M codes."""
    tm = UniMoEAudio(allow_random=True, config=tiny_test_config(with_vision=True),
                     device="cpu", serving_mode="int8", max_tokens=12, min_tokens=4)
    vis = tm.params["vision"]
    assert all(isinstance(w, QTensor) for w in (
        vis["patch_embed"], vis["blocks"][0]["qkv"]["w"], vis["merger"]["fc2"]["w"]))
    assert vis["blocks"][0]["norm1"].dtype == torch.bfloat16
    tm.save_serving_snapshot(str(tmp_path / "snap"))
    loaded = UniMoEAudio(str(tmp_path / "snap"), allow_random=True, device="cpu",
                         max_tokens=12, min_tokens=4)
    lvis = loaded.params["vision"]
    for a, b in ((vis["patch_embed"], lvis["patch_embed"]),
                 (vis["blocks"][1]["mlp"]["down"]["w"], lvis["blocks"][1]["mlp"]["down"]["w"])):
        assert torch.equal(a.q, b.q) and torch.equal(a.s, b.s)
    assert torch.equal(vis["merger"]["ln_q"], lvis["merger"]["ln_q"])
    codes = []
    for m in (tm, loaded):
        m.tokenizer = tm.tokenizer
        m.video_text_to_music(_videos()[:1], ["soft strings"], output_dir=str(tmp_path),
                              **VT2M_KW)
        codes.append(m.last_codes)
    np.testing.assert_array_equal(codes[0][0], codes[1][0])


def test_init_with_vision_keeps_decoder_weights():
    cfg = tiny_test_config(with_vision=True)
    a = TM.init_model_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    b = TM.init_model_params(cfg, seed=0, dtype=torch.float32, device="cpu", with_vision=True)
    assert "vision" not in a and len(b["vision"]["blocks"]) == cfg.vision_config.depth
    for k in ("embed_tokens", "codec_head", "lm_head"):
        assert torch.equal(a[k], b[k])
    assert torch.equal(a["layers"][1]["attn"]["q_proj"]["w"], b["layers"][1]["attn"]["q_proj"]["w"])
    assert b["vision"]["patch_embed"].shape == (3 * 2 * 14 * 14, cfg.vision_config.hidden_size)


def test_inference_cli_video_text_to_music(tmp_path, capsys, monkeypatch):
    """`python -m unimoe_audio_torch.apps.inference --task video_text_to_music`
    with random weights (the tiny config with its tower, a 12-frame budget)
    on the CPU writes one wav from an .avi; a missing --video is a usage
    error, a missing video file a failed generation."""
    from tests.test_torch_vision import write_avi
    from unimoe_audio_torch.apps import inference as app

    avi = write_avi(tmp_path / "clip.avi")
    monkeypatch.setattr(app, "UniMoEAudio", functools.partial(
        UniMoEAudio, config=tiny_test_config(with_vision=True), max_tokens=12, min_tokens=4))
    argv = ["--task", "video_text_to_music", "--input", "calm piano", "--video", avi,
            "--output", str(tmp_path / "out"), "--allow-random", "--cpu"]
    app.clear_model()
    assert app.main(argv) == 0
    assert "no vision tower" not in capsys.readouterr().out
    assert os.listdir(tmp_path / "out") == ["generated_video_music_0.wav"]
    assert len(app._model_instance.last_timings["vision_s"]) == 1
    with pytest.raises(SystemExit):
        app.main(argv[:4] + argv[6:])
    assert app.inference("video_text_to_music", "calm", video_path=str(tmp_path / "no.avi"),
                         output_path=str(tmp_path / "out2"), allow_random=True,
                         device="cpu") is None
    assert "does not exist" in capsys.readouterr().out
    app.clear_model()
