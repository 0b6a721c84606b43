"""The training data pipeline of the PyTorch port vs the JAX package's,
exactly equal on the CPU: conversation tokenization (`preprocess_supervised`
with and without images, with the system message in the query and with
truncation; `preprocess_pretraining`; `tokenizer_image_token` with a BOS
tokenizer), `expand_image_tokens`, `load_image_patches` on a PNG written
with PIL, `ConversationDataset` over the sample arrow dataset with images
and over a list, the `Collator` with pixel_values, and `prefetch`'s order
and error propagation.  The development tokenizer takes word ids from
Python's hash(), which is the same for both packages within one process."""

import os

import numpy as np
import pytest

from examples.make_sample_dataset import build as build_sample_dataset
from unimoe_audio_tpu.config import tiny_test_config
from unimoe_audio_tpu.train import data as JD
from unimoe_audio_torch.train import data as TD

SPECIAL = {"<|vision_start|>": 90, "<|vision_end|>": 91, "<|image_pad|>": 92,
           "<|video_pad|>": 93}
IMG = SPECIAL["<|image_pad|>"]


def _tok():
    return TD.SimpleTokenizer(vocab_size=500, special=SPECIAL)


class BosTok(TD.SimpleTokenizer):
    """The development tokenizer with a BOS id put ahead of every call's
    ids when special tokens are asked for."""

    bos_token_id = 1

    def __call__(self, text, add_special_tokens=False, **kw):
        r = super().__call__(text)
        if add_special_tokens:
            r.input_ids = [self.bos_token_id] + r.input_ids
        return r


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


CONV = [{"from": "human", "value": "play a calm tune <|image_pad|> please"},
        {"from": "gpt", "value": "a calm tune with strings"},
        {"from": "human", "value": "again, faster\n"},
        {"from": "gpt", "value": "a fast tune"}]


@pytest.mark.parametrize("kw", [{}, {"has_image": True}, {"adding_sys_in_query": True},
                                {"has_image": True, "model_max_length": 20},
                                {"model_max_length": 12}])
def test_preprocess_supervised_equal(kw):
    conv = CONV if kw.get("has_image") else [
        {**t, "value": t["value"].replace("<|image_pad|>", "")} for t in CONV]
    tok = _tok()
    got = TD.preprocess_supervised(conv, tok, image_token_index=IMG, **kw)
    want = JD.preprocess_supervised(conv, tok, image_token_index=IMG, **kw)
    _assert_same(got, want)
    if "model_max_length" in kw:
        assert len(got["input_ids"]) == kw["model_max_length"]
    else:
        assert (got["labels"] != TD.IGNORE_INDEX).any()


@pytest.mark.parametrize("kw", [{}, {"has_image": True}, {"model_max_length": 5},
                                {"has_image": True, "model_max_length": 6}])
def test_preprocess_pretraining_equal(kw):
    text = "a song <|image_pad|> with a slow beat and warm pads"
    tok = _tok()
    got = TD.preprocess_pretraining(text, tok, image_token_index=IMG, **kw)
    want = JD.preprocess_pretraining(text, tok, image_token_index=IMG, **kw)
    _assert_same(got, want)
    assert got["input_ids"][-1] == tok.eos_token_id


def test_tokenizer_image_token_with_bos():
    tok = BosTok(vocab_size=500, special=SPECIAL)
    for prompt in ("x <|image_pad|> y <|image_pad|>", "<|image_pad|>a b", "no image here"):
        got = TD.tokenizer_image_token(prompt, tok, "<|image_pad|>", IMG)
        want = JD.tokenizer_image_token(prompt, tok, "<|image_pad|>", IMG)
        assert got == want and got[0] == 1 and got.count(1) == 1


def test_expand_image_tokens_equal():
    conv = [{"from": "human", "value": "a <|image_pad|> b <|image_pad|>"},
            {"from": "gpt", "value": "c <|image_pad|>"}]
    for n, pre in ((3, True), (1, False)):
        got = TD.expand_image_tokens(conv, n, prepend_prompt=pre)
        assert got == JD.expand_image_tokens(conv, n, prepend_prompt=pre)
    assert conv[0]["value"] == "a <|image_pad|> b <|image_pad|>"


def test_load_image_patches_equal(tmp_path):
    from PIL import Image

    path = str(tmp_path / "img.png")
    Image.fromarray(np.random.default_rng(0).integers(0, 255, (61, 90, 3), dtype=np.uint8),
                    "RGB").save(path)
    for kw in ({}, {"max_pixels": 28 * 28 * 4}):
        (gp, gg), (wp, wg) = TD.load_image_patches(path, **kw), JD.load_image_patches(path, **kw)
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gg, wg)
        assert gp.dtype == wp.dtype == np.float32 and gp.shape[0] == gg.prod()


@pytest.fixture(scope="module")
def arrow_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("data") / "ds")
    build_sample_dataset(path, n=5, with_images=True, every=2)
    return path


def test_conversation_dataset_equal(arrow_dir):
    """Over the sample arrow directory (images every second row, the tiny
    tower's patch geometry), with data_sample, and over a list of dicts;
    then the Collator (with pixel_values) of the samples."""
    cfg = tiny_test_config(with_vision=True)
    tok = TD.SimpleTokenizer(vocab_size=cfg.text_config.vocab_size, special={
        "<|vision_start|>": cfg.vision_start_token_id,
        "<|vision_end|>": cfg.vision_end_token_id, "<|image_pad|>": cfg.image_token_id})
    kw = dict(image_token_index=cfg.image_token_id, image_root=arrow_dir + "_images",
              vision_config=cfg.vision_config, model_max_length=512)
    got = TD.ConversationDataset(arrow_dir, tok, **kw)
    want = JD.ConversationDataset(arrow_dir, tok, **kw)
    assert len(got) == len(want) == 5
    samples = [got[i] for i in range(5)]
    for i, s in enumerate(samples):
        _assert_same(s, want[i])
    assert sum("pixel_values" in s for s in samples) == 3
    assert len(TD.ConversationDataset(arrow_dir, tok, data_sample=2, **kw)) == 2
    rows = [{"conversations": [{"from": "human", "value": f"tune {i}"},
                               {"from": "gpt", "value": f"a tune {i}"}]} for i in range(3)]
    rows[1]["image_path"] = os.path.join(arrow_dir + "_images", "img_0.png")
    for i in range(3):
        _assert_same(TD.ConversationDataset(rows, tok, **{**kw, "image_root": None})[i],
                     JD.ConversationDataset(rows, tok, **{**kw, "image_root": None})[i])
    for ckw in ({"pad_token_id": 0, "aux_balance_weight": 10.0},
                {"pad_token_id": 0, "model_max_length": 40}):
        batch = TD.Collator(**ckw)(samples[:3])
        n_img = sum("pixel_values" in x for x in samples[:3])
        assert n_img > 0 and batch["image_grid_thw"].shape == (n_img, 3)
        _assert_same(batch, JD.Collator(**ckw)(samples[:3]))
    i_img = next(i for i, x in enumerate(samples) if "pixel_values" in x)
    with pytest.raises(AssertionError, match="truncated"):
        TD.ConversationDataset(arrow_dir, tok, **{**kw, "model_max_length": 9})[i_img]


def test_prefetch_order_and_errors():
    assert list(TD.prefetch(iter(range(50)), depth=3)) == list(range(50))

    def bad():
        yield 1
        yield 2
        raise ValueError("worker failed")

    got = []
    with pytest.raises(ValueError, match="worker failed"):
        for x in TD.prefetch(bad()):
            got.append(x)
    assert got == [1, 2]
