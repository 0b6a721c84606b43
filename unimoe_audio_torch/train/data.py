"""Training data pipeline of the port: conversation tokenization, image
patches, the dataset, background prefetch and batch collation — the numpy
counterpart of `unimoe_audio_tpu/train/data.py` (`:30-420`).

Everything here runs on the host and returns numpy arrays; the trainer
moves a collated batch to the card.  Two parts need packages that a
deployment may lack, and import them inside the function that uses them:
`load_image_patches` reads an image with PIL, and `ConversationDataset`
over a directory reads it with `datasets.load_from_disk`.  A list of dicts
and pre-made patches (`apps/video.video_to_patches` on a numpy image) need
neither.
"""

from __future__ import annotations

import copy
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..tokenizer import SimpleTokenizer  # noqa: F401  (the development tokenizer)

IGNORE_INDEX = -100
# Image budget for training samples (videos use tighter budgets,
# apps/video.py).
IMAGE_FACTOR = 28
IMAGE_MIN_PIXELS = 4 * 28 * 28
IMAGE_MAX_PIXELS = 16384 * 28 * 28
DEFAULT_IMAGE_TOKEN = "<|image_pad|>"
DEFAULT_IMAGE_PROMPT = "<|vision_start|><|image_pad|><|vision_end|>{}"
SYSTEM_MESSAGE = "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
INPUT_FORMAT = "<|im_start|>user\n{}<|im_end|>\n<|im_start|>assistant\n"


def _ids(out) -> List[int]:
    """A tokenizer's input_ids as a flat list (HF gives [[ids]] for a str in
    some tokenizers)."""
    return list(out[0] if out and isinstance(out[0], list) else out)


def tokenizer_image_token(prompt: str, tokenizer, image_token: str, image_token_index: int,
                          add_special_tokens: bool = True) -> List[int]:
    """Tokenize the text around each image token and splice the image id
    between the chunks; a BOS the tokenizer puts on the first chunk is kept
    once (`data.py:30-57`)."""
    chunks = [_ids(tokenizer(chunk, add_special_tokens=add_special_tokens).input_ids)
              for chunk in prompt.split(image_token)]
    input_ids: List[int] = []
    offset = 0
    bos = getattr(tokenizer, "bos_token_id", None)
    if chunks and chunks[0] and bos is not None and chunks[0][0] == bos:
        offset = 1
        input_ids.append(chunks[0][0])
    sep = [image_token_index] * (offset + 1)
    for i, c in enumerate(chunks):
        input_ids.extend(c[offset:])
        if i != len(chunks) - 1:
            input_ids.extend(sep[offset:])
    return input_ids


def preprocess_supervised(
    conversation: List[Dict[str, str]],
    tokenizer,
    *,
    image_token: str = DEFAULT_IMAGE_TOKEN,
    image_token_index: int = 151655,
    label_ignore_index: int = IGNORE_INDEX,
    system_message: str = SYSTEM_MESSAGE,
    input_format: str = INPUT_FORMAT,
    has_image: bool = False,
    model_max_length: Optional[int] = None,
    adding_sys_in_query: bool = False,
) -> Dict[str, np.ndarray]:
    """A conversation [{from: human|gpt, value}] → input_ids and labels,
    the sources (system message, user turns, the assistant header) masked
    with label_ignore_index (`data.py:60-131`).  Truncated to
    model_max_length."""
    human_role, ai_role = "human", "gpt"
    assert conversation[0]["from"] == human_role

    sources, targets = [], []
    eos = getattr(tokenizer, "eos_token", "") or ""
    for i, message in enumerate(conversation):
        role, value = message["from"], message["value"]
        assert role == (ai_role if i % 2 else human_role)
        if i == 0 and adding_sys_in_query:
            value = system_message + value
        if i % 2 == 0:
            sources.append(input_format.format(value))
        else:
            targets.append(value + eos)

    def encode(text):
        if has_image:
            return tokenizer_image_token(text, tokenizer, image_token=image_token,
                                         image_token_index=image_token_index,
                                         add_special_tokens=False)
        return _ids(tokenizer(text, add_special_tokens=False).input_ids)

    input_ids: List[int] = []
    labels: List[int] = []
    bos = getattr(tokenizer, "bos_token_id", None)
    if bos is not None:
        input_ids.append(bos)
        labels.append(label_ignore_index)
    if not adding_sys_in_query:
        sys_ids = encode(system_message)
        input_ids += sys_ids
        labels += [label_ignore_index] * len(sys_ids)

    for source, target in zip(sources, targets):
        sep = "" if source and source[-1] in ("\n", "\t", " ") else " "
        source_ids = encode(source)
        full_ids = encode(source + sep + target.strip())
        input_ids += full_ids
        labels += [label_ignore_index] * len(source_ids) + full_ids[len(source_ids):]

    if model_max_length is not None and len(input_ids) >= model_max_length:
        input_ids = input_ids[:model_max_length]
        labels = labels[:model_max_length]

    labels_arr = np.asarray(labels, dtype=np.int64)
    if has_image:
        assert not ((labels_arr == image_token_index) & (labels_arr != label_ignore_index)).any()
    return {"input_ids": np.asarray(input_ids, dtype=np.int64), "labels": labels_arr}


def preprocess_pretraining(
    sentence: str,
    tokenizer,
    *,
    image_token: str = DEFAULT_IMAGE_TOKEN,
    image_token_index: int = 151655,
    label_ignore_index: int = IGNORE_INDEX,
    model_max_length: Optional[int] = None,
    has_image: bool = False,
    truncation: bool = True,
) -> Dict[str, np.ndarray]:
    """One sentence → input_ids, labels on every token but the image
    tokens, and the EOS position `global_text_index` (`data.py:134-176`):
    truncated to model_max_length with EOS in the last slot, else EOS
    appended."""
    if has_image:
        input_ids = tokenizer_image_token(sentence, tokenizer, image_token=image_token,
                                          image_token_index=image_token_index)
    else:
        input_ids = _ids(tokenizer(sentence).input_ids)

    eos_id = getattr(tokenizer, "eos_token_id", None)
    if truncation and model_max_length is not None and len(input_ids) >= model_max_length:
        input_ids = input_ids[:model_max_length]
        if eos_id is not None:
            input_ids[-1] = eos_id
    elif eos_id is not None:
        input_ids = input_ids + [eos_id]

    ids = np.asarray(input_ids, dtype=np.int64)
    labels = ids.copy()
    if has_image:
        labels[labels == image_token_index] = label_ignore_index
    return {"input_ids": ids, "labels": labels, "global_text_index": np.int64(len(ids) - 1)}


def prefetch(batches, depth: int = 2):
    """Yield the items of `batches` in order while a daemon thread builds
    the next ones into a queue `depth` deep (`data.py:179-210`), so host
    collation overlaps the device step.  An exception in the thread is
    raised again here, after the items before it."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    end = object()

    def worker():
        try:
            for item in batches:
                q.put(item)
            q.put(end)
        except BaseException as e:  # noqa: BLE001 — raised again in the consumer
            q.put(e)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def expand_image_tokens(conversation: List[Dict], n_tokens: int,
                        image_token: str = DEFAULT_IMAGE_TOKEN,
                        prepend_prompt: bool = True) -> List[Dict]:
    """A copy of the conversation with each image token repeated n_tokens
    times and turn 0 wrapped in the vision prompt (`data.py:213-227`)."""
    conversation = copy.deepcopy(conversation)
    for i, turn in enumerate(conversation):
        sentence = turn["value"]
        if i == 0 and prepend_prompt:
            sentence = DEFAULT_IMAGE_PROMPT.format(sentence)
        while image_token in sentence:
            sentence = sentence.replace(image_token, "<|placeholder|>" * n_tokens, 1)
        turn["value"] = sentence.replace("<|placeholder|>", image_token)
    return conversation


def load_image_patches(image_path: str, *, patch_size: int = 14, temporal_patch_size: int = 2,
                       merge_size: int = 2, min_pixels: int = IMAGE_MIN_PIXELS,
                       max_pixels: int = IMAGE_MAX_PIXELS):
    """An image file → (flattened patches [S, 3·tps·ps²] f32, grid_thw [3])
    (`data.py:230-263`): opened with PIL (imported here), resized to
    `smart_resize`'s size under the pixel budget, and patchified as a
    one-frame video by `apps/video.video_to_patches`, the patch layout of
    the VT2M path."""
    from PIL import Image

    from ..apps.video import smart_resize, video_to_patches

    img = Image.open(image_path).convert("RGB")
    width, height = img.size
    rh, rw = smart_resize(height, width, factor=IMAGE_FACTOR, min_pixels=min_pixels,
                          max_pixels=max_pixels)
    img = img.resize((rw, rh))
    arr = np.asarray(img, dtype=np.float32).transpose(2, 0, 1)[None]        # [1, 3, H, W]
    return video_to_patches(arr, patch_size=patch_size, temporal_patch_size=temporal_patch_size,
                            merge_size=merge_size)


@dataclass
class Collator:
    """Pad + mask + aux_balance_weight (`data.py:265-300`): right-pads
    input_ids with pad_token_id and labels with IGNORE_INDEX; the aux
    weight is 1 everywhere and `aux_balance_weight` on label positions
    (output tokens get that emphasis in the balancing loss); the samples'
    pixel_values and image_grid_thw are concatenated in order."""

    pad_token_id: int
    aux_balance_weight: Optional[float] = None
    model_max_length: Optional[int] = None

    def __call__(self, instances: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        T = max(len(x["input_ids"]) for x in instances)
        if self.model_max_length is not None:
            T = min(T, self.model_max_length)
        B = len(instances)
        input_ids = np.full((B, T), self.pad_token_id, dtype=np.int64)
        labels = np.full((B, T), IGNORE_INDEX, dtype=np.int64)
        for i, inst in enumerate(instances):
            n = min(len(inst["input_ids"]), T)
            input_ids[i, :n] = inst["input_ids"][:n]
            labels[i, :n] = inst["labels"][:n]
        batch = {
            "input_ids": input_ids,
            "labels": labels,
            "attention_mask": (input_ids != self.pad_token_id).astype(np.int64),
        }
        if self.aux_balance_weight is not None:
            abw = np.ones_like(input_ids, dtype=np.float32)
            abw[labels != IGNORE_INDEX] = self.aux_balance_weight
            batch["aux_balance_weight"] = abw
        for key in ("pixel_values", "image_grid_thw"):
            vals = [inst[key] for inst in instances if key in inst]
            if vals:
                batch[key] = np.concatenate(vals, axis=0)
        return batch


class ConversationDataset:
    """Lazy map over a list of dicts or an arrow directory of conversations
    (`data.py:354-420`; the directory read with `datasets.load_from_disk`,
    imported here, and shuffled with shuffle_seed).  A sample with an
    `image_path` gets its patches (`load_image_patches`, under image_root)
    and each image token expanded to the image's merged-token count; an
    assert fires when truncation cut image tokens away."""

    def __init__(self, data, tokenizer, *, shuffle_seed: int = 233,
                 image_token_index: int = 151655, model_max_length: Optional[int] = 4096,
                 data_sample: Optional[int] = None, image_root: Optional[str] = None,
                 vision_config=None):
        if isinstance(data, str):
            import datasets as hfds

            data = hfds.load_from_disk(data).shuffle(seed=shuffle_seed)
        self.data = data
        self.tokenizer = tokenizer
        self.image_token_index = image_token_index
        self.model_max_length = model_max_length
        self.image_root = image_root
        # Patch geometry of image samples; the defaults are the flagship
        # tower's (config.VisionConfig).
        self.patch_size = getattr(vision_config, "patch_size", 14)
        self.temporal_patch_size = getattr(vision_config, "temporal_patch_size", 2)
        self.merge_size = getattr(vision_config, "spatial_merge_size", 2)
        if data_sample is not None:
            self.data = self.data.select(range(min(data_sample, len(self.data))))

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i) -> Dict[str, np.ndarray]:
        src = self.data[i]
        image_path = src.get("image_path")
        has_image = image_path is not None
        conversations = src["conversations"]
        extra: Dict[str, np.ndarray] = {}
        if has_image:
            if self.image_root:
                image_path = os.path.join(self.image_root, image_path)
            patches, grid = load_image_patches(
                image_path, patch_size=self.patch_size,
                temporal_patch_size=self.temporal_patch_size, merge_size=self.merge_size)
            n_tokens = int(grid.prod()) // self.merge_size ** 2
            conversations = expand_image_tokens(conversations, n_tokens)
            extra = {"pixel_values": patches, "image_grid_thw": grid[None]}
        out = preprocess_supervised(conversations, self.tokenizer,
                                    image_token_index=self.image_token_index,
                                    has_image=has_image, model_max_length=self.model_max_length)
        if has_image:
            n_in_ids = int((out["input_ids"] == self.image_token_index).sum())
            assert n_in_ids == int(extra["image_grid_thw"].prod()) // self.merge_size ** 2, (
                "image tokens truncated away — raise model_max_length or lower the image "
                "pixel budget")
        out.update(extra)
        return out
