"""Video front end of the port: frame extraction, Qwen-style smart resize
and the patch layout of the vision tower — counterpart of
`unimoe_audio_tpu/apps/video.py`.

`extract_frames` and `frame_process` use OpenCV (`cv2`), as the JAX package
does, imported inside them; where OpenCV is missing they raise ImportError
and name the way round it: pass pre-extracted frames, a float array
[T, 3, H, W] in [0, 255], which `video_to_patches` takes with numpy alone.
The resize stays OpenCV's bicubic filter: another filter gives other
frames than the reference's.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

IMAGE_FACTOR = 28
VIDEO_TOTAL_PIXELS = 512 * 28 * 28
VIDEO_MIN_PIXELS = 16 * 28 * 28
VIDEO_MAX_PIXELS = 64 * 28 * 28
FRAME_FACTOR = 2

# OPENAI CLIP normalization (Qwen2VL image processor defaults).
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "reading or resizing a video file needs OpenCV (cv2), which is not installed; "
            "pass pre-extracted frames instead: a float array [T, 3, H, W] in [0, 255]") from e
    return cv2


def smart_resize(height: int, width: int, factor: int = IMAGE_FACTOR,
                 min_pixels: int = 56 * 56, max_pixels: int = 14 * 14 * 4 * 1280):
    """H and W snapped to multiples of `factor` inside the pixel budget
    (qwen_vl_utils.smart_resize)."""
    h_bar = max(factor, round(height / factor) * factor)
    w_bar = max(factor, round(width / factor) * factor)
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = max(factor, math.floor(height / beta / factor) * factor)
        w_bar = max(factor, math.floor(width / beta / factor) * factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


def extract_frames(video_path: str, fps: int, max_frames: Optional[int] = None) -> List[np.ndarray]:
    """Frames sampled at `fps`, at most max_frames: RGB uint8 [H, W, 3]."""
    cv2 = _cv2()
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {video_path}")
    native_fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    n_frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    duration = n_frames / native_fps if native_fps else 0
    frames = []
    for i, t in enumerate(range(0, math.ceil(duration * fps))):
        cap.set(cv2.CAP_PROP_POS_MSEC, t / fps * 1000.0)
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        if max_frames is not None and i >= max_frames - 1:
            break
    cap.release()
    if not frames:
        raise ValueError(f"no frames extracted from {video_path}")
    return frames


def frame_process(
    frames: List[np.ndarray],
    *,
    total_pixels: int = VIDEO_TOTAL_PIXELS,
    min_pixels: int = VIDEO_MIN_PIXELS,
    max_pixels: Optional[int] = None,
    resized_height: Optional[int] = None,
    resized_width: Optional[int] = None,
) -> np.ndarray:
    """Frames resized (bicubic) under the pixel budget: float32
    [T, 3, H, W]."""
    cv2 = _cv2()
    video = np.stack(frames)                                     # [T, H, W, 3]
    nframes, height, width, _ = video.shape
    budget = max(min(VIDEO_MAX_PIXELS, total_pixels / nframes * FRAME_FACTOR),
                 int(min_pixels * 1.05))
    if max_pixels is not None and max_pixels < budget:
        budget = max_pixels
    if resized_height is not None and resized_width is not None:
        h, w = smart_resize(resized_height, resized_width, factor=IMAGE_FACTOR)
    else:
        h, w = smart_resize(height, width, factor=IMAGE_FACTOR, min_pixels=min_pixels,
                            max_pixels=budget)
    out = np.stack([cv2.resize(f, (w, h), interpolation=cv2.INTER_CUBIC)
                    for f in video]).astype(np.float32)
    return out.transpose(0, 3, 1, 2)


def video_to_patches(video_tchw: np.ndarray, *, patch_size: int = 14,
                     temporal_patch_size: int = 2, merge_size: int = 2):
    """Frames [T, 3, H, W] (0..255) → (flattened patches [S, 3·tps·ps·ps]
    float32, grid_thw [3] int64): rescale and CLIP-normalize, pad T to a
    multiple of the temporal patch by repeating the last frame, then
    flatten each (channel, temporal, ps, ps) patch with the merged 2×2
    groups adjacent — the order the conv3d patch embed consumes."""
    v = video_tchw.astype(np.float32) / 255.0
    v = (v - CLIP_MEAN[None, :, None, None]) / CLIP_STD[None, :, None, None]
    T, C, H, W = v.shape
    if T % temporal_patch_size:
        reps = temporal_patch_size - T % temporal_patch_size
        v = np.concatenate([v, np.repeat(v[-1:], reps, axis=0)], axis=0)
        T = v.shape[0]
    grid_t = T // temporal_patch_size
    gh, gw = H // patch_size, W // patch_size
    m = merge_size
    patches = v.reshape(grid_t, temporal_patch_size, C, gh // m, m, patch_size,
                        gw // m, m, patch_size)
    patches = patches.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    flat = patches.reshape(grid_t * gh * gw, C * temporal_patch_size * patch_size ** 2)
    return flat, np.array([grid_t, gh, gw], dtype=np.int64)
