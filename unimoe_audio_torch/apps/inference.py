#!/usr/bin/env python3
"""Single-shot inference CLI of the port — counterpart of
`unimoe_audio_tpu/apps/inference.py`: an `inference()` function with the
reference's signature, a process-wide model cache with `clear_model()`,
and the same flags and task names.

    python -m unimoe_audio_torch.apps.inference --task text_to_speech \\
        --input "Hello there." --ref-audio voice.wav --ref-text "Its transcript." \\
        --model path/to/model --output ./output

    python -m unimoe_audio_torch.apps.inference --task video_text_to_music \\
        --input "Calm piano." --video clip.mp4 --model path/to/model

Runs on `cuda:{--device}`; `--cpu` runs on the CPU.  `--allow-random`
serves random weights (development and smoke runs).  Reading a video file
needs OpenCV (`cv2`).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

from unimoe_audio_torch.api import UniMoEAudio

TASKS = ("text_to_music", "text_to_speech", "video_text_to_music")

_model_instance = None
_current_model_key = None


def _require_file(path: Optional[str], what: str) -> str:
    if not path:
        raise ValueError(f"{what} is required for this task")
    if not os.path.exists(path):
        raise FileNotFoundError(f"{what} does not exist: {path}")
    return path


def _get_model(model_path: str, device_id: int, reuse: bool, allow_random: bool,
               device: Optional[str]) -> UniMoEAudio:
    global _model_instance, _current_model_key
    key = (model_path, device_id, device, allow_random)
    if reuse and _model_instance is not None and _current_model_key == key:
        return _model_instance
    print(f"[inference] initializing UniMoEAudio ({model_path})")
    _model_instance = UniMoEAudio(
        model_path=None if allow_random else model_path, device_id=device_id,
        allow_random=allow_random, device=device)
    _current_model_key = key
    return _model_instance


def inference(
    task: str,
    input_text: str,
    ref_audio: Optional[str] = None,
    ref_text: Optional[str] = None,
    output_path: str = "./output",
    model_path: str = "path/to/your/model",
    device_id: int = 0,
    reuse_model: bool = True,
    video_path: Optional[str] = None,
    allow_random: bool = False,
    device: Optional[str] = None,
):
    """One generation call; returns the output path(s), or None when the
    generation failed (the failure is printed), as the reference's entry
    point does.  device (for example "cpu") overrides `cuda:{device_id}`."""
    try:
        model = _get_model(model_path, device_id, reuse_model, allow_random, device)
        os.makedirs(output_path, exist_ok=True)
        if task == "text_to_music":
            result = model.text_to_music(caption=input_text, output_dir=output_path)
        elif task == "text_to_speech":
            _require_file(ref_audio, "reference audio (--ref-audio)")
            if not ref_text:
                raise ValueError("text_to_speech needs the reference transcript (--ref-text)")
            result = model.text_to_speech(transcription=input_text,
                                          prompt_transcription=ref_text,
                                          prompt_wav=ref_audio, output_dir=output_path)
        elif task == "video_text_to_music":
            _require_file(video_path, "video (--video)")
            result = model.video_text_to_music(video=video_path, caption=input_text,
                                               output_dir=output_path)
        else:
            raise ValueError(f"unknown task {task!r}; expected one of {', '.join(TASKS)}")
        if result:
            print(f"[inference] wrote {result}")
            return result
        print("[inference] generation produced no output")
        return None
    except Exception as e:  # noqa: BLE001 — None on failure, as the reference's CLI
        print(f"[inference] failed: {e}")
        return None


def clear_model():
    """Drop the cached model, so that the next call initializes anew."""
    global _model_instance, _current_model_key
    _model_instance = None
    _current_model_key = None
    print("[inference] model cache dropped")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="UniMoE Audio inference (PyTorch port)")
    parser.add_argument("--task", "-t", required=True, choices=TASKS)
    parser.add_argument("--input", "-i", required=True, help="Input text for generation")
    parser.add_argument("--ref-audio", "-ra", help="Reference audio path (TTS)")
    parser.add_argument("--ref-text", "-rt", help="Reference text (TTS)")
    parser.add_argument("--video", "-v", help="Video file path (VT2M)")
    parser.add_argument("--output", "-o", default="./output")
    parser.add_argument("--model", "-m", default="path/to/your/model")
    parser.add_argument("--device", "-d", type=int, default=0, help="CUDA device index")
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU")
    parser.add_argument("--no-reuse", action="store_true")
    parser.add_argument("--allow-random", action="store_true",
                        help="Run with random weights (development/smoke testing)")
    args = parser.parse_args(argv)

    missing = []
    if args.task == "text_to_speech":
        missing = [f for f, v in (("--ref-audio", args.ref_audio),
                                  ("--ref-text", args.ref_text)) if not v]
    elif args.task == "video_text_to_music" and not args.video:
        missing = ["--video"]
    if missing:
        parser.error(f"{args.task} requires {', '.join(missing)}")

    result = inference(
        task=args.task, input_text=args.input, ref_audio=args.ref_audio,
        ref_text=args.ref_text, output_path=args.output, model_path=args.model,
        device_id=args.device, reuse_model=not args.no_reuse, video_path=args.video,
        allow_random=args.allow_random, device="cpu" if args.cpu else None)
    return 0 if result else 1


if __name__ == "__main__":
    sys.exit(main())
