#!/usr/bin/env python3
"""Batch inference framework of the port — counterpart of
`unimoe_audio_tpu/apps/inference_framework.py`: TaskConfig /
FrameworkConfig, JSON and YAML loaders (both the reference's key spellings
and the fixtures' reference_audio / reference_text), per-task status and
timing records, save_results and --create-sample.

    python -m unimoe_audio_torch.apps.inference_framework -c config.json -t tasks.json

Runs on `cuda:{device_id}`; a config with "device": "cpu", or `--cpu`, runs
on the CPU.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from dataclasses import dataclass
from datetime import datetime
from pathlib import Path
from typing import Dict, List, Optional

from unimoe_audio_torch.api import UniMoEAudio


@dataclass
class TaskConfig:
    """One audio generation task."""

    task_type: str
    task_id: Optional[str] = None
    output_path: str = "./output"
    caption: Optional[str] = None
    target_text: Optional[str] = None
    prompt_text: Optional[str] = None
    prompt_wav: Optional[str] = None
    video_path: Optional[str] = None
    temperature: float = 1.0
    max_audio_seconds: float = 20
    min_audio_seconds: float = 8
    top_p: float = 1.0
    cfg_filter_top_k: int = 45

    @classmethod
    def from_dict(cls, d: Dict) -> "TaskConfig":
        d = dict(d)
        if "reference_audio" in d:
            d["prompt_wav"] = d.pop("reference_audio")
        if "reference_text" in d:
            d["prompt_text"] = d.pop("reference_text")
        known = cls.__dataclass_fields__.keys()
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclass
class FrameworkConfig:
    """Framework configuration; device (for example "cpu") overrides
    `cuda:{device_id}`."""

    model_path: str
    device_id: int = 0
    output_base_dir: str = "./generated_audio"
    log_level: str = "INFO"
    log_file: Optional[str] = None
    max_concurrent_tasks: int = 1
    allow_random: bool = False
    device: Optional[str] = None


class InferenceFramework:
    """Runs tasks one by one, recording each one's status and times."""

    def __init__(self, config: FrameworkConfig):
        self.config = config
        self.audio_generator: Optional[UniMoEAudio] = None
        self.logger = self._setup_logging()
        self.task_results: List[Dict] = []

    def _setup_logging(self) -> logging.Logger:
        logger = logging.getLogger("UniMoEAudio")
        logger.setLevel(getattr(logging, self.config.log_level.upper()))
        logger.handlers.clear()
        fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
        console = logging.StreamHandler()
        console.setFormatter(fmt)
        logger.addHandler(console)
        if self.config.log_file:
            fh = logging.FileHandler(self.config.log_file)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
        return logger

    def initialize_model(self) -> bool:
        """The model, or False (logged) when it cannot be built."""
        try:
            self.logger.info(f"Initializing UniMoE Audio model from {self.config.model_path}")
            self.audio_generator = UniMoEAudio(
                model_path=None if self.config.allow_random else self.config.model_path,
                device_id=self.config.device_id, allow_random=self.config.allow_random,
                device=self.config.device)
            self.logger.info("Model initialized successfully")
            return True
        except (OSError, RuntimeError, ValueError) as e:
            self.logger.error(f"Failed to initialize model: {e}")
            return False

    def execute_task(self, task: TaskConfig) -> Dict:
        if not self.audio_generator:
            raise RuntimeError("Model not initialized. Call initialize_model() first.")
        task_id = task.task_id or f"{task.task_type}_{int(time.time())}"
        self.logger.info(f"Starting task {task_id}: {task.task_type}")
        result = {"task_id": task_id, "task_type": task.task_type, "status": "failed",
                  "output_file": None, "error": None,
                  "start_time": datetime.now().isoformat(), "end_time": None}
        gen = self.audio_generator
        common = dict(output_dir=task.output_path, temperature=task.temperature,
                      top_p=task.top_p, cfg_filter_top_k=task.cfg_filter_top_k)
        try:
            os.makedirs(task.output_path, exist_ok=True)
            if task.task_type == "text_to_music":
                if not task.caption:
                    raise ValueError("Caption is required for text_to_music task")
                out = gen.text_to_music(caption=task.caption,
                                        max_audio_seconds=task.max_audio_seconds,
                                        min_audio_seconds=task.min_audio_seconds, **common)
            elif task.task_type == "text_to_speech":
                if not task.target_text or not task.prompt_wav or not task.prompt_text:
                    raise ValueError("target_text, prompt_wav and prompt_text are required "
                                     "for text_to_speech task")
                # The reference's TTS length clamps: 2 to 10 s.
                out = gen.text_to_speech(
                    transcription=task.target_text, prompt_transcription=task.prompt_text,
                    prompt_wav=task.prompt_wav, max_audio_seconds=min(task.max_audio_seconds, 10),
                    min_audio_seconds=max(task.min_audio_seconds, 2), **common)
            elif task.task_type == "video_text_to_music":
                if not task.video_path or not task.caption:
                    raise ValueError("video_path and caption are required for "
                                     "video_text_to_music task")
                out = gen.video_text_to_music(video=task.video_path, caption=task.caption,
                                              **common)
            else:
                raise ValueError(f"Unknown task type: {task.task_type}")
            result["status"] = "success"
            result["output_file"] = out[0] if isinstance(out, list) and out else out
            self.logger.info(f"Task {task_id} completed: {result['output_file']}")
        except (OSError, ValueError, ImportError) as e:     # the task's own failure
            result["error"] = str(e)
            self.logger.error(f"Task {task_id} failed: {e}")
        result["end_time"] = datetime.now().isoformat()
        self.task_results.append(result)
        return result

    def execute_batch(self, tasks: List[TaskConfig]) -> List[Dict]:
        self.logger.info(f"Starting batch execution of {len(tasks)} tasks")
        results = [self.execute_task(t) for t in tasks]
        ok = sum(1 for r in results if r["status"] == "success")
        self.logger.info(f"Batch execution completed: {ok} successful, {len(results) - ok} failed")
        return results

    def save_results(self, output_file: str) -> None:
        with open(output_file, "w", encoding="utf-8") as f:
            json.dump(self.task_results, f, indent=2, ensure_ascii=False)
        self.logger.info(f"Results saved to {output_file}")


def _load_structured(path: str):
    p = Path(path)
    if not p.exists():
        raise FileNotFoundError(f"File not found: {path}")
    with open(p, encoding="utf-8") as f:
        if p.suffix.lower() in (".yaml", ".yml"):
            import yaml

            return yaml.safe_load(f)
        return json.load(f)


def load_config_from_file(config_file: str) -> FrameworkConfig:
    d = _load_structured(config_file)
    known = FrameworkConfig.__dataclass_fields__.keys()
    return FrameworkConfig(**{k: v for k, v in d.items() if k in known})


def load_tasks_from_file(tasks_file: str) -> List[TaskConfig]:
    return [TaskConfig.from_dict(t) for t in _load_structured(tasks_file)]


def create_sample_config() -> None:
    """Write sample_config.json and sample_tasks.json in the working
    directory."""
    sample_config = {"model_path": "/path/to/UniMoE-Audio-preview", "device_id": 0,
                     "output_base_dir": "./generated_audio", "log_level": "INFO",
                     "log_file": "inference.log", "max_concurrent_tasks": 1}
    sample_tasks = [
        {"task_type": "text_to_music", "task_id": "music_001",
         "caption": "A peaceful piano melody", "output_path": "./output/music"},
        {"task_type": "text_to_speech", "task_id": "speech_001", "target_text": "Hello world",
         "prompt_wav": "/path/to/ref.wav", "prompt_text": "Reference transcript",
         "output_path": "./output/speech"},
    ]
    with open("sample_config.json", "w") as f:
        json.dump(sample_config, f, indent=2)
    with open("sample_tasks.json", "w") as f:
        json.dump(sample_tasks, f, indent=2)
    print("Created sample_config.json and sample_tasks.json")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="UniMoE Audio batch inference (PyTorch port)")
    parser.add_argument("--config", "-c", help="Framework config (JSON/YAML)")
    parser.add_argument("--tasks", "-t", help="Tasks file (JSON/YAML)")
    parser.add_argument("--results", "-r", default="results.json")
    parser.add_argument("--create-sample", action="store_true")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = parser.parse_args(argv)

    if args.create_sample:
        create_sample_config()
        return 0
    if not args.config or not args.tasks:
        parser.error("--config and --tasks are required (or --create-sample)")
    config = load_config_from_file(args.config)
    if args.cpu:
        config.device = "cpu"
    fw = InferenceFramework(config)
    if not fw.initialize_model():
        return 1
    fw.execute_batch(load_tasks_from_file(args.tasks))
    fw.save_results(args.results)
    return 0


if __name__ == "__main__":
    sys.exit(main())
