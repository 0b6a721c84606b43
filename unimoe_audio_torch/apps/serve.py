#!/usr/bin/env python3
"""Serving entry of the port — counterpart of `unimoe_audio_tpu/apps/serve.py`:
one model on one card, serving a single request, a file of requests through
the request batcher (`--requests`) or through the continuous slot server
(`--requests --continuous`), and the time-to-first-audio harness
(`--measure-latency`).

    python -m unimoe_audio_torch.apps.serve --model path/to/model --requests reqs.json
    python -m unimoe_audio_torch.apps.serve --allow-random --measure-latency

Runs on the first CUDA card; `--cpu` runs on the CPU.  Expert and tensor
parallel serving (`--ep-size`, `--tp-size` above 1) and the multihost
arguments come with the parallel slice (ROADMAP §1 item 3).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

from unimoe_audio_torch.api import UniMoEAudio


def build_server(model_path: Optional[str], *, ep_size: int = 1, tp_size: int = 1,
                 allow_random: bool = False, quantize=False, tokenizer=None, config=None,
                 max_tokens: int = 1000, min_tokens: int = 100, kv_cache: Optional[str] = None,
                 device=None) -> UniMoEAudio:
    """A model for serving on one card (`serve.py:37-72`): quantize ("int8"
    / "int4" / "int4-gptq", or True for int8) picks the serving mode,
    kv_cache="int8" the int8 KV cache.  device defaults to CUDA."""
    if ep_size * tp_size > 1:
        raise NotImplementedError(
            f"ep_size={ep_size}, tp_size={tp_size}: serving on a device mesh comes with the "
            "parallel slice (ROADMAP §1 item 3); the port serves on one card")
    return UniMoEAudio(
        model_path, allow_random=allow_random, config=config, tokenizer=tokenizer,
        max_tokens=max_tokens, min_tokens=min_tokens, serving_mode=quantize,
        kv_cache_dtype=kv_cache, device=device)


def measure_ttfa(model: UniMoEAudio, *, n_trials: int = 5,
                 text: str = "A peaceful piano melody") -> dict:
    """p50 / p90 time to first audio (`serve.py:75-120`): the prefill plus
    the decode step that emits the first frame (`generate`'s stop_at), the
    device synchronised before the clock starts and before it stops, in the
    model's serving configuration (dispatch, KV cache).  The first of
    n_trials + 1 calls is left out (it builds the kernels and warms the
    allocator).  Nothing is written to disk."""
    import torch

    from unimoe_audio_torch.api import T2M_NEGATIVE_CAPTION, t2m_prompt
    from unimoe_audio_torch.codec import delay as dl
    from unimoe_audio_torch.generate.loop import _sync, generate, pad_buffer

    cfg, dev = model.config, model.device
    ids, mask = model._tokenize([t2m_prompt(T2M_NEGATIVE_CAPTION), t2m_prompt(text)])
    prefill, steps = dl.prepare_audio_prompt(
        [None], num_channels=cfg.codec_channels, bos_value=cfg.codec_bos_value,
        delay_pattern=cfg.codec_delay_pattern)
    mt = max(cfg.max_delay + 2, 24)
    buf = pad_buffer(torch.as_tensor(prefill, device=dev), mt)
    ids_t, mask_t = torch.as_tensor(ids, device=dev), torch.as_tensor(mask, device=dev)
    kw = dict(max_tokens=mt, min_tokens=mt, cfg_scale=10.0, temperature=1.0, top_p=1.0,
              cfg_filter_top_k=45, eos_prob_mul_factor=0.6, do_sample=True,
              kv_dtype=model.kv_cache_dtype, **model.serving_dispatch(*ids.shape))
    lat: List[float] = []
    with torch.inference_mode():
        for i in range(n_trials + 1):
            gen = torch.Generator(device=dev).manual_seed(i)
            _sync(dev)
            t0 = time.perf_counter()
            generate(model.params, cfg, ids_t, mask_t, None, buf, steps, gen,
                     stop_at=int(steps[0]), **kw)
            _sync(dev)
            if i > 0:
                lat.append(time.perf_counter() - t0)
    lat.sort()
    return {"p50_ttfa_s": lat[len(lat) // 2],
            "p90_ttfa_s": lat[min(len(lat) - 1, int(len(lat) * 0.9))],
            "trials": n_trials}


def _serve_continuous(model: UniMoEAudio, reqs: List[dict], args) -> dict:
    """The requests through `model.continuous_server`: each admits into the
    live decode batch as a slot frees up."""
    srv = model.continuous_server(slots=args.slots, chunk_frames=args.chunk_frames,
                                  deterministic=args.deterministic)
    outs, errs = [None] * len(reqs), []
    for i, r in enumerate(reqs):
        task = r.pop("task", "text_to_music")
        try:
            kw = dict(caption=r.get("caption") or r.get("text") or r.get("input_text"),
                      seed=int(r.get("seed", i)), rid=i)
            for k in ("prompt_text", "prompt_wav", "prompt_codec", "video", "max_audio_seconds",
                      "min_audio_seconds", "cfg_scale", "temperature", "top_p"):
                if r.get(k) is not None:
                    kw[k] = r[k]
            srv.submit(model.make_slot_request(task, **kw))
        except (ValueError, KeyError, TypeError) as e:   # a bad request fails alone
            errs.append({"index": i, "error": str(e)})
    for res in srv.run_until_drained():
        outs[res.rid] = model.decode_slot_results([res], output_dir=args.output)[0]
    return {"outputs": outs, "errors": errs}


def _serve_batched(model: UniMoEAudio, reqs: List[dict], args) -> dict:
    """The requests through the request batcher: every task coalesces into
    one generation batch."""
    from unimoe_audio_torch.apps.batcher import REQUEST_ERRORS, RequestBatcher

    batcher = RequestBatcher(model, output_dir=args.output)
    futs = [batcher.submit(r.pop("task"), r) for r in reqs]
    outs, errs = [], []
    try:
        for i, fut in enumerate(futs):
            try:
                outs.append(fut.result(timeout=3600))
            except REQUEST_ERRORS as e:                                   # fails alone
                outs.append(None)
                errs.append({"index": i, "error": str(e)})
    finally:
        batcher.close()
    return {"outputs": outs, "errors": errs}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="UniMoE-Audio serving (PyTorch port)")
    parser.add_argument("--model", default=None)
    parser.add_argument("--ep-size", type=int, default=1)
    parser.add_argument("--tp-size", type=int, default=1)
    parser.add_argument("--quantize", nargs="?", const="int8", default=False,
                        choices=["int8", "int4", "int4-gptq"],
                        help="quantized serving (a bare flag is int8)")
    parser.add_argument("--kv-cache", default=None, choices=["int8"],
                        help="int8 KV cache with per-position scales")
    parser.add_argument("--allow-random", action="store_true")
    parser.add_argument("--task", default="text_to_music",
                        choices=["text_to_music", "text_to_speech", "video_text_to_music"])
    parser.add_argument("--input", default="A peaceful piano melody",
                        help="caption (T2M / VT2M) or target text (TTS)")
    parser.add_argument("--prompt-text", default=None, help="TTS: the voice prompt's transcript")
    parser.add_argument("--prompt-wav", default=None, help="TTS: the voice prompt's wav")
    parser.add_argument("--video", default=None, help="VT2M: video path")
    parser.add_argument("--requests", default=None,
                        help="JSON file with a list of {task, ...} requests, served together "
                             "through the request batcher")
    parser.add_argument("--continuous", action="store_true",
                        help="serve --requests through the continuous slot server")
    parser.add_argument("--slots", type=int, default=4, help="(--continuous) request slots")
    parser.add_argument("--chunk-frames", type=int, default=64,
                        help="(--continuous) decode frames between admissions")
    parser.add_argument("--deterministic", action="store_true",
                        help="(--continuous) dense, dropless dispatch at any width")
    parser.add_argument("--save-snapshot", default=None, metavar="DIR",
                        help="after quantization, save the serving params to DIR")
    parser.add_argument("--output", default="./served")
    parser.add_argument("--measure-latency", action="store_true")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = parser.parse_args(argv)

    model = build_server(args.model, ep_size=args.ep_size, tp_size=args.tp_size,
                         allow_random=args.allow_random, quantize=args.quantize,
                         kv_cache=args.kv_cache, device="cpu" if args.cpu else None)
    if args.save_snapshot:
        print(f"serving snapshot: {model.save_serving_snapshot(args.save_snapshot)}")
    if args.measure_latency:
        print(json.dumps(measure_ttfa(model)))
        return 0
    if args.requests:
        with open(args.requests) as f:
            reqs = json.load(f)
        out = (_serve_continuous if args.continuous else _serve_batched)(model, reqs, args)
        print(json.dumps(out))
        return 1 if out["errors"] and not any(out["outputs"]) else 0
    if args.task == "text_to_music":
        out = model.text_to_music(args.input, output_dir=args.output)
    elif args.task == "text_to_speech":
        if not args.prompt_text or not args.prompt_wav:
            raise SystemExit("text_to_speech needs --prompt-text and --prompt-wav")
        out = model.text_to_speech(args.input, prompt_text=args.prompt_text,
                                   prompt_wav=args.prompt_wav, output_dir=args.output)
    else:
        if not args.video:
            raise SystemExit("video_text_to_music needs --video")
        out = model.video_text_to_music(args.video, args.input, output_dir=args.output)
    print(json.dumps({"outputs": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
